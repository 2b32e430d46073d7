"""Finding a cell's files by name: `workloads/<cell>.json` names the
configuration (`configs/<config>.json`) and the traffic mix
(`traffic/<traffic>.json`); a configuration names its model family, whose
plain reference is `reference/<family>.py` and whose operation count is
`counts/<family>.py`.  A per-layer metric's reader is
`metrics/<metric>.py`.  A later cell, configuration or metric is a set of
new files; nothing here changes for it."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Union

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")

TRAFFIC_KEYS = {
    "grid", "holes", "noise_mv", "pace_ops", "events", "trains",
    "start_steps", "event_checks", "pre_window_ms", "warmup_ms",
    "end_steps", "end_at_train_event", "trace_ms",
}


class SpecError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    chips: int
    limits: Dict[str, Union[float, List[float]]]

    @property
    def family(self) -> str:
        return self.config["family"]


def _name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise SpecError(f"bad {kind} name {name!r}")
    return name


def _read(path: Path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise SpecError(f"no file {path}") from None


def check_traffic(t: dict) -> dict:
    missing, extra = TRAFFIC_KEYS - set(t), set(t) - TRAFFIC_KEYS
    if missing or extra:
        raise SpecError(f"traffic keys: missing {sorted(missing)}, "
                        f"unknown {sorted(extra)}")
    h, w = t["grid"]
    if h < 32 or w < 32:
        raise SpecError("grid under 32 cells a side")
    ops = set(t["pace_ops"])
    for e in t["events"] + t["trains"] + t["event_checks"]:
        if e["op"] not in ops:
            raise SpecError(f"event of unknown pacing op {e['op']!r}")
    if t["end_at_train_event"] and not t["trains"]:
        raise SpecError("end_at_train_event needs a train")
    if t["warmup_ms"] > t["pre_window_ms"]:
        raise SpecError("the warm-up is part of the pre-window stretch")
    return t


def _limit(name: str, v):
    """A number (at most) or a band [lo, hi] (the window's ranges)."""
    if isinstance(v, list):
        if len(v) != 2 or not float(v[0]) <= float(v[1]):
            raise SpecError(f"limit {name}: a band is [lo, hi]")
        return [float(v[0]), float(v[1])]
    return float(v)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    w = _read(root / "workloads" / f"{_name('cell', name)}.json")
    if int(w["chips"]) != 1:
        # the program driver builds no mesh: a cell on four cards needs a
        # harness that does, not a new file
        raise SpecError(f"cell {name}: the harness drives one card")
    cfg_name = _name("config", w["config"])
    traffic_name = _name("traffic", w["traffic"])
    cfg = _read(root / "configs" / f"{cfg_name}.json")
    _name("family", cfg["family"])
    traffic = check_traffic(_read(root / "traffic" / f"{traffic_name}.json"))
    return Cell(name, cfg_name, traffic_name, cfg, traffic, int(w["chips"]),
                {k: _limit(k, v) for k, v in w["limits"].items()})


def family_module(kind: str, family: str):
    """`reference.<family>` or `counts.<family>`."""
    return importlib.import_module(f"{kind}.{_name('family', family)}")


def metric_readers(root: Path = ROOT) -> Dict[str, object]:
    """Every reader under metrics/, keyed by its metric's name (the file
    name without `.py`); each has `UNIT` and `read(ctx)`."""
    readers = {}
    for path in sorted((root / "metrics").glob("*.py")):
        name = _name("metric", path.name[:-3])
        spec = importlib.util.spec_from_file_location(
            f"metric_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        readers[name] = mod
    return readers


def peaks(device_name: str, root: Path = ROOT) -> Optional[dict]:
    """The table's peaks of a card, or None for a card it lacks."""
    return _read(root / "peaks.json")["devices"].get(device_name)

"""The timed window's own outputs, held to what its traffic makes of them.

The reference cannot follow the window (court at 2048x2048: ~42 ms a plain
outer step against ~2 ms), and the continuation after it starts from the
window's final state, so these numbers read what the window itself
returned:

- `window.steps`: the outer steps the window reports, and the samples of
  each probe stream, against the steps it was asked for (exact);
- `window.last_probe`: the widest gap between the last sample of each
  probe stream and the reference's probes of the final state the window
  returned (as `compare.stage_gap` measures a probe): the state is the one
  the streams ended at;
- `window.cycle_ms`: [the shortest time between two upward crossings of
  0.5 by the "v" probe, the longest stretch of the window without one], in
  ms; the stretches before the first and after the last crossing count
  toward the longest only, and with no two crossings the shortest is the
  longest;
- `window.pace_delay_ms` (traffic with trains of events): [shortest,
  longest] time from each of the trains' events in the window to the next
  crossing; an event with none before the window's end counts toward the
  longest only, with the time to the end.  A window that holds none of
  the trains' events (only a test's short one does) has nothing to read
  here, and the check is not made.

The reference's "v" probe of the window's input state comes before the
stream, so a crossing at the window's first outer step counts.  A band
[lo, hi] holds where lo <= shortest and longest <= hi.
"""

from __future__ import annotations

from typing import List, Mapping, Tuple

import numpy as np
import torch

from harness.compare import widest
from reference.common import to_tensors

THRESHOLD = 0.5


def names(traffic: dict) -> List[str]:
    """The window's checks for a traffic mix."""
    return (["window.steps", "window.last_probe", "window.cycle_ms"]
            + (["window.pace_delay_ms"] if traffic["trains"] else []))


def passes(value, limit) -> bool:
    """A number holds at most its limit; a [shortest, longest] pair holds
    inside its band [lo, hi]."""
    if isinstance(limit, (list, tuple)):
        return (value is not None and limit[0] <= value[0]
                and value[1] <= limit[1])
    return value is not None and value <= limit


def _probes(ref_module, cell, phase, state: Mapping, device):
    h, w = cell.traffic["grid"]
    model = ref_module.Model(cell.config["sim"], h, w, phase, device,
                             torch.float32)
    with torch.no_grad():
        return model.probes(to_tensors(state, device))


def crossings(v_in: float, v: np.ndarray, step_ms: float) -> List[float]:
    """Times (ms from the window's start) of the upward crossings of
    THRESHOLD: sample i of the stream is taken after outer step i + 1."""
    s = np.concatenate([[v_in], np.asarray(v, dtype=np.float64)])
    up = np.nonzero((s[:-1] < THRESHOLD) & (s[1:] >= THRESHOLD))[0] + 1
    return [float(i) * step_ms for i in up]


def cycle_band(times: List[float], window_ms: float) -> List[float]:
    if not times:
        return [window_ms, window_ms]
    cycles = np.diff(times).tolist()
    longest = max(cycles + [times[0], window_ms - times[-1]])
    return [min(cycles) if cycles else longest, longest]


def pace_delays(times: List[float], events: List[Tuple[int, str]],
                train_ops, step_ms: float, window_ms: float):
    arrived, open_ = [], []
    for k, op in events:
        if op not in train_ops:
            continue
        t = k * step_ms
        later = [c for c in times if c > t]
        (arrived if later else open_).append(
            later[0] - t if later else window_ms - t)
    if not arrived and not open_:
        return None
    longest = max(arrived + open_)
    return [min(arrived) if arrived else longest, longest]


def checks(cell, ref_module, phase, step_ms: float, n_steps: int,
           events: List[Tuple[int, str]], state_in: Mapping, res,
           device) -> List[Tuple[str, object, str]]:
    """(name, value, what it read) for each of the window's checks; `res`
    is the window's SimResult, `state_in` the state it started from."""
    out = []
    lengths = {k: len(v) for k, v in res.probes.items()}
    off = max([abs(int(res.steps) - n_steps)]
              + [abs(n - n_steps) for n in lengths.values()])
    out.append(("window.steps", off,
                f"{res.steps} steps, streams {lengths}, asked {n_steps}"))

    ref = _probes(ref_module, cell, phase, res.state, device)
    gaps = []
    for name, r in ref.items():
        if name not in res.probes or not len(res.probes[name]):
            gaps.append((float("inf"), f"probe {name} missing"))
            continue
        p = torch.as_tensor(np.asarray(res.probes[name][-1])).reshape(-1)
        r = r.reshape(-1)
        for j in range(r.numel()):
            gaps.append((widest(p[j:j + 1].to(r.device), r[j:j + 1],
                                name != "v"), f"probe {name}[{j}]"))
    gap, where = max(gaps, key=lambda g: np.nan_to_num(g[0], nan=np.inf))
    out.append(("window.last_probe", gap, where))

    v_in = float(_probes(ref_module, cell, phase, state_in, device)["v"])
    window_ms = n_steps * step_ms
    times = crossings(v_in, res.probes.get("v", []), step_ms)
    out.append(("window.cycle_ms", cycle_band(times, window_ms),
                f"{len(times)} crossings at {times[:6]}..."))
    if cell.traffic["trains"]:
        ops = {tr["op"] for tr in cell.traffic["trains"]}
        delays = pace_delays(times, events, ops, step_ms, window_ms)
        if delays is not None:
            out.append(("window.pace_delay_ms", delays,
                        f"{sum(op in ops for _, op in events)} "
                        f"train events"))
    return out

"""The one generator of every traffic mix: from a traffic file's numbers
(grid, holes, pacing sites, single events and trains of events, the
stretch before the window and the checked stretches) and the seed, the
initial state and the run's stages in outer steps.

Times in a traffic file are in ms from the start of the run.  An event at
t fires after outer step int(t / step_ms) + 1, where the engine fires it
(after the step that contains t).  The run is cut into stages; a stage is
one call of the entry, and a stage holds the events e with
start < e <= end.  The seed changes the initial state only (N(0,
noise_mv) mV on V per cell), never the sizes or the events.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from reference.common import phase_field


@dataclasses.dataclass(frozen=True)
class Stage:
    name: str
    start: int                 # outer steps from the start of the run
    end: int
    checked: bool = False

    @property
    def steps(self) -> int:
        return self.end - self.start


def event_step(t_ms: float, step_ms: float) -> int:
    return int(t_ms / step_ms) + 1


def events_until(traffic: dict, step_ms: float,
                 last: int) -> Dict[int, List[str]]:
    """{outer step: [pacing ops that fire after it]} up to step `last`."""
    out: Dict[int, List[str]] = {}
    for e in traffic["events"]:
        k = event_step(e["at_ms"], step_ms)
        if k <= last:
            out.setdefault(k, []).append(e["op"])
    for tr in traffic["trains"]:
        t = tr["first_ms"]
        while event_step(t, step_ms) <= last:
            out.setdefault(event_step(t, step_ms), []).append(tr["op"])
            t += tr["period_ms"]
    return {k: out[k] for k in sorted(out)}


def in_stage(events: Dict[int, List[str]], stage: Stage
             ) -> List[Tuple[int, str]]:
    """The stage's events as (steps from its start, op)."""
    return [(k - stage.start, op) for k, ops in events.items()
            if stage.start < k <= stage.end for op in ops]


def pre_window(traffic: dict, step_ms: float) -> List[Stage]:
    """The stages before the window: the checked start from the seed's
    state, each checked event with the steps around it, the unchecked
    stretches between, and the warm-up that the window is sized from."""
    window_at = int(round(traffic["pre_window_ms"] / step_ms))
    warm_at = window_at - int(round(traffic["warmup_ms"] / step_ms))
    k0 = traffic["start_steps"]
    stages = [Stage("start", 0, k0, checked=True)]
    evs = events_until(traffic, step_ms, warm_at)
    for chk in traffic["event_checks"]:
        first = min((k for k, ops in evs.items()
                     if chk["op"] in ops and k > stages[-1].end), default=None)
        if first is None:
            raise ValueError(f"no {chk['op']!r} event before the warm-up")
        lo, hi = first - chk["before_steps"], first + chk["after_steps"]
        if lo < stages[-1].end or hi > warm_at:
            raise ValueError(f"the {chk['op']!r} check overlaps a stage")
        stages.append(Stage("pre", stages[-1].end, lo))
        stages.append(Stage(f"event.{chk['op']}", lo, hi, checked=True))
    warm_at = max(warm_at, stages[-1].end)
    stages.append(Stage("pre", stages[-1].end, warm_at))
    stages.append(Stage("warmup", warm_at, window_at))
    return [s for s in stages if s.steps > 0]


def window_and_end(traffic: dict, step_ms: float, start: int,
                   target_steps: int) -> Tuple[Stage, Stage]:
    """The window from `start`, about `target_steps` long, and the checked
    continuation after it.  With `end_at_train_event` the window ends
    half the continuation before a train's event, so that the continuation
    fires it."""
    k_end = traffic["end_steps"]
    n = max(1, target_steps)
    if traffic["end_at_train_event"]:
        half = k_end // 2
        period = max(int(tr["period_ms"] / step_ms) for tr in
                     traffic["trains"])
        horizon = start + n + half + period + 1
        evs = [k for k, ops in events_until(traffic, step_ms, horizon).items()
               if k - half - start >= 1 and any(
                   op == tr["op"] for tr in traffic["trains"] for op in ops)]
        k = min(evs, key=lambda k: abs(k - half - start - n))
        n = k - half - start
    # no event after the window's last step, so that its final state is
    # the one its last probe sample read
    busy = events_until(traffic, step_ms, start + n + 1)
    while n > 1 and start + n in busy:
        n -= 1
    window = Stage("window", start, start + n)
    return window, Stage("end", window.end, window.end + k_end, checked=True)


def initial_state(ref_module, traffic: dict, seed: int,
                  device) -> Dict[str, np.ndarray]:
    """The family's resting planes with its S1 stripe, V raised per cell
    by N(0, noise_mv) mV drawn on `device` from `seed`, as host float32."""
    h, w = traffic["grid"]
    st = ref_module.initial_state(h, w)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    noise = torch.randn((h, w), generator=gen, device=device,
                        dtype=torch.float32) * float(traffic["noise_mv"])
    st["V"] = (torch.as_tensor(st["V"], device=device) + noise).cpu().numpy()
    return st


def geometry(traffic: dict) -> Optional[np.ndarray]:
    h, w = traffic["grid"]
    return phase_field(h, w, traffic["holes"])


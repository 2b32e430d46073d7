"""Host-side consumers of on-device probe streams.

A copy of fib_tf_tpu.engine.observers.CycleLengthDetector: that module is
numpy-only, but importing it runs fib_tf_tpu/engine/__init__.py, which
imports the JAX engine.  tests/test_torch_engine.py pins the copy to the
original.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np


class CycleLengthDetector:
    """Wavefront-passage detector: watches the normalized potential at the
    observer pixel at plot-interval sampling; on an upward crossing of 0.5
    reports the cycle length in ms via `observer(step, cl)` (or print, like
    the reference default)."""

    def __init__(
        self,
        dt: float,
        dt_per_step: int,
        plot_interval: int,
        observer: Optional[Callable[[int, float], None]] = None,
    ):
        self.dt = dt
        self.dt_per_step = dt_per_step
        self.plot_interval = plot_interval
        self.observer = observer
        self.last_spike = 0
        self.v_prev = -np.inf  # the reference seeds with raw min_v, < 0.5
        self.cycle_lengths: List[tuple] = []

    def feed(self, start_step: int, probe_series: np.ndarray):
        """Consume per-outer-step probe values for steps
        [start_step, start_step + len(probe_series))."""
        for k, v1 in enumerate(probe_series):
            i = start_step + k
            if i % self.plot_interval != 0:
                continue
            if v1 >= 0.5 and self.v_prev < 0.5:
                cl = (i - self.last_spike) * self.dt_per_step * self.dt
                self.cycle_lengths.append((i, cl))
                if self.observer is None:
                    print(
                        "wavefront reaches the middle top point at %d, "
                        "cycle length is %d" % (i, cl)
                    )
                else:
                    self.observer(i, cl)
                self.last_spike = i
            self.v_prev = v1

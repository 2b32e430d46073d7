"""The port's run loops: the chunked 2D simulate(), the 3D run_volume()
and their observers."""

from fib_tf_tpu_torch.engine.observers import CycleLengthDetector
from fib_tf_tpu_torch.engine.simulation import SimResult, Simulation
from fib_tf_tpu_torch.engine.volume import (
    VolumeEvent,
    run_volume,
    volume_state,
)

__all__ = ["CycleLengthDetector", "SimResult", "Simulation", "VolumeEvent",
           "run_volume", "volume_state"]

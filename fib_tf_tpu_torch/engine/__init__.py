"""The port's run loop: chunked simulate() and its observers."""

from fib_tf_tpu_torch.engine.observers import CycleLengthDetector
from fib_tf_tpu_torch.engine.simulation import SimResult, Simulation

__all__ = ["CycleLengthDetector", "SimResult", "Simulation"]

"""The port's model zoo (Beeler-Reuter first)."""

from fib_tf_tpu_torch.models.base import (
    Geometry,
    IonicModel,
    cell_geometry,
    grid_geometry,
    volume_geometry,
)
from fib_tf_tpu_torch.models.beeler_reuter import BeelerReuter

__all__ = [
    "BeelerReuter",
    "Geometry",
    "IonicModel",
    "cell_geometry",
    "grid_geometry",
    "volume_geometry",
]

"""The port's model zoo: Beeler-Reuter, Fenton, Mitchell-Schaeffer,
Courtemanche and Courtemanche-ultra."""

from fib_tf_tpu_torch.models.base import (
    Geometry,
    IonicModel,
    cell_geometry,
    grid_geometry,
    volume_geometry,
)
from fib_tf_tpu_torch.models.beeler_reuter import BeelerReuter
from fib_tf_tpu_torch.models.courtemanche import (Courtemanche,
                                                  CourtemancheUltra)
from fib_tf_tpu_torch.models.fenton import Fenton4v
from fib_tf_tpu_torch.models.mitchell_schaeffer import MitchellSchaeffer

# the reference's registry names (fib_tf_tpu/models/__init__.py) of the
# families ported so far
MODEL_REGISTRY = {
    "fenton": Fenton4v,
    "br": BeelerReuter,
    "beeler_reuter": BeelerReuter,
    "ms": MitchellSchaeffer,
    "mitchell_schaeffer": MitchellSchaeffer,
    "court": Courtemanche,
    "courtemanche": Courtemanche,
    "court_ultra": CourtemancheUltra,
}

__all__ = [
    "BeelerReuter",
    "Courtemanche",
    "CourtemancheUltra",
    "Fenton4v",
    "Geometry",
    "IonicModel",
    "MODEL_REGISTRY",
    "MitchellSchaeffer",
    "cell_geometry",
    "grid_geometry",
    "volume_geometry",
]

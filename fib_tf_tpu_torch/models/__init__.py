"""The port's model zoo: Beeler-Reuter, Fenton, Mitchell-Schaeffer,
Courtemanche, Courtemanche-ultra, Luo-Rudy 1991 and ten Tusscher-Panfilov
2006."""

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
from fib_tf_tpu_torch.models.luo_rudy import LuoRudy91
from fib_tf_tpu_torch.models.mitchell_schaeffer import MitchellSchaeffer
from fib_tf_tpu_torch.models.tp06 import TenTusscher06

# the reference's registry names (fib_tf_tpu/models/__init__.py)
MODEL_REGISTRY = {
    "fenton": Fenton4v,
    "br": BeelerReuter,
    "beeler_reuter": BeelerReuter,
    "ms": MitchellSchaeffer,
    "mitchell_schaeffer": MitchellSchaeffer,
    "court": Courtemanche,
    "courtemanche": Courtemanche,
    "court_ultra": CourtemancheUltra,
    "lr1": LuoRudy91,
    "luo_rudy": LuoRudy91,
    "tp06": TenTusscher06,
    "tentusscher": TenTusscher06,
}

__all__ = [
    "BeelerReuter",
    "Courtemanche",
    "CourtemancheUltra",
    "Fenton4v",
    "Geometry",
    "IonicModel",
    "LuoRudy91",
    "MODEL_REGISTRY",
    "MitchellSchaeffer",
    "TenTusscher06",
    "cell_geometry",
    "grid_geometry",
    "volume_geometry",
]

"""fib_tf_tpu_torch — the PyTorch + CUDA port of fib_tf_tpu.

The JAX package `fib_tf_tpu/` is the reference; this package carries the
same simulation to PyTorch on an NVIDIA GPU.  Its first slice is the main
path that `bench.py` measures: Beeler-Reuter with `cheby` + `skip` (and
the default `cheby_fold` + `cheby_currents`), driven by
`Simulation(BeelerReuter(cfg)).define().simulate()`.  On a CUDA device each
substep runs the hand-written kernel in `csrc/br_substep.cu`; on the CPU
the plain PyTorch path runs.

The package imports `torch` and never `jax`.  From the JAX package it
imports only `fib_tf_tpu.config`, so both packages read the same
`SimConfig`.

Layering (mirrors fib_tf_tpu):
  csrc/ + kernels/   CUDA C++ sources and the nvcc/ctypes builder
  ops/               stencil, Chebyshev, integrators, the kernel wrapper
  models/            Geometry, IonicModel, BeelerReuter
  engine/            the chunked Simulation driver and its observers
  interop.py         numpy <-> torch state and parameter hand-over
"""

__version__ = "0.1.0"

from fib_tf_tpu.config import SimConfig

__all__ = ["SimConfig", "__version__"]

"""fib_tf_tpu_torch — the PyTorch + CUDA port of fib_tf_tpu.

The JAX package `fib_tf_tpu/` is the reference; this package carries the
same simulation to PyTorch on an NVIDIA GPU.  Its slices so far:

- the 2D main path that `bench.py` measures: Beeler-Reuter with `cheby` +
  `skip` (and the default `cheby_fold` + `cheby_currents`), driven by
  `Simulation(BeelerReuter(cfg)).define().simulate()`, with the substep
  kernel `csrc/br_substep.cu` and, past the 32 MB cutover, the tiled
  kernel `csrc/br_tiled.cu`;
- the 3D volume path `run_volume(model, depth, n_outer)`, with the
  volume substep kernel `csrc/br_volume.cu` and, past the 32 MB cutover,
  the tiled volume kernel `csrc/br_volume_tiled.cu`;
- the sharded wide-halo paths, `Simulation(model, mesh=..., wide_halo=True)`
  and `run_volume(..., mesh=..., wide_halo=True)`: one process drives a
  mesh of devices (`parallel.make_mesh`), the shards exchange K ghost rows
  or slices per outer step, and each shard runs the block kernel
  `csrc/br_block.cu` or `csrc/br_volume_block.cu`.

The entry points run on the card unless the caller passes
`device='cpu'` (or a mesh of CPU entries), where the plain PyTorch path
runs.

The package imports `torch` and never `jax`, and nothing of the JAX
package: `SimConfig` is its own copy (config.py), pinned equal to the
reference by tests/test_torch_config.py.

Layering (mirrors fib_tf_tpu):
  csrc/ + kernels/   CUDA C++ sources and the nvcc/ctypes builder
  ops/               stencils (2D, 3D), Chebyshev, integrators, the kernel
                     wrappers
  models/            Geometry, IonicModel, BeelerReuter
  parallel/          the device mesh, the sharded state and the halo
                     exchange of the sharded paths
  engine/            the chunked Simulation engine, run_volume and the
                     observers
  interop.py         numpy <-> torch state and parameter hand-over
"""

__version__ = "0.1.0"

from fib_tf_tpu_torch.config import SimConfig

__all__ = ["SimConfig", "__version__"]

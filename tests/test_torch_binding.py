"""The port's one kernel binding (fib_tf_tpu_torch/kernels/binding.py) on
the CPU: each of the seven binding classes driven through a stub library
in place of its CUDA one.  A launch calls its entry once with as many
arguments as the binding declares, counts itself in the right slot and
records one `fibtorch.launch.<entry>` span; a failed launch raises naming
its entry and counts nothing; and loading a library declares the entry's
arguments and runs the layout checks, which refuse a library of another
layout.  tests/test_torch_cuda.py holds the same bindings to the card."""

import ctypes
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fib_tf_tpu_torch import SimConfig
from fib_tf_tpu_torch.kernels import binding, build
from fib_tf_tpu_torch.models import BeelerReuter, LuoRudy91
from fib_tf_tpu_torch.ops import (bodies, cuda_block, cuda_step, cuda_tiled,
                                  cuda_volume, cuda_volume_block,
                                  cuda_volume_tiled)
from test_torch_fixtures import one_torch_thread  # noqa: F401

H = W = 8
D = 4
SCHEDULE = (True, False, False, False, False)
GEOMETRY = bodies.kernel_geometry_args(None, None, None)


def _planes(body, shape):
    pot = body.model.pot_key
    return {k: torch.zeros(shape) for k in (pot,) + body.planes
            if not k.startswith("_p_")}


def _substep(geom):
    kernel = cuda_step.SubstepKernel("br", geom=geom)
    state = _planes(kernel.body, (H, W))

    def launch():
        kernel.launch(np.zeros(bodies.PARAM_FLOATS, np.float32), state,
                      not geom, None, (1, 1), 0, 0, GEOMETRY if geom else ())
    return kernel, launch, "frozen" if geom else "slow"


def _tiled(geom):
    kernel = cuda_tiled.TiledKernel("br", geom=geom)
    state = _planes(kernel.body, (H, W))

    def launch():
        kernel.launch(np.zeros(bodies.PARAM_FLOATS, np.float32), state,
                      SCHEDULE, None, (1, 1), 0, 0, GEOMETRY if geom else ())
    return kernel, launch, None


def _block(geom):
    kernel = cuda_block.BlockKernel("br", geom=geom)
    ext_in = _planes(kernel.body, (H + 10, W))
    ext_out = _planes(kernel.body, (H + 10, W))

    def launch():
        kernel.launch(np.zeros(bodies.PARAM_FLOATS, np.float32), ext_in,
                      ext_out, -5, 0, 5, False, H, W, SCHEDULE, None, (1, 1),
                      0, 0, GEOMETRY if geom else ())
    return kernel, launch, None


def _large_block(geom):
    kernel = cuda_block.LargeBlockKernel("lr1", geom=geom)
    planes = _planes(kernel.body, (H + 20, W))

    def launch():
        kernel.launch(np.zeros(kernel.body.param_floats, np.float32), True,
                      planes["V"], torch.empty_like(planes["V"]), planes,
                      planes, -10, 0, 10, False, H, W, 0, True, None, (1, 1),
                      0, 0, GEOMETRY if geom else ())
    return kernel, launch, "slow"


def _volume(_):
    kernel = cuda_volume.VolumeKernel("br")
    state = _planes(kernel.body, (D, H, W))

    def launch():
        kernel.launch(np.zeros(bodies.PARAM_FLOATS, np.float32), state,
                      False, 1.0, None, (1, 1, 1), 0, 0)
    return kernel, launch, "frozen"


def _volume_block(_):
    kernel = cuda_volume_block.VolumeBlockKernel("br")
    state = _planes(kernel.body, (D + 2, H, W))

    def launch():
        kernel.launch(np.zeros(bodies.PARAM_FLOATS, np.float32), state,
                      torch.empty_like(state["V"]), True, 1.0, -1, D, 1,
                      D + 1, None, (1, 1, 1), 0, 0)
    return kernel, launch, "slow"


def _volume_tiled(_):
    kernel = cuda_volume_tiled.VolumeTiledKernel()
    state = _planes(kernel.body, (D, H, W))

    def launch():
        kernel.launch(np.zeros(bodies.PARAM_FLOATS, np.float32), state,
                      SCHEDULE, 1.0, None, (1, 1, 1), 0, 0)
    return kernel, launch, None


# (binding class, geom) -> a fresh binding, its launch and its counter slot
# (None: the per-outer-step bindings count one int)
CASES = {
    "substep": (_substep, False), "substep_geom": (_substep, True),
    "tiled": (_tiled, False), "tiled_geom": (_tiled, True),
    "block": (_block, False), "block_geom": (_block, True),
    "large_block": (_large_block, False),
    "large_block_geom": (_large_block, True),
    "volume": (_volume, False), "volume_block": (_volume_block, False),
    "volume_tiled": (_volume_tiled, False),
}


def _stubbed(monkeypatch, case, err=0):
    make, geom = CASES[case]
    kernel, launch, slot = make(geom)
    calls = []

    def entry(*args):
        calls.append(args)
        return err

    monkeypatch.setattr(kernel, "library",
                        lambda: types.SimpleNamespace(**{kernel.entry: entry}))
    return kernel, launch, slot, calls


def _counted(kernel, slot):
    return kernel.launches if slot is None else kernel.launches[slot]


def test_the_cases_cover_every_binding_class():
    classes = {type(CASES[c][0](CASES[c][1])[0]) for c in CASES}
    assert classes == {cuda_step.SubstepKernel, cuda_tiled.TiledKernel,
                       cuda_block.BlockKernel, cuda_block.LargeBlockKernel,
                       cuda_volume.VolumeKernel,
                       cuda_volume_block.VolumeBlockKernel,
                       cuda_volume_tiled.VolumeTiledKernel}
    assert all(issubclass(c, binding.Binding) for c in classes)


@pytest.mark.parametrize("case", CASES)
def test_a_launch_calls_its_entry_once_counts_and_spans(monkeypatch, case):
    kernel, launch, slot, calls = _stubbed(monkeypatch, case)
    before = _counted(kernel, slot)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        launch()
    assert len(calls) == 1
    assert len(calls[0]) == len(kernel.argtypes)
    assert _counted(kernel, slot) == before + 1
    if slot is not None:
        other = "frozen" if slot == "slow" else "slow"
        assert kernel.launches[other] == 0
    spans = [e for e in prof.profiler.kineto_results.events()
             if e.name().startswith("fibtorch.")]
    assert [e.name() for e in spans] == [f"fibtorch.launch.{kernel.entry}"]
    assert kernel.span_name == spans[0].name()


@pytest.mark.parametrize("case", CASES)
def test_a_failed_launch_raises_and_counts_nothing(monkeypatch, case):
    kernel, launch, slot, calls = _stubbed(monkeypatch, case, err=700)
    before = _counted(kernel, slot)
    with pytest.raises(RuntimeError,
                       match=f"^{kernel.entry} launch failed with CUDA "
                             f"error 700 "):
        launch()
    assert len(calls) == 1
    assert _counted(kernel, slot) == before
    if isinstance(kernel, cuda_step.SubstepKernel):
        assert kernel.cached_launches == 0


class _Fn:
    """A C function of the fake library: answers the layout queries as the
    CUDA source would, and records the declared argument types."""

    def __init__(self, lib, name):
        self.lib, self.name = lib, name
        self.argtypes = self.restype = None

    def __call__(self, *args):
        lib, name = self.lib, self.name
        if name.endswith("_param_floats"):
            return lib.body.param_floats + lib.off
        if name.endswith("_cache_planes"):
            return len(lib.body.cache)
        if name.endswith("_planes"):
            return len(lib.body.planes)
        out = [a._obj for a in args if isinstance(a, type(ctypes.byref(
            ctypes.c_int())))]
        if name.endswith("_tile_shape"):
            values = cuda_tiled.tile_of(lib.body.name, lib.geom)
        elif name == "br_tiled_split":
            n = len(cuda_tiled.tile_spans(*args[:2]))
            values = (n, *divmod(args[0], n))
        elif name == "br_volume_tiled_layout":
            t = cuda_volume_tiled
            values = (t.TILE[1], t.TILE[0], t.THREADS, t.MAX_SUB,
                      t.V_IN_SLOTS, t.V_SLOTS, t.PLANE_SLOTS, t.smem_bytes())
        elif name == "br_volume_tiled_rows":
            rows = cuda_volume_tiled.balanced_rows(*args[:4])
            values = (len(rows), *divmod(args[0], len(rows)))
        else:
            return 0
        for o, v in zip(out, values):
            o.value = v
        return None


class _Lib:
    def __init__(self, kernel, off):
        self.body, self.geom, self.off = kernel.body, kernel.geom, off
        self.fns = {}

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return self.fns.setdefault(name, _Fn(self, name))


@pytest.mark.parametrize("case", CASES)
def test_loading_declares_the_entry_and_checks_the_layout(monkeypatch,
                                                          case):
    make, geom = CASES[case]
    loads = []

    def load(name, sources, defines=(), flags=()):
        loads.append((name, tuple(sources), defines, flags))
        return _Lib(kernel, off)

    monkeypatch.setattr(build, "load", load)
    for off in (1, 0):
        kernel = make(geom)[0]
        if off:
            with pytest.raises(RuntimeError, match="param floats, planes"):
                kernel.library()
            continue
        lib = kernel.library()
        assert kernel.library() is lib
    assert loads == [(kernel.library_name, (kernel.source,), kernel.defines,
                      kernel.flags)] * 2
    fn = lib.fns[kernel.entry]
    assert fn.argtypes == kernel.argtypes and fn.restype is ctypes.c_int
    assert (fn.argtypes[-len(binding.GEOMETRY_ARGTYPES):]
            == binding.GEOMETRY_ARGTYPES) == geom


def test_the_declared_arguments_name_the_entries_c_parameters():
    """A GEOM entry takes its isotropic form's arguments and then the
    geometry's; a volume entry's probe pixel has a slice."""
    for module in (cuda_step, cuda_tiled, cuda_block):
        for body, kernel in module.GEOM_KERNELS.items():
            iso = module.KERNELS[body]
            assert kernel.arguments == iso.arguments + binding.arguments(
                binding.GEOMETRY)
    assert [n for n, _ in cuda_volume.KERNEL.arguments[-7:]] == [
        "probe", "probe_z", "probe_row", "probe_col", "probe_index",
        "device", "stream"]
    with pytest.raises(KeyError):
        binding.arguments("x:z")


def test_the_bindings_lose_no_attribute_their_callers_read():
    models = (BeelerReuter(SimConfig(width=H, height=W, dt=0.1)),
              LuoRudy91(SimConfig(width=H, height=W, dt=0.02)))
    for model in models:
        body = bodies.cell_body(model)
        kernel = cuda_step.KERNELS[body.name]
        assert kernel.body is body and kernel.library_name == (
            body.library.name("substep"))
    tiled = cuda_volume_tiled.KERNEL
    assert (tiled.entry, tiled.library_name, tiled.defines, tiled.geom) == (
        "br_volume_tiled", "br_volume_tiled", (), False)
    assert tiled.source == cuda_volume_tiled.SOURCE

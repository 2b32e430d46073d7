"""The port's own SimConfig (fib_tf_tpu_torch/config.py) pinned equal to the
JAX package's: the same fields and defaults, the same derived quantities
and the same rejected configurations."""

import dataclasses

import pytest

from fib_tf_tpu.config import SimConfig as JaxSimConfig
from fib_tf_tpu_torch import SimConfig as PackageSimConfig
from fib_tf_tpu_torch.config import SimConfig
from test_torch_fixtures import one_torch_thread  # noqa: F401


def test_fields_and_defaults_equal_reference():
    ours = [(f.name, f.default, f.default_factory, f.type)
            for f in dataclasses.fields(SimConfig)]
    ref = [(f.name, f.default, f.default_factory, f.type)
           for f in dataclasses.fields(JaxSimConfig)]
    assert ours == ref
    assert dataclasses.asdict(SimConfig()) == dataclasses.asdict(
        JaxSimConfig())
    assert SimConfig.__dataclass_params__.frozen
    assert PackageSimConfig is SimConfig


CONFIGS = [
    dict(),
    dict(width=512, height=512, dt=0.1, dt_per_plot=10, diff=0.809,
         duration=400, cheby=True, skip=True),
    dict(width=64, height=48, dt=0.05, dt_per_plot=7, duration=123.4),
    dict(width=8, height=8, dt=0.02, dt_per_plot=1, duration=0.5,
         g_scale={"g_K1": 0.5, "g_Na": 1.0}, fiber_angle=0.3,
         fiber_ratio=0.4, chunk_ms=12.5, kernel="xla"),
]


@pytest.mark.parametrize("kw", CONFIGS, ids=range(len(CONFIGS)))
def test_derived_quantities_equal_reference(kw):
    ours, ref = SimConfig(**kw), JaxSimConfig(**kw)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for n in (1, 2, 5, 10):
        assert ours.samples(n) == ref.samples(n)
        assert ours.plot_interval(n) == ref.plot_interval(n)
        for t_ms in (0.0, 0.34, 30.0, 350.0, 999.9):
            assert (ours.millisecond_to_step(t_ms, n)
                    == ref.millisecond_to_step(t_ms, n))
    changed = dict(duration=77.0, skip=not ours.skip)
    assert dataclasses.asdict(ours.replace(**changed)) == dataclasses.asdict(
        ref.replace(**changed))
    d = dict(dataclasses.asdict(ours), samples=3, s2_time=1.0, free_form=2)
    assert dataclasses.asdict(SimConfig.from_dict(d)) == dataclasses.asdict(
        JaxSimConfig.from_dict(d))
    assert hash(ours) == hash(SimConfig(**kw))


INVALID = [
    dict(width=2), dict(height=1), dict(dt=0.0), dict(duration=-1.0),
    dict(kernel="cuda"), dict(substeps_per_launch=0),
    dict(cell_type="atrial"), dict(cell_type_bands=(0.6, 0.25)),
    dict(mesh_mode="ring"), dict(g_scale={"g_K1": -0.5}),
    dict(fiber_ratio=0.0), dict(fiber_angle=0.3),
    dict(fiber_ratio=0.5), dict(adaptive_dv=-1.0),
    dict(adaptive_dv=1.0, dv_max=25.0), dict(adaptive_dv=1.0, ab2=True),
    dict(rotor_probe=True, rotor_tau_ms=0.0),
]


@pytest.mark.parametrize("kw", INVALID, ids=lambda kw: ",".join(kw))
def test_invalid_configs_raise_as_reference(kw):
    with pytest.raises(ValueError) as ref:
        JaxSimConfig(**kw)
    with pytest.raises(ValueError) as ours:
        SimConfig(**kw)
    assert str(ours.value) == str(ref.value)

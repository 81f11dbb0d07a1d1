"""The port's schedulers against the JAX package's: ``value(step)`` tables.

The port evaluates a whole table in one call, ``value(torch.arange(n))``; the
JAX side is ``jax.vmap(value)(jnp.arange(n))``. Both are float32, so the
tables agree to atol 1e-6 (values are O(1)).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torchebm_tpu.core.schedulers as js
import torchebm_tpu_torch.core.schedulers as ts
from torchebm_tpu_torch.utils import scheduler_from_fields

torch.set_num_threads(1)

N = 40


def _fields(s):
    """A JAX scheduler's static fields, nested schedulers as (name, fields)."""
    out = {}
    for f in dataclasses.fields(s):
        v = getattr(s, f.name)
        out[f.name] = (type(v).__name__, _fields(v)) if isinstance(v, js.BaseScheduler) else v
    return out


CASES = [
    ("ConstantScheduler", dict(start_value=0.3)),
    ("ExponentialDecayScheduler", dict(start_value=1.0, decay_rate=0.9, min_value=0.05)),
    ("LinearScheduler", dict(start_value=0.05, end_value=0.01, n_steps=25)),
    ("CosineScheduler", dict(start_value=1.0, end_value=0.2, n_steps=30)),
    ("MultiStepScheduler", dict(start_value=0.5, milestones=(5, 12, 30), gamma=0.5)),
    ("TemperatureScheduler", dict(epsilon_max=0.25, tau_star=0.5, n_steps=30)),
    ("TemperatureScheduler", dict(epsilon_max=0.3, tau_star=0.2, n_steps=20, t_start=0.1,
                                  t_end=1.4, sqrt=False)),
]


@pytest.mark.parametrize("name, kw", CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_value_tables_match_jax(name, kw):
    j = getattr(js, name)(**kw)
    t = scheduler_from_fields(name, _fields(j))
    assert t == getattr(ts, name)(**kw)
    ref = np.asarray(jax.vmap(j.value)(jnp.arange(N)))
    table = t.value(torch.arange(N))
    assert table.dtype == torch.float32 and table.shape == (N,)
    np.testing.assert_allclose(table.numpy(), ref, rtol=0, atol=1e-6)
    # a Python int step gives the table's entry as a 0-d tensor
    for i in (0, 7, N - 1):
        v = t.value(i)
        assert v.shape == () and float(v) == pytest.approx(float(ref[i]), abs=1e-6)


def test_warmup_into_cosine_matches_jax():
    j = js.WarmupScheduler(js.CosineScheduler(0.1, 0.01, 20), warmup_steps=8,
                           warmup_init_factor=0.1)
    t = scheduler_from_fields("WarmupScheduler", _fields(j))
    assert isinstance(t.main_scheduler, ts.CosineScheduler)
    np.testing.assert_allclose(
        t.value(torch.arange(N)).numpy(), np.asarray(jax.vmap(j.value)(jnp.arange(N))),
        rtol=0, atol=1e-6,
    )


def test_sched_value_and_init():
    s = ts.LinearScheduler(1.0, 0.0, 10)
    assert float(ts.sched_value(s, 5)) == pytest.approx(0.5)
    v = ts.sched_value(0.25, 3)
    assert v.dtype == torch.float32 and float(v) == 0.25
    assert ts.sched_init(s) == 1.0 and ts.sched_init(0.7) == 0.7
    assert float(s(10)) == pytest.approx(0.0)


@pytest.mark.parametrize(
    "name, kw",
    [
        ("ExponentialDecayScheduler", dict(start_value=1.0, decay_rate=1.5)),
        ("ExponentialDecayScheduler", dict(start_value=1.0, decay_rate=0.5, min_value=-1)),
        ("LinearScheduler", dict(start_value=1.0, end_value=0.0, n_steps=0)),
        ("CosineScheduler", dict(start_value=1.0, end_value=0.0, n_steps=-2)),
        ("MultiStepScheduler", dict(start_value=1.0, milestones=(3, 2))),
        ("MultiStepScheduler", dict(start_value=1.0, milestones=(0, 2))),
        ("TemperatureScheduler", dict(epsilon_max=-1.0)),
        ("TemperatureScheduler", dict(epsilon_max=1.0, tau_star=1.0)),
        ("TemperatureScheduler", dict(epsilon_max=1.0, t_start=1.0, t_end=0.5)),
    ],
)
def test_validation_matches_jax(name, kw):
    for mod in (js, ts):
        with pytest.raises(ValueError):
            getattr(mod, name)(**kw)


def test_tables_follow_the_step_device():
    t = ts.MultiStepScheduler(1.0, (2, 4))
    steps = torch.arange(6, device="meta")
    assert t.value(steps).device.type == "meta"


def test_convert_rejects_unknown_scheduler():
    with pytest.raises(ValueError, match="Unknown scheduler"):
        scheduler_from_fields("BaseScheduler", {})
    with pytest.raises(ValueError, match="Unknown scheduler"):
        scheduler_from_fields("sched_value", {})

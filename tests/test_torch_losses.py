"""The port's pointwise losses against the JAX package's, on the same
float32 inputs, margins of ±40 included (where an unstable softplus would
overflow)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import losses as jl
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.ops import losses as tl
from photon_ml_tpu_torch.types import TaskType

LOSS_NAMES = ["logistic", "squared", "poisson", "smoothed_hinge"]


def _inputs(name: str):
    rng = np.random.default_rng(7)
    m = np.concatenate(
        [rng.normal(scale=3.0, size=200), [-40.0, -20.0, -1.0, 0.0, 0.5, 1.0, 20.0, 40.0]]
    ).astype(np.float32)
    if name == "poisson":
        m = np.clip(m, -40.0, 20.0)  # exp(40) overflows float32 in both packages
        y = rng.poisson(2.0, size=m.shape).astype(np.float32)
    elif name == "squared":
        y = rng.normal(size=m.shape).astype(np.float32)
    else:
        y = (rng.uniform(size=m.shape) < 0.5).astype(np.float32)
    return m, y


@pytest.mark.parametrize("part", ["value", "d1", "d2"])
@pytest.mark.parametrize("name", LOSS_NAMES)
def test_loss_matches_reference(name, part):
    m, y = _inputs(name)
    ref = np.asarray(getattr(jl.LOSSES[name], part)(jnp.asarray(m), jnp.asarray(y)))
    got = getattr(tl.LOSSES[name], part)(torch.as_tensor(m), torch.as_tensor(y)).numpy()
    assert got.dtype == np.float32
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", LOSS_NAMES)
def test_mean_matches_reference(name):
    m, _ = _inputs(name)
    ref = np.asarray(jl.LOSSES[name].mean(jnp.asarray(m)))
    got = tl.LOSSES[name].mean(torch.as_tensor(m)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_softplus_is_logaddexp_at_wide_margins():
    x = np.asarray([-40.0, -30.0, -1e-3, 0.0, 1e-3, 30.0, 40.0, 88.0], np.float32)
    got = tl.softplus(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.logaddexp(x, 0.0), rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("task", list(TaskType))
def test_loss_for_task_and_kernel_ids(task):
    port = tl.loss_for_task(task)
    assert port.name == jl.loss_for_task(JTask(task.value)).name
    # the CUDA kernels switch on these ids (LossId in csrc/fused_glm.cu)
    ids = {"logistic": 0, "squared": 1, "poisson": 2, "smoothed_hinge": 3}
    assert port.kernel_id == ids[port.name]

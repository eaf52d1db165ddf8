"""K1 / K2: the port's plain versions of the fused value+gradient and
Hessian-vector passes against the JAX package's Pallas kernels, which run
here in interpret mode as ``tests/test_fused.py`` runs them. The CUDA
kernels themselves run only on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold them against these plain versions)."""

from __future__ import annotations

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import fused as jfused
from photon_ml_tpu.ops.glm import make_objective as jax_make_objective
from photon_ml_tpu.ops.losses import LOSSES as JLOSSES
from photon_ml_tpu_torch.convert import dense_batch_from_numpy
from photon_ml_tpu_torch.ops import fused as tfused
from photon_ml_tpu_torch.ops.glm import auto_fused, make_objective
from photon_ml_tpu_torch.ops.losses import LOSSES as TLOSSES

LOSS_NAMES = ["logistic", "squared", "poisson", "smoothed_hinge"]
# tests/test_fused.py's tolerances: float32 storage, then bfloat16 storage
TOL = {
    "float32": dict(value=1e-5, grad=1e-4),
    "bfloat16": dict(value=2e-3, grad=2e-2),
}


def _case(seed: int, n: int, d: int, loss: str, with_aux: bool):
    """float32 numpy inputs. With aux, every 7th row has weight 0 and an
    offset of 100, which overflows the Poisson loss: the select must keep
    those rows at exactly 0."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    if loss == "poisson":
        y = rng.poisson(1.5, size=n).astype(np.float32)
    elif loss == "squared":
        y = rng.normal(size=n).astype(np.float32)
    else:
        y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    off = wt = None
    if with_aux:
        off = (0.1 * rng.normal(size=n)).astype(np.float32)
        wt = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
        wt[::7] = 0.0
        off[::7] = 100.0
    u = (0.1 * rng.normal(size=d)).astype(np.float32)
    v = rng.normal(size=d).astype(np.float32)
    c, cv = np.float32(0.3), np.float32(-0.2)
    return X, y, off, wt, u, v, c, cv


def _jax(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


def _torch(a, dtype=torch.float32):
    return None if a is None else torch.as_tensor(a).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_aux", [False, True], ids=["no_aux", "aux"])
@pytest.mark.parametrize("n", [37, 300])
@pytest.mark.parametrize("loss", LOSS_NAMES)
def test_plain_kernels_match_pallas(loss, n, with_aux, dtype):
    d = 128
    X, y, off, wt, u, v, c, cv = _case(n + d, n, d, loss, with_aux)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = (_jax(X, jdt), _jax(y), _jax(off), _jax(wt))
    targs = (_torch(X, tdt), _torch(y), _torch(off), _torch(wt))
    tol = TOL[dtype]

    jv, jg, jr = jfused.fused_value_grad(
        *jargs, _jax(u), c, loss=JLOSSES[loss], interpret=True
    )
    tv, tg, tr = tfused.fused_value_grad(*targs, _torch(u), float(c), loss=TLOSSES[loss])
    assert np.isfinite(float(tv)) and bool(torch.isfinite(tg).all())
    np.testing.assert_allclose(float(tv), float(jv), rtol=tol["value"])
    np.testing.assert_allclose(float(tr), float(jr), rtol=tol["grad"], atol=tol["grad"])
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=tol["grad"], atol=tol["grad"])

    jh, jq = jfused.fused_hvp(
        *jargs, _jax(u), _jax(v), c, cv, loss=JLOSSES[loss], interpret=True
    )
    th, tq = tfused.fused_hvp(*targs, _torch(u), _torch(v), float(c), float(cv), loss=TLOSSES[loss])
    assert bool(torch.isfinite(th).all())
    np.testing.assert_allclose(float(tq), float(jq), rtol=tol["grad"], atol=tol["grad"])
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=tol["grad"], atol=tol["grad"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("loss", ["logistic", "poisson"])
def test_fused_objective_at_d124_matches_unfused_reference(loss, dtype):
    """d = 124 (a9a's 123 features + intercept) is off the Pallas gate
    (d % 128 != 0), so the JAX package answers through its unfused
    objective; the port's fused objective must agree with it."""
    n, d = 300, 124
    X, y, off, wt, u, v, _, _ = _case(11, n, d, loss, with_aux=True)
    assert tfused.supports_fused(n, d, torch.float32) and not jfused.supports_fused(n, d, jnp.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    from photon_ml_tpu.ops.batch import DenseBatch as JDense

    jbatch = JDense(X=_jax(X, jdt), labels=_jax(y), offsets=_jax(off), weights=_jax(wt))
    tbatch = dense_batch_from_numpy(X, y, off, wt, dtype=tdt, device="cpu")
    jobj = jax_make_objective(jbatch, JLOSSES[loss], l2_weight=0.7, intercept_index=d - 1, fused=False)
    tobj = make_objective(
        tbatch, TLOSSES[loss], l2_weight=0.7, intercept_index=d - 1, fused=True, device="cpu"
    )
    tol = TOL[dtype]
    jv, jg = jobj.value_and_grad(_jax(u))
    tv, tg = tobj.value_and_grad(_torch(u))
    np.testing.assert_allclose(float(tv), float(jv), rtol=tol["value"])
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=tol["grad"], atol=tol["grad"])
    np.testing.assert_allclose(
        tobj.hvp(_torch(u), _torch(v)).numpy(),
        np.asarray(jobj.hvp(_jax(u), _jax(v))),
        rtol=tol["grad"], atol=tol["grad"],
    )


def test_cpu_tensors_take_the_plain_version_without_counting():
    X, y, off, wt, u, v, c, cv = _case(3, 20, 8, "logistic", with_aux=True)
    tfused.reset_launch_counts()
    loss = TLOSSES["logistic"]
    got = tfused.fused_value_grad(_torch(X), _torch(y), _torch(off), _torch(wt), _torch(u), c, loss=loss)
    ref = tfused.fused_value_grad_reference(
        _torch(X), _torch(y), _torch(off), _torch(wt), _torch(u), c, loss=loss
    )
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    tfused.fused_hvp(_torch(X), _torch(y), None, None, _torch(u), _torch(v), c, cv, loss=loss)
    assert tfused.launch_counts == {"fused_value_grad": 0, "fused_hvp": 0}


def test_other_devices_raise():
    X = torch.zeros((4, 2), device="meta")
    y = torch.zeros(4, device="meta")
    u = torch.zeros(2, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tfused.fused_value_grad(X, y, None, None, u, 0.0, loss=TLOSSES["squared"])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tfused.fused_hvp(X, y, None, None, u, u, 0.0, 0.0, loss=TLOSSES["squared"])


def test_launch_checks_reject_what_the_kernel_does_not_take():
    X = torch.zeros((4, 3))
    ok = torch.zeros(4)
    u = torch.zeros(3)
    tfused._check(X, ok, None, ok, (u,))
    with pytest.raises(ValueError, match="contiguous"):
        tfused._check(torch.zeros((3, 4)).T, ok, None, None, (u,))
    with pytest.raises(ValueError, match="labels"):
        tfused._check(X, torch.zeros(5), None, None, (u,))
    with pytest.raises(ValueError, match="vector 0"):
        tfused._check(X, ok, None, None, (torch.zeros(4),))
    with pytest.raises(ValueError, match="weights"):
        tfused._check(X, ok, None, ok.double(), (u,))
    with pytest.raises(ValueError, match="d <= 1024"):
        tfused._check(torch.zeros((4, 1025)), ok, None, None, (torch.zeros(1025),))


def test_supports_fused_gate():
    for d in (1, 124, 128, 256, 512, 1024):
        assert tfused.supports_fused(1 << 20, d, torch.float32)
        assert tfused.supports_fused(1 << 20, d, torch.bfloat16)
    assert not tfused.supports_fused(1 << 20, 1025, torch.float32)
    assert not tfused.supports_fused(1 << 20, 512, torch.float16)
    assert not tfused.supports_fused(0, 512, torch.float32)


def test_auto_fused_only_for_cuda_batches(monkeypatch):
    X, y, *_ = _case(5, 16, 8, "logistic", with_aux=False)
    batch = dense_batch_from_numpy(X, y, device="cpu")
    monkeypatch.delenv("PHOTON_DISABLE_FUSED", raising=False)
    assert auto_fused(batch) is False
    assert make_objective(batch, TLOSSES["logistic"], device="cpu").fused is False


def test_disable_fused_knob_strict_parse(monkeypatch):
    from photon_ml_tpu_torch.ops.glm import fused_disabled

    monkeypatch.delenv("PHOTON_DISABLE_FUSED", raising=False)
    assert fused_disabled() is False
    for value, expect in (("0", False), ("1", True), ("", False)):
        monkeypatch.setenv("PHOTON_DISABLE_FUSED", value)
        assert fused_disabled() is expect
    monkeypatch.setenv("PHOTON_DISABLE_FUSED", "nope")
    with pytest.raises(ValueError):
        fused_disabled()


def test_constant_hints_follow_the_data():
    X, y, off, wt, *_ = _case(5, 16, 8, "logistic", with_aux=True)
    plain = dense_batch_from_numpy(X, y, device="cpu")
    aux = dense_batch_from_numpy(X, y, off, wt, device="cpu")
    loss = TLOSSES["logistic"]
    obj = make_objective(plain, loss, fused=True, device="cpu")
    assert (obj.offsets_zero, obj.weights_one) == (True, True)
    obj = make_objective(aux, loss, fused=True, device="cpu")
    assert (obj.offsets_zero, obj.weights_one) == (False, False)
    obj = make_objective(aux, loss, fused=True, data_hints=(False, True), device="cpu")
    assert (obj.offsets_zero, obj.weights_one) == (False, True)


def test_kernel_source_agrees_with_the_wrappers():
    from photon_ml_tpu_torch.ops import _cuda

    src = next(p for p in _cuda.SOURCES if p.name == "fused_glm.cu").read_text()
    for loss in TLOSSES.values():
        enum = {"logistic": "kLogistic", "squared": "kSquared", "poisson": "kPoisson",
                "smoothed_hinge": "kSmoothedHinge"}[loss.name]
        assert re.search(rf"\b{enum} = {loss.kernel_id}\b", src)
    assert re.search(rf"kMaxFeatures = {tfused.MAX_FEATURES};", src)
    assert "arch=compute_90a,code=sm_90a" in _cuda.NVCC_FLAGS
    assert "atomicAdd" not in src  # deterministic per-block partials only
    assert os.path.basename(_cuda.BUILD_DIR) == "_build"

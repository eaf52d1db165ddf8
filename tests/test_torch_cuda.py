"""K1 / K2 on the card: each CUDA kernel against its plain PyTorch version
on the same CUDA tensors, at small shapes over every loss, storage type,
aux-input combination and load layout (16-byte rows and unaligned rows).
Skipped without a card; run on one with

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.ops import fused
from photon_ml_tpu_torch.ops.losses import LOSSES

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-3, 2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(dev, n, d, dtype, loss, aux, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    X = torch.randn((n, d), generator=g, **f32).to(dtype)
    if loss == "poisson":
        y = torch.poisson(torch.full((n,), 1.5, **f32), generator=g)
    elif loss == "squared":
        y = torch.randn((n,), generator=g, **f32)
    else:
        y = (torch.rand((n,), generator=g, **f32) < 0.5).float()
    off = wt = None
    if aux:
        off = 0.1 * torch.randn((n,), generator=g, **f32)
        wt = 0.5 + torch.rand((n,), generator=g, **f32)
        wt[::7] = 0.0
        off[::7] = 100.0  # overflows the Poisson loss on zero-weight rows
    # margins and X·v of standard deviation 0.5 and 1: the float32 rounding
    # of a row's dot grows with |x|·|u|, and unscaled vectors would make that
    # rounding, not the kernel, decide the comparison
    u = 0.5 * torch.randn((d,), generator=g, **f32) / d**0.5
    v = torch.randn((d,), generator=g, **f32) / d**0.5
    return X, y, off, wt, u, v


@pytest.mark.parametrize("aux", [False, True], ids=["no_aux", "aux"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [1, 37, 124, 128, 256, 512, 1000, 1024])
@pytest.mark.parametrize("loss", list(LOSSES))
def test_kernels_match_plain_versions(dev, loss, d, dtype, aux):
    n = 2053
    X, y, off, wt, u, v = _inputs(dev, n, d, dtype, loss, aux)
    rv, rg = TOL[dtype]
    c, cv = torch.tensor(0.3, device=dev), torch.tensor(-0.2, device=dev)
    fused.reset_launch_counts()
    got = fused.fused_value_grad(X, y, off, wt, u, c, loss=LOSSES[loss])
    ref = fused.fused_value_grad_reference(X, y, off, wt, u, c, loss=LOSSES[loss])
    got_h = fused.fused_hvp(X, y, off, wt, u, v, c, cv, loss=LOSSES[loss])
    ref_h = fused.fused_hvp_reference(X, y, off, wt, u, v, c, cv, loss=LOSSES[loss])
    torch.cuda.synchronize()
    assert fused.launch_counts == {"fused_value_grad": 1, "fused_hvp": 1}
    torch.testing.assert_close(got[0], ref[0], rtol=rv, atol=0.0)
    torch.testing.assert_close(got[1], ref[1], rtol=rg, atol=rg)
    torch.testing.assert_close(got[2], ref[2], rtol=rg, atol=rg)
    torch.testing.assert_close(got_h[0], ref_h[0], rtol=rg, atol=rg)
    torch.testing.assert_close(got_h[1], ref_h[1], rtol=rg, atol=rg)


def test_results_repeat_bitwise(dev):
    X, y, off, wt, u, v = _inputs(dev, 100_003, 256, torch.float32, "logistic", True)
    a = fused.fused_value_grad(X, y, off, wt, u, 0.1, loss=LOSSES["logistic"])
    b = fused.fused_value_grad(X, y, off, wt, u, 0.1, loss=LOSSES["logistic"])
    for x, z in zip(a, b):
        assert torch.equal(x, z)


def test_unaligned_view_takes_the_scalar_layout(dev):
    _, y, _, _, u, _ = _inputs(dev, 300, 128, torch.float32, "squared", False)
    buf = torch.randn(300 * 128 + 1, device=dev)
    Xv = buf[1:].view(300, 128)  # contiguous, but 4 bytes past a 16-byte boundary
    assert Xv.data_ptr() % 16 != 0
    got = fused.fused_value_grad(Xv, y, None, None, u, 0.0, loss=LOSSES["squared"])
    ref = fused.fused_value_grad_reference(Xv, y, None, None, u, 0.0, loss=LOSSES["squared"])
    torch.testing.assert_close(got[1], ref[1], rtol=1e-4, atol=1e-4)


def test_objective_on_cuda_uses_the_kernels(dev):
    from photon_ml_tpu_torch.convert import dense_batch_from_numpy
    from photon_ml_tpu_torch.ops.glm import make_objective

    rng = np.random.default_rng(0)
    X = rng.normal(size=(4096, 124)).astype(np.float32)
    y = (rng.uniform(size=4096) < 0.5).astype(np.float32)
    batch = dense_batch_from_numpy(X, y, device=dev)
    obj = make_objective(batch, LOSSES["logistic"], l2_weight=1.0, intercept_index=123)
    plain = make_objective(batch, LOSSES["logistic"], l2_weight=1.0, intercept_index=123, fused=False)
    assert obj.fused and obj.offsets_zero and obj.weights_one
    w = torch.as_tensor(0.05 * rng.normal(size=124).astype(np.float32), device=dev)
    fused.reset_launch_counts()
    f1, g1 = obj.value_and_grad(w)
    f0, g0 = plain.value_and_grad(w)
    torch.testing.assert_close(f1, f0, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(g1, g0, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(obj.hvp(w, w), plain.hvp(w, w), rtol=1e-4, atol=1e-4)
    assert fused.launch_counts == {"fused_value_grad": 1, "fused_hvp": 1}

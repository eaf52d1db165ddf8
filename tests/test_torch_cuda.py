"""K1 / K2 / K3 on the card: each CUDA kernel against its plain PyTorch
version on the same CUDA tensors, at small shapes: K1 / K2 over every loss,
storage type, aux-input combination and load layout (16-byte rows and
unaligned rows), K1 in both of its layouts (a warp per row, and row tiles
staged in shared memory) over many tiles and a partial last one, K2 at
every width repeating bitwise, K1 and K2 on two streams at once; K3 (the
sparse kernel) over every storage rung and all
three directions. Skipped without a card; run on one with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest sets up JAX, which these tests do
not use.)
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.ops import fused
from photon_ml_tpu_torch.ops import sparse_tiled as st
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
@pytest.mark.parametrize("d", [1, 37, 64, 65, 124, 128, 256, 512, 1000, 1024])
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


@pytest.mark.parametrize("d", [256, 65])
def test_results_repeat_bitwise(dev, d):
    X, y, off, wt, u, v = _inputs(dev, 100_003, d, torch.float32, "logistic", True)
    a = fused.fused_value_grad(X, y, off, wt, u, 0.1, loss=LOSSES["logistic"])
    b = fused.fused_value_grad(X, y, off, wt, u, 0.1, loss=LOSSES["logistic"])
    for x, z in zip(a, b):
        assert torch.equal(x, z)


@pytest.mark.parametrize("layout", list(fused.LAYOUTS))
@pytest.mark.parametrize("aux", [False, True], ids=["no_aux", "aux"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [1, 8, 64, 65, 124, 128, 256])
def test_k1_layouts_over_many_tiles(dev, d, dtype, aux, layout):
    """Both K1 layouts at n = 100,003: hundreds of tiles, the last one
    partial, every width the tiles layout takes."""
    X, y, off, wt, u, _ = _inputs(dev, 100_003, d, dtype, "logistic", aux)
    rv, rg = TOL[dtype]
    loss = LOSSES["logistic"]
    fused.reset_launch_counts()
    got = fused.fused_value_grad_in_layout(X, y, off, wt, u, 0.2, loss=loss, layout=layout)
    ref = fused.fused_value_grad_reference(X, y, off, wt, u, 0.2, loss=loss)
    torch.cuda.synchronize()
    assert fused.launch_counts["fused_value_grad"] == 1
    torch.testing.assert_close(got[0], ref[0], rtol=rv, atol=0.0)
    torch.testing.assert_close(got[1], ref[1], rtol=rg, atol=rg)
    torch.testing.assert_close(got[2], ref[2], rtol=rg, atol=rg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [65, 128, 256, 512])
def test_k1_takes_the_layout_vg_plan_names(dev, d, dtype):
    """The kernel's rule and ``vg_plan`` agree: the rule's result equals,
    bit for bit, the result of the layout ``vg_plan`` names."""
    X, y, off, wt, u, _ = _inputs(dev, 5000, d, dtype, "poisson", True)
    layout = fused.vg_plan(d, dtype, fused.inputs_aligned(X, y, off, wt)).layout
    a = fused.fused_value_grad(X, y, off, wt, u, 0.0, loss=LOSSES["poisson"])
    b = fused.fused_value_grad_in_layout(X, y, off, wt, u, 0.0, loss=LOSSES["poisson"], layout=layout)
    for x, z in zip(a, b):
        assert torch.equal(x, z)


def test_unaligned_labels_refuse_the_tiles_layout(dev):
    X, y, off, _, u, _ = _inputs(dev, 3000, 65, torch.float32, "squared", True)
    yv = torch.cat([torch.zeros(1, device=dev), y])[1:]  # 4 bytes past a 16-byte boundary
    assert fused.vg_plan(65, torch.float32, fused.inputs_aligned(X, yv, off)).layout == "rows"
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        fused.fused_value_grad_in_layout(X, yv, off, None, u, 0.0, loss=LOSSES["squared"],
                                         layout="tiles")
    got = fused.fused_value_grad(X, yv, off, None, u, 0.0, loss=LOSSES["squared"])
    ref = fused.fused_value_grad_reference(X, yv, off, None, u, 0.0, loss=LOSSES["squared"])
    torch.testing.assert_close(got[1], ref[1], rtol=1e-4, atol=1e-4)


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


# ---------------------------------------------------------------------------
# K2 at every width, and the launch path's workspace
# ---------------------------------------------------------------------------
K2_WIDTHS = [1, 7, 65, 124, 128, 255, 256, 512, 1024]


def _k2_check(got, ref, dtype):
    _, rg = TOL[dtype]
    torch.testing.assert_close(got[0], ref[0], rtol=rg, atol=rg)
    torch.testing.assert_close(got[1], ref[1], rtol=rg, atol=rg)


@pytest.mark.parametrize("aux", [False, True], ids=["no_aux", "aux"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", K2_WIDTHS)
@pytest.mark.parametrize("loss", list(LOSSES))
def test_k2_matches_plain_version_at_every_width(dev, loss, d, dtype, aux):
    """K2 at n = 20,011 with c and cv read on the card, one launch counted
    per call."""
    X, y, off, wt, u, v = _inputs(dev, 20_011, d, dtype, loss, aux, seed=d)
    c, cv = torch.tensor(0.3, device=dev), torch.tensor(-0.2, device=dev)
    fused.reset_launch_counts()
    got = fused.fused_hvp(X, y, off, wt, u, v, c, cv, loss=LOSSES[loss])
    ref = fused.fused_hvp_reference(X, y, off, wt, u, v, c, cv, loss=LOSSES[loss])
    torch.cuda.synchronize()
    assert fused.launch_counts["fused_hvp"] == 1
    _k2_check(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 37])
@pytest.mark.parametrize("d", [1, 65, 256, 1024])
def test_k2_on_a_few_rows(dev, d, n, dtype):
    X, y, off, wt, u, v = _inputs(dev, n, d, dtype, "logistic", True)
    loss = LOSSES["logistic"]
    got = fused.fused_hvp(X, y, off, wt, u, v, 0.1, 0.2, loss=loss)
    ref = fused.fused_hvp_reference(X, y, off, wt, u, v, 0.1, 0.2, loss=loss)
    torch.cuda.synchronize()
    _k2_check(got, ref, dtype)


@pytest.mark.parametrize("d", [124, 256, 1024])
def test_k2_repeats_bitwise_and_takes_scalars_either_way(dev, d):
    """K2 gives the same bits on every call, and c / cv read on the card
    equal c / cv passed by value."""
    X, y, off, wt, u, v = _inputs(dev, 100_003, d, torch.float32, "logistic", True)
    loss = LOSSES["logistic"]
    c, cv = torch.tensor(0.25, device=dev), torch.tensor(-0.5, device=dev)
    runs = [fused.fused_hvp(X, y, off, wt, u, v, c, cv, loss=loss) for _ in range(5)]
    runs.append(fused.fused_hvp(X, y, off, wt, u, v, 0.25, -0.5, loss=loss))
    for got in runs[1:]:
        for a, b in zip(runs[0], got):
            assert torch.equal(a, b)


@pytest.mark.parametrize("d", [65, 256])
def test_k1_and_k2_on_two_streams_at_once(dev, d):
    """Two streams launching K1 and K2 in turn, together, each keep their
    own partials workspace: every result equals its one-stream result (at
    d = 65 K1 takes its tiles layout, at 256 its rows layout)."""
    loss = LOSSES["squared"]
    cases = [_inputs(dev, 200_003, d, torch.float32, "squared", True, seed=s) for s in (1, 2)]

    def both(X, y, off, wt, u, v):
        return (*fused.fused_value_grad(X, y, off, wt, u, 0.1, loss=loss),
                *fused.fused_hvp(X, y, off, wt, u, v, 0.1, 0.0, loss=loss))

    alone = [both(*case) for case in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in cases]
    got: list[list] = [[], []]
    for _ in range(20):
        for k, (case, st_) in enumerate(zip(cases, streams)):
            with torch.cuda.stream(st_):
                got[k].append(both(*case))
    torch.cuda.synchronize()
    for k in range(2):
        for res in got[k]:
            for a, b in zip(alone[k], res):
                assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# K3: the sparse kernel
# ---------------------------------------------------------------------------
def _sparse_batch(dev, n, d, k, seed=0, skew=False, hot=False):
    """Uniform columns, or drawn as floor(d·u²) with ``skew``; ``hot`` puts
    every row's first slot in column 3, a write list of the gradient layout
    that spans several of the kernel's tiles."""
    from photon_ml_tpu_torch.ops.batch import SparseBatch

    g = torch.Generator(device=dev).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    u = torch.rand((n, k), generator=g, **f32)
    idx = ((u * u if skew else u) * d).long().clamp_max(d - 1)
    if hot:
        idx[:, 0] = 3
    val = torch.randn((n, k), generator=g, **f32)
    val[torch.rand((n, k), generator=g, **f32) < 0.1] = 0.0
    return SparseBatch(indices=idx, values=val, labels=torch.zeros(n, **f32),
                       offsets=torch.zeros(n, **f32), weights=torch.ones(n, **f32), num_features=d)


SPARSE_SHAPES = {"square": (5000, 4096, 7, {}), "ragged": (3001, 4109, 5, {}),
                 "skewed": (4000, 8192, 16, {"skew": True}), "tiny": (3, 2, 1, {}),
                 "hot_column": (20_000, 4096, 4, {"hot": True}),
                 # gradient tiles span thousands of mostly empty columns and the
                 # int8 margins' scale rows hold 4096 floats: both overflow the
                 # kernel's stage buffers and are read from global memory
                 "very_wide": (3000, 1 << 22, 4, {})}


@pytest.mark.parametrize("shape", list(SPARSE_SHAPES))
@pytest.mark.parametrize("rung", st.KERNEL_DTYPES)
def test_sparse_kernel_matches_plain_version(dev, monkeypatch, rung, shape):
    n, d, k, kind = SPARSE_SHAPES[shape]
    batch = _sparse_batch(dev, n, d, k, **kind)
    monkeypatch.setenv("PHOTON_KERNEL_DTYPE", rung)
    tiled = st.tile_sparse_batch(batch)
    assert tiled.storage == rung
    if shape == "hot_column":  # column 3's nonzeros span several tiles
        assert int(tiled.g.offsets[4] - tiled.g.offsets[3]) > 3 * st.TILE_NNZ
    g = torch.Generator(device=dev).manual_seed(1)
    w = torch.randn(d, generator=g, device=dev)
    r = torch.randn(n, generator=g, device=dev)
    st.reset_launch_counts()
    got = {"matvec": tiled.matvec(w), "rmatvec": tiled.rmatvec(r), "rmatvec_sq": tiled.rmatvec_sq(r)}
    ref = {
        "matvec": st.tiled_apply_reference(tiled.m, w),
        "rmatvec": st.tiled_apply_reference(tiled.g, r),
        "rmatvec_sq": st.tiled_apply_reference(tiled.g, r, square=True),
    }
    torch.cuda.synchronize()
    assert st.launch_counts == {"matvec": 1, "rmatvec": 1, "rmatvec_sq": 1}
    for key in st.DIRECTIONS:
        if rung == "f32":
            torch.testing.assert_close(got[key], ref[key], rtol=1e-5, atol=1e-5)
        else:
            scale = float(ref[key].abs().max()) or 1.0
            torch.testing.assert_close(got[key], ref[key], rtol=0.0, atol=1e-5 * scale)


@pytest.mark.parametrize("rung", st.KERNEL_DTYPES)
def test_sparse_kernel_repeats_bitwise(dev, monkeypatch, rung):
    monkeypatch.setenv("PHOTON_KERNEL_DTYPE", rung)
    tiled = st.tile_sparse_batch(_sparse_batch(dev, 20_000, 5000, 9, skew=True))
    r = torch.randn(20_000, device=dev)
    w = torch.randn(5000, device=dev)
    assert torch.equal(tiled.rmatvec(r), tiled.rmatvec(r))
    assert torch.equal(tiled.rmatvec_sq(r), tiled.rmatvec_sq(r))
    assert torch.equal(tiled.matvec(w), tiled.matvec(w))


def test_sparse_kernel_without_nonzeros_stores_zeros(dev):
    batch = _sparse_batch(dev, 1500, 4096, 3)
    batch = type(batch)(indices=batch.indices, values=torch.zeros_like(batch.values),
                        labels=batch.labels, offsets=batch.offsets, weights=batch.weights,
                        num_features=batch.num_features)
    tiled = st.tile_sparse_batch(batch)
    assert tiled.m.nnz == 0 and tiled.m.num_tiles == 0
    assert torch.equal(tiled.matvec(torch.randn(4096, device=dev)), torch.zeros(1500, device=dev))
    assert torch.equal(tiled.rmatvec(torch.randn(1500, device=dev)), torch.zeros(4096, device=dev))


def test_sparse_kernel_refuses_a_wrong_source(dev):
    tiled = st.tile_sparse_batch(_sparse_batch(dev, 100, 50, 3))
    with pytest.raises(ValueError, match="source"):
        tiled.matvec(torch.randn(49, device=dev))


def test_objective_on_cuda_tiled_batch_uses_the_sparse_kernel(dev, monkeypatch):
    monkeypatch.delenv("PHOTON_KERNEL_DTYPE", raising=False)
    from photon_ml_tpu_torch.ops.glm import compute_variances, make_objective
    from photon_ml_tpu_torch.types import VarianceComputationType

    batch = _sparse_batch(dev, 6000, 4096, 6)
    batch = type(batch)(indices=batch.indices, values=batch.values,
                        labels=(torch.rand(6000, device=dev) < 0.5).float(), offsets=batch.offsets,
                        weights=batch.weights, num_features=batch.num_features)
    obj = make_objective(st.tile_sparse_batch(batch), LOSSES["logistic"], l2_weight=1.0)
    plain = make_objective(batch, LOSSES["logistic"], l2_weight=1.0)
    assert obj.one_pass_value_grad and not obj.fused
    w = 0.05 * torch.randn(4096, device=dev)
    st.reset_launch_counts()
    f1, g1 = obj.value_and_grad(w)
    var = compute_variances(obj, w, VarianceComputationType.SIMPLE)
    f0, g0 = plain.value_and_grad(w)
    torch.testing.assert_close(f1, f0, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(g1, g0, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(var, compute_variances(plain, w, VarianceComputationType.SIMPLE),
                               rtol=1e-4, atol=0.0)
    v = torch.randn(4096, device=dev)
    torch.testing.assert_close(obj.hvp(w, v), plain.hvp(w, v), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(model_score(obj, w), model_score(plain, w), rtol=1e-5, atol=1e-5)
    # value_and_grad: margins + gradient; hessian_diag: margins + both
    # gradient directions; hvp: margins twice + gradient; scoring: margins
    assert st.launch_counts == {"matvec": 5, "rmatvec": 3, "rmatvec_sq": 1}


def model_score(obj, w):
    from photon_ml_tpu_torch.models import Coefficients, GeneralizedLinearModel

    return GeneralizedLinearModel(Coefficients(w)).score(obj.batch)


# ---------------------------------------------------------------------------
# GAME: the fixed effect on K1, the random effects' lane-batched Newton
# ---------------------------------------------------------------------------
def _game_batches(dev, n=3000, effects=(("userId", 40, 4), ("itemId", 15, 4))):
    from photon_ml_tpu_torch.convert import game_batch_from_numpy
    from photon_ml_tpu_torch.data.synthetic import synthetic_game_data

    data = synthetic_game_data(np.random.default_rng(9), n, 12,
                               {k: (e, d) for k, e, d in effects})
    feats = {"global": data.X, **{f"per_{k}": data.entity_X[k] for k, _, _ in effects}}
    return data, [game_batch_from_numpy(data.y, feats, id_tags=data.entity_ids, device=dv)
                  for dv in (dev, "cpu")]


def _game_config(effects):
    from photon_ml_tpu_torch import config as c
    from photon_ml_tpu_torch.types import OptimizerType, RegularizationType

    # Newton at the logistic tolerance of the CPU parity tests: below it a
    # lane's stopping rule turns on float32 rounding, which differs between
    # the card's products and the CPU's (ROADMAP queue 3)
    newton = c.OptimizationConfig(
        optimizer=c.OptimizerConfig(optimizer_type=OptimizerType.NEWTON_CHOLESKY,
                                    max_iterations=20, tolerance=1e-3),
        regularization=c.RegularizationContext(RegularizationType.L2), regularization_weight=1.0)
    return c.GameTrainingConfig(
        coordinate_update_sequence=("fixed", *(f"per_{k}" for k in effects)),
        coordinate_descent_iterations=2,
        fixed_effect_coordinates={"fixed": c.FixedEffectCoordinateConfig(
            "global", c.OptimizationConfig(optimizer=c.OptimizerConfig(max_iterations=20,
                                                                        tolerance=1e-7)))},
        random_effect_coordinates={
            f"per_{k}": c.RandomEffectCoordinateConfig(k, f"per_{k}", newton, bucket_target_count=8,
                                                       bucket_max_padded_ratio=0.5)
            for k in effects
        },
    )


def test_game_fit_on_the_card_runs_the_fixed_effect_on_k1(dev):
    from photon_ml_tpu_torch.estimators import GameEstimator
    from photon_ml_tpu_torch.transformers import GameTransformer

    data, (gpu, cpu) = _game_batches(dev)
    cfg = _game_config(("userId", "itemId"))
    fused.reset_launch_counts()
    st.reset_launch_counts()
    got = GameEstimator(cfg, intercept_indices={"global": data.intercept_index}).fit(gpu)[0]
    passes = sum(t.objective_passes for t in got.descent.trackers["fixed"])
    assert fused.launch_counts == {"fused_value_grad": passes, "fused_hvp": 0} and passes > 0
    assert not any(st.launch_counts.values())
    ref = GameEstimator(cfg, intercept_indices={"global": data.intercept_index},
                        device="cpu").fit(cpu)[0]
    for cid, sub in ref.model.models.items():
        torch.testing.assert_close(got.model[cid].coefficient_means.cpu(), sub.coefficient_means,
                                   rtol=0.0, atol=1e-3)
    scores = GameTransformer(got.model).transform(gpu)
    assert scores.device.type == "cuda"
    torch.testing.assert_close(scores.cpu(), GameTransformer(ref.model, device="cpu").transform(cpu),
                               rtol=0.0, atol=1e-3)


def test_random_effects_on_the_card_match_the_cpu(dev):
    from photon_ml_tpu_torch.config import OptimizerConfig
    from photon_ml_tpu_torch.game.data import bucket_entities, group_by_entity
    from photon_ml_tpu_torch.game.random_effect import train_random_effects
    from photon_ml_tpu_torch.types import OptimizerType, VarianceComputationType

    data, (gpu, cpu) = _game_batches(dev)
    ids = data.entity_ids["userId"]
    buckets = bucket_entities(group_by_entity(ids))
    cfg = OptimizerConfig(optimizer_type=OptimizerType.NEWTON_CHOLESKY, max_iterations=20,
                          tolerance=1e-3)
    out = []
    for b in (gpu, cpu):
        out.append(train_random_effects(
            b.features["per_userId"], b.labels, b.offsets, b.weights, buckets, int(ids.max()) + 1,
            LOSSES["logistic"], cfg, l2_weight=1.0,
            variance_computation=VarianceComputationType.SIMPLE, device=b.device,
        ))
    got, ref = out
    assert got.coefficients.device.type == "cuda"
    torch.testing.assert_close(got.coefficients.cpu(), ref.coefficients, rtol=0.0, atol=1e-4)
    torch.testing.assert_close(got.variances.cpu(), ref.variances, rtol=1e-3, atol=1e-5)
    assert np.all(np.abs(got.iterations - ref.iterations) <= 1)


@pytest.mark.parametrize("solver,l1,sparse", [("LBFGS", 0.0, False), ("TRON", 0.0, False),
                                              ("LBFGS", 0.5, False), ("LBFGS", 0.0, True)],
                         ids=["lbfgs", "tron", "owlqn", "lbfgs_sparse"])
def test_lane_solvers_on_the_card_match_the_cpu(dev, solver, l1, sparse):
    """L-BFGS, TRON and OWL-QN over entity lanes, and a sparse shard,
    solve on the card as on the CPU (the solvers run on the bucket
    tensors' device; no kernel of the port runs in them)."""
    from photon_ml_tpu_torch.config import OptimizerConfig
    from photon_ml_tpu_torch.game.data import SparseFeatures, bucket_entities, group_by_entity
    from photon_ml_tpu_torch.game.random_effect import train_random_effects
    from photon_ml_tpu_torch.types import OptimizerType

    data, (gpu, cpu) = _game_batches(dev)
    ids = data.entity_ids["userId"]
    buckets = bucket_entities(group_by_entity(ids))
    cfg = OptimizerConfig(optimizer_type=OptimizerType(solver), max_iterations=50, tolerance=1e-3)
    out = []
    for b in (gpu, cpu):
        feats = b.features["per_userId"]
        if sparse:
            d = feats.X.shape[1]
            feats = SparseFeatures(torch.arange(d, device=b.device).repeat(feats.X.shape[0], 1),
                                   feats.X, d)
        fused.reset_launch_counts()
        out.append(train_random_effects(
            feats, b.labels, b.offsets, b.weights, buckets, int(ids.max()) + 1, LOSSES["logistic"],
            cfg, l2_weight=1.0, l1_weight=l1, device=b.device,
        ))
        assert not any(fused.launch_counts.values())
    got, ref = out
    assert got.coefficients.device.type == "cuda"
    torch.testing.assert_close(got.coefficients.cpu(), ref.coefficients, rtol=0.0, atol=1e-4)
    assert np.all(np.abs(got.iterations - ref.iterations) <= 1)


def test_device_evaluators_on_the_card_match_the_cpu(dev):
    """MULTI_AUC, PRECISION_AT_K and BUCKETED_AUC on CUDA scores against
    the same evaluators on the CPU and the numpy host versions."""
    from photon_ml_tpu_torch.evaluation import grouped_auc, grouped_precision_at_k, make_evaluator

    rng = np.random.default_rng(3)
    n = 20_000
    s = (np.round(rng.normal(size=n) * 8) / 8).astype(np.float32)  # ties
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-s))).astype(np.float32)
    g = rng.integers(-1, 500, size=n)
    keep = g >= 0
    host = {"MULTI_AUC(u)": grouped_auc(s[keep], y[keep], g[keep]),
            "PRECISION_AT_K(5,u)": grouped_precision_at_k(s[keep], y[keep], g[keep], 5)}
    for spec in ("MULTI_AUC(u)", "PRECISION_AT_K(5,u)", "BUCKETED_AUC"):
        ev = make_evaluator(spec)
        on = [ev(torch.as_tensor(s, device=d), torch.as_tensor(y, device=d), None,
                 {"u": torch.as_tensor(g, device=d)}) for d in (dev, torch.device("cpu"))]
        assert on[0] == pytest.approx(on[1], abs=1e-9), spec
        if spec in host:
            assert on[0] == pytest.approx(host[spec], abs=1e-6), spec


def test_game_drivers_on_the_card_match_the_cpu(dev, tmp_path):
    """The GAME train then score drivers on Avro files, on the card and on
    the CPU: the same metrics.json keys and best index, metrics within 1e-3,
    the best model and the scores within the Newton card tolerance (1e-3),
    and the fixed effect's passes on K1."""
    import json

    from photon_ml_tpu_torch import config as c
    from photon_ml_tpu_torch.cli import score, train
    from photon_ml_tpu_torch.io.avro import read_avro_file, write_avro_file
    from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_SCHEMA
    from photon_ml_tpu_torch.types import ModelOutputMode

    rng = np.random.default_rng(5)
    n, users = 3000, 40
    X = rng.normal(size=(n, 4)).astype(np.float32)
    U = rng.normal(size=(n, 2)).astype(np.float32)
    ids = rng.integers(0, users, size=n)
    w_user = rng.normal(size=(users, 2))
    y = rng.uniform(size=n) < 1 / (1 + np.exp(-(X @ rng.normal(size=4) + np.einsum("nd,nd->n", U, w_user[ids]))))
    schema = json.loads(json.dumps(TRAINING_EXAMPLE_SCHEMA))
    schema["fields"].insert(5, {"name": "userFeatures", "type": {"type": "array", "items": "NameTermValueAvro"},
                                "default": []})

    def write(path, rows):
        write_avro_file(str(path), schema, [{
            "uid": f"s{i}", "response": float(y[i]),
            "features": [{"name": "g", "term": str(j), "value": float(X[i, j])} for j in range(4)],
            "userFeatures": [{"name": "u", "term": str(j), "value": float(U[i, j])} for j in range(2)],
            "metadataMap": {"userId": f"user_{ids[i]}"},
        } for i in rows])

    write(tmp_path / "train.avro", range(0, 2400))
    write(tmp_path / "val.avro", range(2400, n))
    doc = _game_config(("userId",)).to_dict()
    # L2 on the fixed effect, so that the grid's two entries differ
    doc["fixed_effect_coordinates"]["fixed"]["optimization"]["regularization"]["regularization_type"] = "L2"
    cfg = c.parse_config(dict(
        doc,
        feature_shards={"global": {"feature_bags": ["features"], "has_intercept": True},
                        "per_userId": {"feature_bags": ["userFeatures"], "has_intercept": False}},
        evaluators=["AUC", "MULTI_AUC(userId)"], output_mode=ModelOutputMode.ALL.value,
        regularization_weight_grid={"fixed": [0.1, 10.0]},
    ))
    out = {}
    for where in ("cuda", "cpu"):
        fused.reset_launch_counts()
        train.run(cfg, [str(tmp_path / "train.avro")], str(tmp_path / where),
                  validation_data=[str(tmp_path / "val.avro")], device=where)
        launches = dict(fused.launch_counts)
        scores, metrics = score.run(str(tmp_path / where), [str(tmp_path / "val.avro")],
                                    str(tmp_path / f"score-{where}"), evaluators=["AUC"],
                                    feature_shards=dict(cfg.feature_shards), device=where)
        out[where] = dict(launches=launches, scores=scores.cpu(), metrics=metrics,
                          train=json.loads((tmp_path / where / "metrics.json").read_text()),
                          file=read_avro_file(str(tmp_path / f"score-{where}" / "scores" / "part-00000.avro"))[1])
    gpu, cpu = out["cuda"], out["cpu"]
    assert gpu["launches"]["fused_value_grad"] > 0 and gpu["launches"]["fused_hvp"] == 0
    assert not any(cpu["launches"].values())
    assert gpu["train"]["best_index"] == cpu["train"]["best_index"]
    for g, r in zip(gpu["train"]["results"], cpu["train"]["results"]):
        assert g["configuration"] == r["configuration"] and g["metrics"].keys() == r["metrics"].keys()
        for k, v in r["metrics"].items():
            assert abs(g["metrics"][k] - v) <= 1e-3
    torch.testing.assert_close(gpu["scores"], cpu["scores"], rtol=0.0, atol=1e-3)
    assert [r["uid"] for r in gpu["file"]] == [r["uid"] for r in cpu["file"]]
    np.testing.assert_allclose([r["predictionScore"] for r in gpu["file"]], gpu["scores"].numpy(), atol=1e-6)
    assert abs(gpu["metrics"]["AUC"] - cpu["metrics"]["AUC"]) <= 1e-3


def test_projectors_on_the_card_match_the_cpu(dev):
    """The per-entity subspace columns (a stable sort on the card, with
    ties and an always-included intercept) equal the CPU's exactly; a GAME
    fit with a per-user subspace and a per-item random projection on the
    card matches the CPU's within the lane tolerance (atol 2e-3 / rtol
    1e-2), and its random projection scores as (XP)·w_p."""
    from photon_ml_tpu_torch import config as c
    from photon_ml_tpu_torch.estimators import GameEstimator
    from photon_ml_tpu_torch.game.projector import entity_top_columns

    rng = np.random.default_rng(8)
    X = rng.normal(size=(40, 50, 9)).astype(np.float32) * (rng.uniform(size=(40, 50, 9)) < 0.3)
    for p in (1, 3, 8):
        got = entity_top_columns(torch.from_numpy(X).to(dev), p, always_include=8)
        assert torch.equal(got.cpu(), entity_top_columns(torch.from_numpy(X), p, always_include=8))
    doc = _game_config(("userId", "itemId")).to_dict()
    doc["random_effect_coordinates"]["per_userId"]["features_to_samples_ratio_upper_bound"] = 0.25
    doc["random_effect_coordinates"]["per_itemId"]["random_projection_dim"] = 2
    cfg = c.parse_config(doc)
    data, batches = _game_batches(dev)
    models = [GameEstimator(cfg, intercept_indices={"global": data.intercept_index}, device=b.device)
              .fit(b)[0].model for b in batches]
    for cid in models[1].models:
        np.testing.assert_allclose(models[0][cid].coefficient_means.cpu().numpy(),
                                   models[1][cid].coefficient_means.numpy(), atol=2e-3, rtol=1e-2)


def _streamed_chunks(kind: str, seed: int = 0):
    from photon_ml_tpu_torch.ops import streaming

    rng = np.random.default_rng(seed)
    if kind == "dense":
        X = rng.normal(size=(2000, 33)).astype(np.float32)
        y = (rng.uniform(size=2000) < 0.5).astype(np.float32)
        return streaming.dense_chunks(X, y, 512, (0.1 * rng.normal(size=2000)).astype(np.float32)), 33
    idx = rng.integers(0, 8192, size=(3000, 6)).astype(np.int32)
    val = rng.normal(size=(3000, 6)).astype(np.float32)
    y = (rng.uniform(size=3000) < 0.5).astype(np.float32)
    return streaming.sparse_chunks(idx, val, y, 1024), 8192


def _streamed_objective(chunks, d, device):
    from photon_ml_tpu_torch.ops import streaming
    from photon_ml_tpu_torch.ops.losses import logistic_loss

    return streaming.StreamingGLMObjective(chunks, logistic_loss, d, l2_weight=0.5, tile_sparse=True,
                                           device=device)


@pytest.mark.parametrize("kind", ["dense", "tiled"])
def test_streamed_objective_on_the_card_matches_its_cpu_run(dev, kind):
    """value_and_grad, hvp, hessian_diag and the scores of the streamed
    objective on the card (K1 / K2 on dense chunks, K3 on tiled ones)
    against the same objective on the CPU (the kernels' plain versions)."""
    from photon_ml_tpu_torch.ops import prefetch, tile_cache

    prefetch.clear_cache()
    tile_cache.clear()
    chunks, d = _streamed_chunks(kind)
    gpu, cpu = _streamed_objective(chunks, d, dev), _streamed_objective(chunks, d, "cpu")
    assert gpu.tiled == (kind == "tiled")
    w = (0.1 * np.random.default_rng(1).normal(size=d)).astype(np.float32)
    vg, vc = gpu.value_and_grad(w), cpu.value_and_grad(w)
    np.testing.assert_allclose(float(vg[0]), float(vc[0]), rtol=1e-5)
    np.testing.assert_allclose(vg[1].cpu().numpy(), vc[1].numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gpu.hvp(w, w).cpu().numpy(), cpu.hvp(w, w).numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gpu.hessian_diag(w).cpu().numpy(), cpu.hessian_diag(w).numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gpu.stream_scores(w, 1900), cpu.stream_scores(w, 1900), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["dense", "tiled"])
def test_streamed_depth_0_and_2_are_bitwise_on_the_card(dev, monkeypatch, kind):
    from photon_ml_tpu_torch.config import OptimizerConfig
    from photon_ml_tpu_torch.ops import prefetch
    from photon_ml_tpu_torch.optim.host_lbfgs import host_lbfgs_minimize

    chunks, d = _streamed_chunks(kind, seed=2)
    out = {}
    for depth in ("0", "2"):
        monkeypatch.setenv("PHOTON_PREFETCH_DEPTH", depth)
        prefetch.clear_cache()
        obj = _streamed_objective(chunks, d, dev)
        res = host_lbfgs_minimize(obj, np.zeros(d), OptimizerConfig(max_iterations=8, tolerance=0.0))
        out[depth] = (res.w.cpu(), obj.value_and_grad(res.w)[1].cpu())
    assert all(torch.equal(a, b) for a, b in zip(out["0"], out["2"]))


def test_streamed_launches_per_chunk(dev):
    """One K1 launch per dense chunk per value-and-gradient pass, one K2 per
    chunk per Hessian-vector pass, none on a value-only pass; one K3 launch
    per tiled chunk per direction."""
    chunks, d = _streamed_chunks("dense")
    obj = _streamed_objective(chunks, d, dev)
    w = np.zeros(d, np.float32)
    fused.reset_launch_counts()
    obj.value_and_grad(w)
    obj.value_and_grad(w)
    obj.hvp(w, w)
    obj.value(w)
    assert fused.launch_counts == {"fused_value_grad": 2 * len(chunks), "fused_hvp": len(chunks)}
    chunks, d = _streamed_chunks("tiled")
    obj = _streamed_objective(chunks, d, dev)
    st.reset_launch_counts()
    obj.value_and_grad(np.zeros(d, np.float32))
    obj.hessian_diag(np.zeros(d, np.float32))
    n = len(chunks)
    assert st.launch_counts == {"matvec": 2 * n, "rmatvec": 2 * n, "rmatvec_sq": n}


def test_streamed_fe_shard_one_range_is_bitwise_knob_off_on_the_card(dev, monkeypatch):
    """``PHOTON_FE_SHARD=1`` on one process (one range) over tiled chunks on
    the card: value and gradient, H·v, diag(H) and both scorers bitwise
    the knob-off objective's, K3 launched once per chunk a phase (the
    gradient phase without the knob-off diagonal's extra ``rmatvec``)."""
    from photon_ml_tpu_torch.ops import streaming, tile_cache

    chunks, d = _streamed_chunks("tiled")
    rng = np.random.default_rng(2)
    w, v = (0.1 * rng.normal(size=d)).astype(np.float32), rng.normal(size=d).astype(np.float32)
    outs = {}
    for knob in ("", "1"):
        monkeypatch.setenv("PHOTON_FE_SHARD", knob)
        tile_cache.clear()
        obj = _streamed_objective(chunks, d, dev)
        assert obj.fe_active is (knob == "1") and obj.tiled
        st.reset_launch_counts()
        val, g = obj.value_and_grad(w)
        diag = obj.hessian_diag(w)
        launches = dict(st.launch_counts)
        outs[knob] = [val, g, obj.hvp(w, v), diag, torch.as_tensor(obj.stream_scores(w, 3000)),
                      torch.as_tensor(streaming.stream_scores(chunks, w, 3000, num_features=d, device=dev))]
        n = len(chunks)
        assert launches == {"matvec": 2 * n, "rmatvec": n if knob else 2 * n, "rmatvec_sq": n}
    for got, want in zip(outs["1"], outs[""]):
        assert torch.equal(got.cpu(), want.cpu())
    tile_cache.clear()


def test_chunk_cache_tiers_on_the_card(dev, monkeypatch):
    """On the bf16 rung, under a budget of two chunks, the device tier evicts
    the cast features into the host tier, which a later pass hits; the
    copies land on the card intact."""
    from photon_ml_tpu_torch.ops import prefetch

    chunks, d = _streamed_chunks("dense", seed=3)
    chunks = [{k: v.copy() for k, v in c.items()} for c in chunks]  # each pins its own arrays
    x_bytes = chunks[0]["X"].nbytes
    rest = sum(v.nbytes for k, v in chunks[0].items() if k != "X")
    budget = 2 * (x_bytes + x_bytes // 2 + rest)  # two chunks' pinned host bytes, the cast X included
    monkeypatch.setenv("PHOTON_KERNEL_DTYPE", "bf16")
    monkeypatch.setenv("PHOTON_CHUNK_CACHE_BUDGET", str(budget))
    prefetch.clear_cache()
    consumer = torch.cuda.current_stream(dev)
    for order in (chunks, chunks[::-1]):  # the second pass starts at the resident end
        for c in order:
            put = prefetch.cached_device_put(c, dev, consumer)
            prefetch.wait(put, consumer)
            assert put["X"].device.type == "cuda" and put["X"].dtype == torch.bfloat16
            assert torch.equal(put["X"].cpu(), torch.from_numpy(c["X"]).to(torch.bfloat16))
            assert torch.equal(put["labels"].cpu(), torch.from_numpy(c["labels"]))
    s = prefetch.cache_stats()
    assert s["evictions"] > 0 and s["host_hits"] > 0 and s["device_bytes"] <= budget
    prefetch.clear_cache()


@pytest.mark.parametrize("solver", ["NEWTON_CHOLESKY", "LBFGS"])
def test_streamed_game_fit_on_the_card_matches_the_cpu(dev, solver):
    """The out-of-core GAME trainer on the card (the fixed effect's chunks
    on K1, one launch per chunk of every value-and-gradient pass; the
    random-effect buckets gathered into pinned memory and copied every
    visit) against the same fit on the CPU: fixed coefficients rtol 1e-3 /
    atol 2e-4, random effects at the lane tolerance."""
    from photon_ml_tpu_torch.config import (
        FixedEffectCoordinateConfig,
        GameTrainingConfig,
        OptimizationConfig,
        OptimizerConfig,
        RandomEffectCoordinateConfig,
        RegularizationContext,
    )
    from photon_ml_tpu_torch.game.streaming import StreamedGameData, StreamedGameTrainer
    from photon_ml_tpu_torch.types import OptimizerType, RegularizationType

    rng = np.random.default_rng(5)
    n, d, E = 3000, 65, 40
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, -1] = 1.0
    Xu = rng.normal(size=(n, 8)).astype(np.float32)
    ids = rng.integers(0, E, size=n)
    W = rng.normal(size=(E, 8)).astype(np.float32) * 0.5
    margin = X @ (rng.normal(size=d).astype(np.float32) * 0.2) + np.sum(W[ids] * Xu, axis=1)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float32)
    data = StreamedGameData(labels=y, features={"g": X, "u": Xu}, id_tags={"uid": ids})
    opt = OptimizerConfig(max_iterations=20, tolerance=1e-4)
    re_opt = OptimizationConfig(optimizer=OptimizerConfig(optimizer_type=OptimizerType(solver), max_iterations=20,
                                                          tolerance=1e-4),
                                regularization=RegularizationContext(RegularizationType.L2), regularization_weight=1.0)
    cfg = GameTrainingConfig(
        coordinate_update_sequence=("fixed", "user"), coordinate_descent_iterations=2,
        fixed_effect_coordinates={"fixed": FixedEffectCoordinateConfig("g", OptimizationConfig(optimizer=opt))},
        random_effect_coordinates={"user": RandomEffectCoordinateConfig("uid", "u", re_opt)},
    )
    fits = {}
    for device in (dev, "cpu"):
        fused.reset_launch_counts()
        t = StreamedGameTrainer(cfg, chunk_rows=1024, intercept_indices={"g": d - 1}, device=device)
        model, _ = t.fit(data)
        passes = sum(v["objective_passes"] for v in t.visit_stats if "objective_passes" in v)
        fits[str(device)] = (model, dict(fused.launch_counts), passes)
    (gm, launches, passes), (cm, _, _) = fits[str(dev)], fits["cpu"]
    assert passes > 0 and launches == {"fused_value_grad": 3 * passes, "fused_hvp": 0}
    np.testing.assert_allclose(gm["fixed"].model.coefficients.means.cpu().numpy(),
                               cm["fixed"].model.coefficients.means.numpy(), rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(gm["user"].coefficients.cpu().numpy(), cm["user"].coefficients.numpy(),
                               rtol=1e-2, atol=2e-3)


def test_sharded_objective_on_several_shards_of_one_card(dev, monkeypatch):
    """Four row shards on one card: K1 once per shard a value-and-gradient
    pass and K2 once per shard a Hessian-vector pass (the padding rows read
    weight 0), the contracts against the same shards on the CPU (the
    kernels' plain versions) and the unsharded objective on the card; then
    the sparse branch with one K3 layout per shard, once per shard and
    direction."""
    from photon_ml_tpu_torch.config import OptimizerConfig
    from photon_ml_tpu_torch.convert import dense_batch_from_numpy, sparse_batch_from_numpy
    from photon_ml_tpu_torch.ops import streaming
    from photon_ml_tpu_torch.ops.glm import make_objective
    from photon_ml_tpu_torch.optim import lbfgs_minimize
    from photon_ml_tpu_torch.parallel import data_mesh, sharded_objective

    rng = np.random.default_rng(3)
    n, d = 5003, 64
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    mesh = data_mesh(4, devices=[dev])
    on_card = dense_batch_from_numpy(X, y, device=dev)
    obj = sharded_objective(on_card, mesh, LOSSES["logistic"], l2_weight=0.5)
    cpu = sharded_objective(dense_batch_from_numpy(X, y, device="cpu"), data_mesh(4, devices=["cpu"]),
                            LOSSES["logistic"], l2_weight=0.5, fused=True)
    assert obj.fused and all(not o.weights_one for o in obj.shards)
    w = torch.as_tensor((0.1 * rng.normal(size=d)).astype(np.float32), device=dev)
    fused.reset_launch_counts()
    f, g = obj.value_and_grad(w)
    hv = obj.hvp(w, w)
    assert fused.launch_counts == {"fused_value_grad": 4, "fused_hvp": 4}
    fc, gc = cpu.value_and_grad(w.cpu())
    np.testing.assert_allclose(float(f), float(fc), rtol=1e-5)
    np.testing.assert_allclose(g.cpu().numpy(), gc.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(hv.cpu().numpy(), cpu.hvp(w.cpu(), w.cpu()).numpy(), rtol=1e-4, atol=1e-4)
    cfg = OptimizerConfig(max_iterations=20, tolerance=0.0)
    res = lbfgs_minimize(obj, torch.zeros(d, device=dev), cfg)
    one = lbfgs_minimize(make_objective(on_card, LOSSES["logistic"], l2_weight=0.5, device=dev),
                         torch.zeros(d, device=dev), cfg)
    np.testing.assert_allclose(res.w.cpu().numpy(), one.w.cpu().numpy(), rtol=1e-3, atol=1e-4)

    monkeypatch.setattr(streaming, "device_hbm_budget_bytes", lambda *a, **k: 1.0)
    idx = rng.integers(0, 8192, size=(4096, 6))
    val = rng.normal(size=(4096, 6)).astype(np.float32)
    ys = (rng.uniform(size=4096) < 0.5).astype(np.float32)
    sobj = sharded_objective(sparse_batch_from_numpy(idx, val, ys, num_features=8192, device=dev), mesh,
                             LOSSES["logistic"], l2_weight=0.5)
    scpu = sharded_objective(sparse_batch_from_numpy(idx, val, ys, num_features=8192, device="cpu"),
                             data_mesh(4, devices=["cpu"]), LOSSES["logistic"], l2_weight=0.5)
    assert all(isinstance(o.batch, st.TiledSparseBatch) for o in sobj.shards)
    ws = torch.as_tensor((0.1 * rng.normal(size=8192)).astype(np.float32), device=dev)
    st.reset_launch_counts()
    fs, gs = sobj.value_and_grad(ws)
    hd = sobj.hessian_diag(ws)
    assert st.launch_counts == {"matvec": 8, "rmatvec": 8, "rmatvec_sq": 4}
    fsc, gsc = scpu.value_and_grad(ws.cpu())
    np.testing.assert_allclose(float(fs), float(fsc), rtol=1e-5)
    np.testing.assert_allclose(gs.cpu().numpy(), gsc.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(hd.cpu().numpy(), scpu.hessian_diag(ws.cpu()).numpy(), rtol=1e-4, atol=1e-4)


def test_sharded_objective_host_reduction_is_bitwise_the_card_reduction(dev, monkeypatch):
    """Four row shards on the card: the float64 shard-order sum a mesh across
    processes takes on the host (``_sum_across_processes``, its gather
    replaced by this one process's shards) gives the bits of the sum on the
    card in shard order, for every contract the solvers read, so P
    processes × L shards reproduce one process × P·L shards."""
    from photon_ml_tpu_torch.convert import dense_batch_from_numpy
    from photon_ml_tpu_torch.parallel import data_mesh, distributed, sharded_objective

    rng = np.random.default_rng(9)
    n, d = 40_003, 65
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    obj = sharded_objective(dense_batch_from_numpy(X, y, device=dev), data_mesh(4, devices=[dev]),
                            LOSSES["logistic"], l2_weight=0.5)
    w = torch.as_tensor((0.1 * rng.normal(size=d)).astype(np.float32), device=dev)
    monkeypatch.setattr(distributed, "_gather_arrays", lambda arrays: [arrays])
    fused.reset_launch_counts()
    for contract, args in ((lambda o, wi: o.value_and_grad_partials(wi), (obj._bcast(w),)),
                           (lambda o, wi, vi: o.hvp_partials(wi, vi), (obj._bcast(w), obj._bcast(w))),
                           (lambda o, wi: o.hessian_diag_partials(wi), (obj._bcast(w),))):
        parts = obj._each(contract, *args)
        on_card, on_host = obj._sum(parts), obj._sum_across_processes(parts)
        assert len(on_card) == len(on_host)
        for a, b in zip(on_card, on_host):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert fused.launch_counts["fused_value_grad"] == 4 and fused.launch_counts["fused_hvp"] == 4


_ALLREDUCE_WORKER = """
import sys
root, port, rank, path = sys.argv[1:5]
rank = int(rank)
sys.path.insert(0, root)
import numpy as np
import torch
from photon_ml_tpu_torch.ops import fused
from photon_ml_tpu_torch.ops.losses import LOSSES
from photon_ml_tpu_torch.parallel import multihost as mh

mh.initialize_multihost(f"127.0.0.1:{port}", 2, rank, timeout_s=100)
z = np.load(path)
half = len(z["y"]) // 2
rows = slice(0, half) if rank == 0 else slice(half, None)
dev = torch.device("cuda")
X = torch.as_tensor(z["X"][rows], device=dev)
y = torch.as_tensor(z["y"][rows], device=dev)
val, g, r = fused.fused_value_grad(X, y, None, None, torch.as_tensor(z["u"], device=dev),
                                   torch.zeros((), device=dev), loss=LOSSES["logistic"])
assert fused.launch_counts["fused_value_grad"] == 1
total = mh.allreduce_sum_host(*(t.double().cpu().numpy() for t in (val, g, r)))
np.savez(path.replace(".npz", f"-rank{rank}.npz"), val=total[0], g=total[1], r=total[2])
mh.shutdown_multihost()
print("WORKER DONE", rank)
"""


def test_two_process_allreduce_of_cuda_readbacks(dev, tmp_path):
    """Two processes on one card, gloo over loopback: each runs K1 on its
    half of the rows and sums the read-backs with ``allreduce_sum_host``;
    both receive identical bytes, equal to K1 over all rows within the
    float32 tolerance."""
    import os
    import socket
    import subprocess
    import sys

    from photon_ml_tpu_torch.ops import _cuda

    _cuda.load()  # built once here, before two processes would build it at once
    rng = np.random.default_rng(4)
    n, d = 1 << 14, 96
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    u = (0.1 * rng.normal(size=d)).astype(np.float32)
    np.savez(tmp_path / "in.npz", X=X, y=y, u=u)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", _ALLREDUCE_WORKER, root, str(port), str(r),
                               str(tmp_path / "in.npz")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER DONE {r}" in out, err
    got = [np.load(tmp_path / f"in-rank{r}.npz") for r in range(2)]
    for key in ("val", "g", "r"):
        assert got[0][key].tobytes() == got[1][key].tobytes()
    val, g, r = fused.fused_value_grad(torch.as_tensor(X, device=dev), torch.as_tensor(y, device=dev), None, None,
                                       torch.as_tensor(u, device=dev), torch.zeros((), device=dev),
                                       loss=LOSSES["logistic"])
    np.testing.assert_allclose(float(got[0]["val"]), float(val), rtol=1e-5)
    np.testing.assert_allclose(got[0]["g"], g.cpu().numpy(), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the random-effect schedule knobs and the projection on the card
# ---------------------------------------------------------------------------
def _skewed_lanes(dev, E=97, C=16, d=8, seed=7):
    """bench.py's R_re_skew at a small size (every 16th entity's columns
    scaled 1-60) as three buckets of one capacity, 48 and 48 lanes and a
    one-lane bucket, odd lane counts and fronts of every size."""
    from photon_ml_tpu_torch.game.data import DenseFeatures, EntityBuckets

    rng = np.random.default_rng(seed)
    ids = np.repeat(np.arange(E), C)
    X = rng.normal(size=(E * C, d)).astype(np.float32)
    X[np.isin(ids, np.arange(0, E, 16))] *= np.geomspace(1.0, 60.0, d).astype(np.float32)
    W = (rng.normal(size=(E, d)) * 0.5).astype(np.float32)
    y = (rng.uniform(size=E * C) < 1 / (1 + np.exp(-np.clip(np.sum(W[ids] * X, axis=1), -60, 60)))).astype(np.float32)
    rows = np.arange(E * C, dtype=np.int64).reshape(E, C)
    cuts = [0, 48, 96, 97]
    buckets = EntityBuckets(capacities=(C, C, C), entity_ids=[np.arange(a, b) for a, b in zip(cuts, cuts[1:])],
                            row_indices=[rows[a:b] for a, b in zip(cuts, cuts[1:])])
    return dict(features=DenseFeatures(X=torch.from_numpy(X).to(dev)), labels=y,
                offsets=np.zeros(E * C, np.float32), weights=np.ones(E * C, np.float32), buckets=buckets,
                num_entities=E, loss=LOSSES["logistic"], l2_weight=1.0, device=dev)


@pytest.mark.parametrize("solver,l1", [("LBFGS", 0.0), ("LBFGS", 0.05), ("TRON", 0.0)],
                         ids=["lbfgs", "owlqn", "tron"])
def test_schedule_knobs_are_bitwise_on_the_card(dev, monkeypatch, solver, l1):
    """``PHOTON_RE_COMPACT_EVERY`` in {1, 4, 16} and ``PHOTON_RE_FUSE_BUCKETS``
    change the launches and not the bits at this fixture's shapes (fronts
    of 2-64 lanes of C = 16, d = 8, whose products keep their kernels on
    the card; at larger lane counts they do not, ROADMAP queue 3):
    coefficients, variances, objectives and iterations equal to the
    knob-off solve's; fusion takes three launches to two (the one-lane
    bucket stays alone)."""
    from photon_ml_tpu_torch.config import OptimizerConfig
    from photon_ml_tpu_torch.game import random_effect as tre
    from photon_ml_tpu_torch.types import OptimizerType, VarianceComputationType

    prob = _skewed_lanes(dev)
    cfg = OptimizerConfig(optimizer_type=OptimizerType(solver), max_iterations=100, tolerance=1e-7)
    kw = dict(config=cfg, l1_weight=l1, variance_computation=VarianceComputationType.SIMPLE, **prob)

    def run(ce, fuse):
        monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", ce)
        monkeypatch.setenv("PHOTON_RE_FUSE_BUCKETS", fuse)
        tre.reset_launch_counts()
        res = tre.train_random_effects(**kw)
        return (res.coefficients, res.variances, torch.as_tensor(res.loss_values),
                torch.as_tensor(res.iterations)), tre.launch_counts["launches"]

    ref, launches = run("0", "0")
    assert launches == 3 and int(ref[3].max()) > float(ref[3].double().median())  # lanes retire at other times
    for ce, fuse in (("1", "0"), ("4", "0"), ("16", "1"), ("0", "1"), ("4", "1")):
        got, launches = run(ce, fuse)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), (ce, fuse)
        if ce == "0":
            assert launches == 2


def test_streamed_schedule_knobs_are_bitwise_on_the_card(dev, monkeypatch):
    """The out-of-core trainer on the card with lane compaction and fusion,
    at a size whose fronts keep their kernels: the model bitwise the
    knob-off fit's, the chunks launched."""
    from photon_ml_tpu_torch.config import (
        FixedEffectCoordinateConfig,
        GameTrainingConfig,
        OptimizationConfig,
        OptimizerConfig,
        RandomEffectCoordinateConfig,
        RegularizationContext,
    )
    from photon_ml_tpu_torch.game import random_effect as tre
    from photon_ml_tpu_torch.game.streaming import StreamedGameData, StreamedGameTrainer
    from photon_ml_tpu_torch.types import RegularizationType

    rng = np.random.default_rng(5)
    n, d, E = 3000, 65, 40
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, -1] = 1.0
    Xu = rng.normal(size=(n, 8)).astype(np.float32)
    ids = rng.integers(0, E, size=n)
    Xu[ids % 8 == 0] *= np.geomspace(1.0, 30.0, 8).astype(np.float32)
    W = rng.normal(size=(E, 8)).astype(np.float32) * 0.5
    margin = X @ (rng.normal(size=d).astype(np.float32) * 0.2) + np.sum(W[ids] * Xu, axis=1)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-np.clip(margin, -60, 60)))).astype(np.float32)
    data = StreamedGameData(labels=y, features={"g": X, "u": Xu}, id_tags={"uid": ids})
    opt = OptimizationConfig(optimizer=OptimizerConfig(max_iterations=40, tolerance=1e-7),
                             regularization=RegularizationContext(RegularizationType.L2), regularization_weight=1.0)
    cfg = GameTrainingConfig(
        coordinate_update_sequence=("fixed", "user"), coordinate_descent_iterations=2,
        fixed_effect_coordinates={"fixed": FixedEffectCoordinateConfig("g", opt)},
        random_effect_coordinates={"user": RandomEffectCoordinateConfig("uid", "u", opt)},
    )
    models, launches = [], []
    for ce, fuse in (("0", "0"), ("3", "1")):
        monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", ce)
        monkeypatch.setenv("PHOTON_RE_FUSE_BUCKETS", fuse)
        tre.reset_launch_counts()
        model, _ = StreamedGameTrainer(cfg, chunk_rows=1024, intercept_indices={"g": d - 1}, device=dev).fit(data)
        models.append(model)
        launches.append(tre.launch_counts["launches"])
    assert launches[1] > launches[0]
    for cid in models[0].models:
        assert torch.equal(models[0][cid].coefficient_means, models[1][cid].coefficient_means), cid


@pytest.mark.parametrize("mode", ["support", "hash"])
def test_projection_on_the_card_matches_the_cpu(dev, monkeypatch, mode):
    """``PHOTON_RE_PROJECT`` on the card against the same solve on the CPU
    (lane tolerance), the columns off each class support exactly 0."""
    from photon_ml_tpu_torch.config import OptimizerConfig
    from photon_ml_tpu_torch.game import bucket_entities, group_by_entity, train_random_effects
    from photon_ml_tpu_torch.game.data import DenseFeatures
    from photon_ml_tpu_torch.types import VarianceComputationType

    rng = np.random.default_rng(11)
    E, d = 30, 24
    rows = np.repeat([6, 14, 30], 10)
    widths = np.repeat([5, 12, 24], 10)
    ids = np.repeat(np.arange(E), rows)
    X = rng.normal(size=(len(ids), d)).astype(np.float32)
    X = np.where(np.arange(d)[None, :] < widths[ids][:, None], X, 0.0).astype(np.float32)
    y = (rng.uniform(size=len(ids)) < 0.5).astype(np.float32)
    monkeypatch.setenv("PHOTON_RE_PROJECT", mode)
    monkeypatch.setenv("PHOTON_RE_PROJECT_DIM", "8")
    out = {}
    for device in (dev, "cpu"):
        res = train_random_effects(
            DenseFeatures(X=torch.from_numpy(X).to(device)), y, np.zeros(len(ids), np.float32),
            np.ones(len(ids), np.float32), bucket_entities(group_by_entity(ids, num_entities=E)), E,
            LOSSES["logistic"], OptimizerConfig(max_iterations=25, tolerance=1e-7), l2_weight=1.0,
            variance_computation=VarianceComputationType.SIMPLE, device=device)
        out[str(device)] = res.coefficients.cpu().numpy(), res.variances.cpu().numpy()
    (W, V), (Wc, Vc) = out[str(dev)], out["cpu"]
    np.testing.assert_allclose(W, Wc, rtol=1e-2, atol=2e-3)
    np.testing.assert_allclose(V, Vc, rtol=1e-2, atol=2e-3)
    assert (W[:10, 5:] == 0).all() and (W[10:20, 12:] == 0).all()


def test_segments_combine_is_bitwise_the_dense_combine_on_the_card(dev, tmp_path):
    """``PHOTON_RE_COMBINE=segments`` across two processes on one card
    (``PHOTON_RE_SHARD=1``, in memory): bitwise the dense combine on both
    processes, at full width, projected and split, with fewer bytes sent
    by each (``tests/test_torch_re_split.py``'s workers and fixture)."""
    import test_torch_re_split as split_tests

    from photon_ml_tpu_torch.ops import _cuda

    _cuda.load()  # built once here, before two processes would build it at once
    ranks = split_tests.run_workers("card-combine", 2, tmp_path)
    for arrays, meta in ranks:
        for base in ("", "split_", "project_"):
            for what in ("W", "V", "it", "loss"):
                np.testing.assert_array_equal(arrays[f"{base}segments_{what}"], arrays[f"{base}allreduce_{what}"])
                np.testing.assert_array_equal(arrays[f"{base}segments_{what}"], ranks[0][0][f"{base}segments_{what}"])
            sent = {arm: meta[f"{base}{arm}"]["counters"]["re_combine.bytes_sent"] for arm in ("allreduce", "segments")}
            assert 0 < sent["segments"] < sent["allreduce"], sent



def test_device_split_over_the_card_and_the_cpu(dev, monkeypatch):
    """``PHOTON_RE_DEVICE_SPLIT`` over a mesh of two different entries, the
    card and then the CPU (``PHOTON_RE_SHARD=1``, in memory): the result's
    matrices lie on the card, the buckets each entry solved are bitwise
    that entry's knob-off solve, and the per-entity diagnostics, which
    come from both entries, read back as one (``tests/test_torch_re_shard.py``'s
    fixture)."""
    import test_torch_re_shard as rs

    from photon_ml_tpu_torch.game.data import DenseFeatures
    from photon_ml_tpu_torch.game.random_effect import prepare_buckets, train_random_effects
    from photon_ml_tpu_torch.parallel.mesh import data_mesh

    f = rs.fixture()
    kw = rs.in_memory_kwargs(f)
    monkeypatch.setenv("PHOTON_RE_SHARD", "1")
    off = [train_random_effects(mesh=data_mesh(1, [d]), **kw) for d in (dev, "cpu")]
    monkeypatch.setenv("PHOTON_RE_DEVICE_SPLIT", "1")
    mesh = data_mesh(2, [dev, "cpu"])
    prepared = prepare_buckets(DenseFeatures(X=torch.tensor(f["X"])), torch.tensor(f["y"]), torch.ones(f["n"]),
                               kw["buckets"], mesh=mesh)
    assert {pb.device for pb in prepared} == {0, 1}
    got = train_random_effects(mesh=mesh, **kw)
    assert got.coefficients.device.type == got.variances.device.type == dev.type
    W, V = got.coefficients.cpu().numpy(), got.variances.cpu().numpy()
    for pb in prepared:
        want, ids = off[pb.device], pb.entity_ids
        np.testing.assert_array_equal(W[ids], want.coefficients.cpu().numpy()[ids])
        np.testing.assert_array_equal(V[ids], want.variances.cpu().numpy()[ids])
        np.testing.assert_array_equal(got.iterations[ids], want.iterations[ids])
        np.testing.assert_array_equal(got.loss_values[ids], want.loss_values[ids])
    assert (got.iterations > 0).all() and np.isfinite(got.loss_values).all()


def test_faults_streamed_peer_kill_recovers_bitwise_on_the_card(dev, tmp_path):
    """The streamed peer-kill drill (``tests/test_torch_faults_drill.py``)
    with its processes on the card: process 1 killed at its second visit's
    offsets send, process 0 degraded and resumed from the last checkpoint,
    bitwise one process's fit over its rows resumed from the anchor."""
    import test_torch_faults_drill as drill

    from photon_ml_tpu_torch.ops import _cuda

    _cuda.load()  # built once here, before the workers would build it at once
    drill.check_streamed_peer_kill(tmp_path, device="cuda")


def test_faults_streamed_writer_kill_of_three_recovers_bitwise_on_the_card(dev, tmp_path):
    """The three-process drill on the card: process 0, the writer, killed;
    processes 1 and 2 resume at their bases in the anchor's layout,
    bitwise two processes' fit over their rows resumed from the anchor
    sliced to those rows."""
    import test_torch_faults_drill as drill

    from photon_ml_tpu_torch.ops import _cuda

    _cuda.load()
    drill.check_streamed_peer_kill(tmp_path, device="cuda", killed=0, nproc=3, groups=True)


def test_rejoin_after_kill_bitwise_with_four_processes_on_the_card(dev, tmp_path):
    """The elastic-rejoin drill (``tests/test_torch_rejoin_drill.py``) with
    its four processes on the card: process 3 killed at its second visit's
    offsets send and re-exec'd 2 s later (the re-exec'd process on the card
    too), admitted back at the first visit boundary after the degrade;
    every model bitwise the uninterrupted four-process run on the card,
    the counters and the fleet's rejoin records as on the CPU."""
    import test_torch_rejoin_drill as rejoin

    from photon_ml_tpu_torch.ops import _cuda

    _cuda.load()
    clean = rejoin.clean_run(tmp_path / "uninterrupted", device="cuda")
    rejoin.check_rejoin(tmp_path / "rejoin", rejoin.KILL_AND_REJOIN, clean, device="cuda", telemetry=True)


def _tools_files(tmp_path, n=4000, users=50, seed=9):
    """Avro part files for the tools' card tests: 4 global and 2 per-user
    features, a user id a row, two training parts."""
    import json

    from photon_ml_tpu_torch.io.avro import write_avro_file
    from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_SCHEMA

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    U = rng.normal(size=(n, 2)).astype(np.float32)
    ids = rng.integers(0, users, size=n)
    y = rng.uniform(size=n) < 1 / (1 + np.exp(-(X @ rng.normal(size=4))))
    schema = json.loads(json.dumps(TRAINING_EXAMPLE_SCHEMA))
    schema["fields"].insert(5, {"name": "userFeatures", "type": {"type": "array", "items": "NameTermValueAvro"},
                                "default": []})
    train = tmp_path / "train"
    train.mkdir()
    for part, rows in enumerate((range(0, n // 2), range(n // 2, n))):
        write_avro_file(str(train / f"part-{part:05d}.avro"), schema, [{
            "uid": f"s{i}", "response": float(y[i]),
            "features": [{"name": "g", "term": str(j), "value": float(X[i, j])} for j in range(4)],
            "userFeatures": [{"name": "u", "term": str(j), "value": float(U[i, j])} for j in range(2)],
            "metadataMap": {"userId": f"user_{ids[i]}"},
        } for i in rows])
    doc = _game_config(("userId",)).to_dict()
    doc["feature_shards"] = {"global": {"feature_bags": ["features"], "has_intercept": True},
                             "per_userId": {"feature_bags": ["userFeatures"], "has_intercept": False}}
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(doc))
    return str(train), str(cfg)


def test_tools_index_store_and_index_features_on_the_card_machine(dev, tmp_path):
    """``index-features`` through the umbrella, then a ``NativeIndexStore``
    of every shard map: its lookups are the map's, an unknown key -1."""
    from photon_ml_tpu_torch.cli import main as umbrella
    from photon_ml_tpu_torch.data.index_map import IndexMap
    from photon_ml_tpu_torch.native import NativeIndexStore

    train, cfg = _tools_files(tmp_path)
    idx = tmp_path / "index"
    umbrella.main(["index-features", "--data", train, "--config", cfg, "--output-dir", str(idx)])
    maps = {p.stem: IndexMap.load(str(p)) for p in idx.glob("*.npz")}
    assert set(maps) == {"global", "per_userId"} and maps["global"].size == 5
    for sid, imap in maps.items():
        keys = [k for k, _ in imap.items()]
        store = NativeIndexStore.build(str(tmp_path / f"{sid}.pidx"), imap.items())
        np.testing.assert_array_equal(store.lookup_all(keys + ["absent\x01key"]),
                                      np.append(imap.lookup_all(np.array(keys)), -1))
        assert store.get("absent\x01key") == -1 and store.size == imap.size


def test_tools_train_with_index_maps_on_the_card_is_bitwise_without(dev, tmp_path):
    """The umbrella's ``train --index-maps`` on the card against the same
    train without the flag: the same model files, bit for bit, and the
    same K1 launches."""
    from photon_ml_tpu_torch.cli import main as umbrella
    from photon_ml_tpu_torch.io.avro import read_avro_file

    train, cfg = _tools_files(tmp_path)
    idx = str(tmp_path / "index")
    umbrella.main(["index-features", "--data", train, "--config", cfg, "--output-dir", idx])
    got, launches = {}, {}
    for name, extra in (("plain", []), ("indexed", ["--index-maps", idx])):
        fused.reset_launch_counts()
        umbrella.main(["train", "--config", cfg, "--train-data", train, "--output-dir", str(tmp_path / name),
                       "--device", "cuda", *extra])
        torch.cuda.synchronize()
        launches[name] = dict(fused.launch_counts)
        root = tmp_path / name
        got[name] = {str(p.relative_to(root)): read_avro_file(str(p))[1] for p in root.rglob("*.avro")}
        got[name].update({str(p.relative_to(root)): p.read_bytes() for p in root.rglob("*.json")})
    assert got["plain"] and got["plain"] == got["indexed"]
    assert launches["plain"] == launches["indexed"] and launches["plain"]["fused_value_grad"] > 0


def test_tools_report_and_gate_of_a_card_run(dev, tmp_path, capsys, monkeypatch):
    """``train --telemetry-dir`` on the card with the kernels built afresh
    inside the run (a build directory of its own), then ``report --json``
    and ``report gate`` through the umbrella: the summary's compile_s is
    the run's cuda.build_s (nonzero, within the run's wall), and the run
    passes a gate against itself."""
    import json

    from photon_ml_tpu_torch.cli import main as umbrella
    from photon_ml_tpu_torch.obs.report import latest_run, load_run
    from photon_ml_tpu_torch.ops import _cuda

    train, cfg = _tools_files(tmp_path)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_cuda, "_lib", None)
    tel = tmp_path / "telemetry"
    umbrella.main(["train", "--config", cfg, "--train-data", train, "--output-dir", str(tmp_path / "out"),
                   "--device", "cuda", "--telemetry-dir", str(tel)])
    assert _cuda.library_path().exists()
    capsys.readouterr()
    umbrella.main(["report", str(tel), "--json"])
    summary = json.loads(capsys.readouterr().out)
    recs = load_run(latest_run(str(tel)))
    build = recs[-1]["metrics"]["timers"]["cuda.build_s"]["seconds"] - recs[0].get(
        "metrics_baseline", {}).get("timers", {}).get("cuda.build_s", {}).get("seconds", 0.0)
    assert 0 < summary["compile_s"] == build < summary["wall_s"]
    assert {"ingest", "train", "descent"} <= set(summary["phases"])
    base = tmp_path / "base.json"
    for argv, code in ((["gate", str(tel), "--write-baseline", str(base)], 0),
                       (["gate", str(tel), "--baseline", str(base)], 0)):
        with pytest.raises(SystemExit) as e:
            umbrella.main(["report", *argv])
        assert e.value.code == code


# ---------------------------------------------------------------------------
# online serving (ROADMAP queue 1 item 8): the hot rows on the card
# ---------------------------------------------------------------------------
def test_serve_window_scores_on_the_card(dev):
    """Windows scored from CUDA hot rows: bitwise the batch scorer on the
    card on the rows each window scores (padding included, out-of-range ids
    masked), within rtol = atol = 1e-5 of it on the whole set (cuBLAS sums
    a row's dot product in another order at another row count: on the H100
    1,085 of 2,011 main_serve rows differ, by up to 1.9e-6)."""
    import test_torch_serve as ts

    from photon_ml_tpu_torch.serve.store import HotModelStore

    for d_fe in (4, 65):
        model = ts._port_model(ts._arrays(E=300, d_fe=d_fe, d_re=8), "cuda")
        ents = np.random.default_rng(4).integers(-2, 302, size=2011)
        reqs = ts._requests(model, 2011, seed=4, entities=ents)
        store = HotModelStore(model, budget_bytes=300 * 8 * 4 // 4, device=dev)
        assert store.shard_for("per_member", 3).device.type == "cuda"
        got = ts._serve(store, reqs, 32)
        ts._assert_window_parity(model, reqs, got, 32, tol=1e-5)
        assert 0.0 < store.hit_rate() < 1.0


@pytest.mark.parametrize("case", ["lbfgs", "owlqn", "tron", "newton"])
def test_serve_refresh_bitwise_offline_on_the_card(dev, case):
    """The chunked refresh of one entity on the card is bitwise the one-shot
    offline solve of the same bucket (both one lane of the same shapes)."""
    import test_torch_serve as ts

    from photon_ml_tpu_torch.config import OptimizerConfig
    from photon_ml_tpu_torch.serve.refresh import entity_event_batch, refresh_entity, solve_entity_offline

    solver, l1 = ts.SOLVER_CASES[case]
    model = ts._port_model(ts._arrays(E=16, d_re=3, seed=5), "cuda")
    X, y = ts._events(k=40, seed=6)
    batch = entity_event_batch(X, y, device=dev)
    cfg = OptimizerConfig(optimizer_type=solver, max_iterations=40, tolerance=1e-7)
    updated, res = refresh_entity(model, "per_member", 6, batch, cfg, l2_weight=1.0, l1_weight=l1, chunk=3)
    offline = solve_entity_offline(model["per_member"], 6, batch, cfg, l2_weight=1.0, l1_weight=l1)
    assert res.w.device.type == "cuda" and torch.equal(res.w, offline.w)
    assert torch.equal(updated["per_member"].coefficients[6], res.w[0])


def test_serve_two_process_collective_step_on_the_card(dev):
    """The two-process serving drill (``tests/test_torch_serve.py``) with
    both processes' hot rows on the card: cross-owner routing, a peer killed
    mid-step, the survivor's degrade and retried step."""
    import test_torch_serve as ts

    results = ts.run_serve_drill("cuda")
    assert results[0]["mm1"] == 0 and results[1]["mm1"] == 0
    assert results[0]["forwarded"] + results[1]["forwarded"] > 0
    assert results[0]["peer_lost"] is True and results[0]["survivors"] == [0]
    assert results[0]["mm2"] == 0 and results[0]["owner_all_zero"]


def test_serve_driver_runs_on_the_card_by_default(dev, tmp_path, capsys):
    """``photon-ml-tpu-torch serve`` with no ``--device`` serves on CUDA from
    a published root."""
    import json

    import test_torch_serve as ts

    from photon_ml_tpu_torch.cli import main as umbrella
    from photon_ml_tpu_torch.io.model_io import model_fingerprint, publish_game_model

    model = ts._port_model(ts._arrays(E=500, d_fe=6, d_re=8, seed=3), "cuda")
    publish_game_model(model, str(tmp_path / "pub"))
    umbrella.main(["serve", "--model-root", str(tmp_path / "pub"), "--requests", "2000", "--rate-hz", "4000"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device"] == "cuda" and line["requests"] == 2000
    assert line["fingerprint"] == model_fingerprint(model) and 0.0 < line["hot_hit_rate"] < 1.0


# ---------------------------------------------------------------------------
# the stream executor (PHOTON_STREAM_EXECUTOR=1): its arbiter on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def stream_executor_clean(dev, monkeypatch):
    from photon_ml_tpu_torch.ops import prefetch
    from photon_ml_tpu_torch.ops import stream_executor as se

    monkeypatch.setenv("PHOTON_CHUNK_CACHE_BUDGET", str(1 << 30))
    monkeypatch.delenv("PHOTON_STREAM_SHARE", raising=False)
    prefetch.clear_cache()
    se.clear()
    yield se
    prefetch.clear_cache()
    se.clear()


def test_stream_executor_shared_entry_outlives_its_release_on_a_second_stream(dev, stream_executor_clean):
    """A second consumer's shared hit is read by a kernel on its own stream
    while both holders release the entry and the copy stream allocates the
    same bytes and overwrites them: the kernel still reads the chunk
    (``record_stream`` of the hit), bitwise the run with no release."""
    from photon_ml_tpu_torch.ops import prefetch

    se = stream_executor_clean
    X = np.random.default_rng(0).normal(size=(1 << 14, 512)).astype(np.float32)  # 32 MiB

    def read(release: bool):
        se.clear()
        mine, other = torch.cuda.Stream(device=dev), torch.cuda.Stream(device=dev)
        with torch.cuda.stream(mine):
            first = se.cached_device_put("objective", {"X": X}, dev, mine)
            prefetch.wait(first, mine)
        with torch.cuda.stream(other):
            hit = se.cached_device_put("scores", {"X": np.array(X)}, dev, other)  # fresh copy: a shared hit
            prefetch.wait(hit, other)
            assert se.cache_stats()["shared_hits"] == 1 and hit["X"] is first["X"]
            torch.cuda._sleep(200_000_000)  # the read waits behind a long kernel
            got = hit["X"].sum(dim=0)
        junk = None
        if release:
            del first, hit
            se.drop_entries()
            with torch.cuda.stream(prefetch._copy_stream(dev)):  # the next chunk's copy: the same bytes
                junk = torch.empty((1 << 14, 512), device=dev).fill_(float("nan"))
        torch.cuda.synchronize()
        return got, junk

    held, _ = read(False)
    released, junk = read(True)
    assert torch.equal(released, held) and not torch.isnan(held).any() and bool(torch.isnan(junk).all())


def test_stream_executor_devices_are_kept_apart(dev, stream_executor_clean):
    """The same content on the card and on the CPU: two entries, each
    charged to its device; "cuda" and "cuda:<index>" name one card."""
    se = stream_executor_clean
    a = np.arange(4096, dtype=np.float32)
    on_card = se.cached_device_put("re_scores", {"X": a}, "cuda")
    on_cpu = se.cached_device_put("re_scores", {"X": a}, "cpu")
    again = se.cached_device_put("re_scores", {"X": np.array(a)}, f"cuda:{torch.cuda.current_device()}")
    torch.cuda.synchronize()
    assert on_card["X"].device.type == "cuda" and on_cpu["X"].device.type == "cpu"
    assert again["X"] is on_card["X"]
    s = se.cache_stats()
    assert (s["entries"], s["misses"], s["hits"], s["bytes"]) == (2, 2, 1, 2 * a.nbytes)
    assert {k[-1] for k in se._entries} == {"cpu", f"cuda:{torch.cuda.current_device()}"}


def test_stream_executor_quiesce_leaves_the_arbiter_empty(dev, stream_executor_clean):
    from photon_ml_tpu_torch.ops import prefetch
    from photon_ml_tpu_torch.ops.losses import loss_for_task
    from photon_ml_tpu_torch.ops.streaming import StreamingGLMObjective, dense_chunks
    from photon_ml_tpu_torch.types import TaskType

    se = stream_executor_clean
    rng = np.random.default_rng(1)
    X = rng.normal(size=(4096, 65)).astype(np.float32)
    y = (rng.uniform(size=4096) < 0.5).astype(np.float32)
    import os

    os.environ["PHOTON_STREAM_EXECUTOR"] = "1"
    try:
        obj = StreamingGLMObjective(dense_chunks(X, y, 1024), loss_for_task(TaskType.LOGISTIC_REGRESSION), 65,
                                    device=dev)
        v1 = obj.value(np.zeros(65, np.float32))
        assert se.cache_stats()["entries"] > 0
        prefetch.quiesce()
        s = se.cache_stats()
        assert (s["entries"], s["bytes"], s["charges"]) == (0, 0, {})
        assert se.priority_of("objective") == 50
        assert torch.equal(obj.value(np.zeros(65, np.float32)), v1)  # refilled after the quiesce
    finally:
        del os.environ["PHOTON_STREAM_EXECUTOR"]


def serve_and_refresh(dev, model, requests: list, items: list, max_batch: int = 32):
    """Requests through a ``MicroWindowServer`` on this thread while a
    second thread runs ``refresh_stream`` over ``items``: (scores, the
    refreshed model's random-effect coefficients)."""
    import threading

    from photon_ml_tpu_torch.config import OptimizerConfig
    from photon_ml_tpu_torch.serve.refresh import refresh_stream
    from photon_ml_tpu_torch.serve.router import MicroWindowServer
    from photon_ml_tpu_torch.serve.store import HotModelStore

    out, refreshed, errors = [], {}, []

    def refresh():
        try:
            m, _ = refresh_stream(model, items, OptimizerConfig(max_iterations=20, tolerance=1e-7), l2_weight=1.0,
                                  device=dev)
            refreshed.update({cid: sub.coefficients for cid, sub in m.models.items() if hasattr(sub, "num_entities")})
        except BaseException as e:  # raised again on this thread
            errors.append(e)

    server = MicroWindowServer(HotModelStore(model, device=dev), on_scores=lambda w, s: out.append(s),
                               max_batch=max_batch, max_wait_ms=1e9)
    worker = threading.Thread(target=refresh)
    worker.start()
    for r in requests:
        server.submit(r)
    server.drain()
    worker.join()
    if errors:
        raise errors[0]
    return np.concatenate(out), refreshed


def test_stream_executor_serve_and_refresh_at_once(dev, stream_executor_clean, monkeypatch):
    """Windows scored while a refresh stream prepares on the executor's
    workers: knob on bitwise knob off, scores and refreshed rows."""
    import test_torch_serve as ts

    model = ts._port_model(ts._arrays(E=300, d_fe=65, d_re=8, seed=2), "cuda")
    reqs = ts._requests(model, 1000, seed=3)
    rng = np.random.default_rng(4)
    items = []
    for e in range(16):
        X, y = ts._events(k=8 + e, d=8, seed=40 + e)
        items.append(("per_member", 7 * e, X, y, rng.normal(size=8 + e).astype(np.float32), None))
    arms = {}
    for knob in ("0", "1"):
        monkeypatch.setenv("PHOTON_STREAM_EXECUTOR", knob)
        monkeypatch.setenv("PHOTON_PREFETCH_DEPTH", "2")
        arms[knob] = serve_and_refresh(dev, model, reqs, items)
    (s0, m0), (s1, m1) = arms["0"], arms["1"]
    assert np.array_equal(s0.view(np.uint32), s1.view(np.uint32))
    assert m0.keys() == m1.keys() == {"per_member"}
    assert all(torch.equal(m0[k], m1[k]) for k in m0)


# ---------------------------------------------------------------------------
# GAME's fused outer iteration on the card: captured once, replayed
# ---------------------------------------------------------------------------
def _fused_pair(dev, solver: str, l1: float = 0.0, fixed_solver: str = "LBFGS"):
    """Config E's coordinates on ``_game_batches``' card batch, in a fused
    descent and an eager one; ``fixed_solver`` is the fixed effect's."""
    from photon_ml_tpu_torch import config as c
    from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate, RandomEffectCoordinate
    from photon_ml_tpu_torch.game.data import bucket_entities, group_by_entity
    from photon_ml_tpu_torch.game.descent import CoordinateDescent
    from photon_ml_tpu_torch.types import OptimizerType, RegularizationType, TaskType

    data, (gpu, _) = _game_batches(dev)
    task = TaskType.LOGISTIC_REGRESSION
    re_opt = c.OptimizationConfig(
        optimizer=c.OptimizerConfig(optimizer_type=OptimizerType(solver), max_iterations=20, tolerance=1e-3),
        regularization=c.RegularizationContext(RegularizationType.ELASTIC_NET if l1 else RegularizationType.L2,
                                               alpha=0.5),
        regularization_weight=1.0)
    fe_opt = c.OptimizationConfig(optimizer=c.OptimizerConfig(optimizer_type=OptimizerType(fixed_solver),
                                                              max_iterations=20, tolerance=1e-7))

    def coords():
        out = {"fixed": FixedEffectCoordinate("fixed", gpu, "global", fe_opt, task,
                                              intercept_index=data.intercept_index)}
        for k in ("userId", "itemId"):
            g = group_by_entity(data.entity_ids[k])
            out[f"per_{k}"] = RandomEffectCoordinate(f"per_{k}", gpu, f"per_{k}", k, re_opt, g,
                                                     bucket_entities(g, target_buckets=8, max_padded_ratio=0.5),
                                                     task, g.num_entities)
        return out

    seq = ["fixed", "per_userId", "per_itemId"]
    return (CoordinateDescent(coords(), gpu, task), CoordinateDescent(coords(), gpu, task, _fused=False), seq)


@pytest.mark.parametrize("solver,l1,fixed_solver", [
    ("NEWTON_CHOLESKY", 0.0, "LBFGS"), ("LBFGS", 0.0, "LBFGS"), ("LBFGS", 0.5, "LBFGS"), ("TRON", 0.0, "LBFGS"),
    ("TRON", 0.0, "TRON")], ids=["newton", "lbfgs", "owlqn", "tron", "tron_fixed"])
def test_fused_descent_replays_bitwise_the_eager_loop_on_the_card(dev, solver, l1, fixed_solver):
    """Three outer iterations (a chunk of 2, then 1): the first runs eagerly
    as the warm-up, the second is captured and replayed, the third
    replayed; the model, the scores and every fixed-effect tracker are the
    eager loop's bit for bit, and the kernels' launches (counted on the
    device inside the replays) are the fixed effect's objective passes: K1
    alone on L-BFGS; on TRON K1 once a visit and once an iteration, K2
    once a CG step."""
    fused_d, eager_d, seq = _fused_pair(dev, solver, l1, fixed_solver)
    out = {}
    for name, d in (("fused", fused_d), ("eager", eager_d)):
        fused.reset_launch_counts()
        res = d.run(seq, 3)
        torch.cuda.synchronize()
        out[name] = (res, dict(fused.launch_counts))
    (f, f_counts), (e, e_counts) = out["fused"], out["eager"]
    for cid in seq:
        assert torch.equal(f.model[cid].coefficient_means, e.model[cid].coefficient_means), cid
        assert torch.equal(f.training_scores[cid], e.training_scores[cid]), cid
    for a, b in zip(f.trackers["fixed"], e.trackers["fixed"]):
        assert (a.iterations, a.reason, a.objective_passes) == (b.iterations, b.reason, b.objective_passes)
    passes = sum(t.objective_passes for t in f.trackers["fixed"])
    if fixed_solver == "TRON":
        value_grads = sum(1 + t.iterations for t in f.trackers["fixed"])
        assert f_counts == e_counts == {"fused_value_grad": value_grads, "fused_hvp": passes - value_grads}
        assert f_counts["fused_hvp"] > 0
    else:
        assert f_counts == e_counts == {"fused_value_grad": passes, "fused_hvp": 0}
    (outer,) = fused_d._fused_outer_cache.values()
    assert outer._graph is not None and outer._graph.nodes > 0


def _reads_nothing_between_replays(dev, monkeypatch, solver: str, fixed_solver: str = "LBFGS") -> None:
    from chip_smoke import counting_readbacks
    from photon_ml_tpu_torch.ops import graphs

    fused_d, _, seq = _fused_pair(dev, solver, fixed_solver=fixed_solver)
    fused_d.run(seq, 2)  # the warm-up, then the capture and its replay
    captures, replays = [], []
    real_capture, real_replay = graphs.capture, graphs.LoopGraph.replay
    monkeypatch.setattr(graphs, "capture", lambda *a, **k: captures.append(1) or real_capture(*a, **k))
    with counting_readbacks() as reads:
        monkeypatch.setattr(graphs.LoopGraph, "replay", lambda self: replays.append(reads[0]) or real_replay(self))
        fused_d.run(seq, 4)
        torch.cuda.synchronize()
    assert not captures and len(replays) == 4 and len(set(replays)) == 1


def test_fused_descent_reads_nothing_between_replays_and_captures_once(dev, monkeypatch):
    """A second ``run`` replays the first's graph (no capture), and no
    host read of a CUDA tensor happens between a chunk's first replay and
    its last (``chip_smoke.counting_readbacks``)."""
    _reads_nothing_between_replays(dev, monkeypatch, "LBFGS")


def test_fused_descent_on_tron_reads_nothing_between_replays_and_captures_once(dev, monkeypatch):
    """The same with TRON on every coordinate: the CG loops nested in the
    iterations, lanes and fixed effect, are WHILE nodes the device runs."""
    _reads_nothing_between_replays(dev, monkeypatch, "TRON", fixed_solver="TRON")


def test_a_failed_capture_raises(dev, monkeypatch):
    """A visit that reads the card while it is captured fails the run: the
    capture raises, and nothing falls back to the eager loop."""
    from photon_ml_tpu_torch.game.coordinate import RandomEffectCoordinate
    from photon_ml_tpu_torch.ops import graphs

    fused_d, _, seq = _fused_pair(dev, "NEWTON_CHOLESKY")
    score = RandomEffectCoordinate.score

    def reading(self, model):
        out = score(self, model)
        if graphs.capturing():
            float(out.sum())
        return out

    monkeypatch.setattr(RandomEffectCoordinate, "score", reading)
    with pytest.raises(RuntimeError, match="capturing a CUDA graph failed"):
        fused_d.run(seq, 2)

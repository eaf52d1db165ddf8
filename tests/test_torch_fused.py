"""K1 / K2: the port's plain versions of the fused value+gradient and
Hessian-vector passes against the JAX package's Pallas kernels, which run
here in interpret mode as ``tests/test_fused.py`` runs them. The CUDA
kernels themselves run only on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold them against these plain versions)."""

from __future__ import annotations

import math
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
@pytest.mark.parametrize("d", [124, 65])
def test_fused_objective_at_d124_matches_unfused_reference(d, loss, dtype):
    """d = 124 (a9a's 123 features + intercept) and d = 65 (GAME's fixed
    effect: 64 features + intercept) are off the Pallas gate (d % 128 !=
    0), so the JAX package answers through its unfused objective; the
    port's fused objective must agree with it."""
    n = 300
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


# ---------------------------------------------------------------------------
# K1's tiles layout: the plan the kernel and ops/fused.py share
# ---------------------------------------------------------------------------
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_tile_plan_keeps_tiles_aligned_and_in_shared_memory(dtype):
    itemsize = torch.empty((), dtype=dtype).element_size()
    for d in range(1, 257):
        plan = tfused.tile_plan(d, dtype)
        assert plan is not None and plan.layout == "tiles"
        assert plan.rows % 32 == 0 and 32 <= plan.rows <= 1024
        # every tile's X rows, labels, offsets and weights start 16-byte aligned
        assert plan.rows * d * itemsize % 16 == 0 and plan.rows * 4 % 16 == 0
        assert plan.stage_bytes == plan.rows * (d * itemsize + 12) <= 65536
        assert 3 <= plan.stages <= 4 and plan.stages * plan.stage_bytes <= 204800
        assert plan.smem_bytes <= 232_448  # a block's shared memory on an H100
    assert tfused.tile_plan(257, dtype) is None


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_tile_plan_owns_each_column_once_per_partition(dtype):
    for d in (1, 2, 7, 64, 65, 124, 128, 129, 200, 256):
        plan = tfused.tile_plan(d, dtype)
        assert plan.partitions * d <= 256 < (plan.partitions + 1) * d
        owners = [(t // d, t % d) for t in range(plan.partitions * d)]
        for p in range(plan.partitions):
            assert sorted(j for q, j in owners if q == p) == list(range(d))


def _worst_bank_conflict(d: int, itemsize: int, rotation: int) -> list[int]:
    """For each step j of the margin dot: the most distinct 4-byte words a
    warp's 32 threads (rows t = 0..31 of a tile) read from one bank."""
    worst = []
    for j in range(d):
        words_by_bank: dict[int, set] = {}
        for t in range(32):
            col = (t * rotation + j) % d
            word = (t * d + col) * itemsize // 4
            words_by_bank.setdefault(word % 32, set()).add(word)
        worst.append(max(len(w) for w in words_by_bank.values()))
    return worst


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 65, 124, 128])
def test_tile_plan_rotation_avoids_bank_conflicts(d, dtype):
    plan = tfused.tile_plan(d, dtype)
    itemsize = torch.empty((), dtype=dtype).element_size()
    mean = {r: sum(_worst_bank_conflict(d, itemsize, r)) / d for r in range(4)}
    assert max(_worst_bank_conflict(d, itemsize, plan.rotation)) <= 2
    assert mean[plan.rotation] == min(mean.values()) <= 1.5
    if itemsize == 4:  # without the rotation gcd(d, 32) rows share each bank
        assert max(_worst_bank_conflict(d, itemsize, 0)) == math.gcd(d, 32)


def test_vg_plan_keeps_the_glm_shapes_on_the_rows_layout():
    assert tfused.vg_plan(512, torch.bfloat16).layout == "rows"  # the headline
    assert tfused.vg_plan(256, torch.float32).layout == "rows"  # config B
    assert tfused.vg_plan(65, torch.float32).layout == "tiles"  # GAME's fixed effect
    assert tfused.vg_plan(65, torch.float32, aligned=False).layout == "rows"
    for dtype, widest in tfused.TILES_MAX_FEATURES.items():
        assert tfused.vg_plan(widest, dtype).layout == "tiles"
        assert tfused.vg_plan(widest + 1, dtype).layout == "rows"


def test_inputs_aligned():
    x = torch.zeros(64)
    assert tfused.inputs_aligned(x, None, x[4:])
    assert not tfused.inputs_aligned(x, x[1:])


def _tiles_model(X, y, off, wt, u, c, loss, plan, grid):
    """The tiles kernel's schedule in float64: block b takes tiles b,
    b + grid, ...; thread t dots row t of a tile from column
    (t * rotation) mod d around; owner t = p * d + j sums column j over
    the tile's rows p, p + P, ...; the blocks' sums are added at the end.
    Every row and column must be counted exactly once."""
    n, d = X.shape
    R, P = plan.rows, plan.partitions
    xd, ud = X.double(), u.to(X.dtype).double()
    value = r_sum = 0.0
    grad = torch.zeros(d, dtype=torch.float64)
    num_tiles = -(-n // R)
    for b in range(grid):
        for t in range(b, num_tiles, grid):
            rows = min(R, n - t * R)
            tile = xd[t * R: t * R + rows]
            m = torch.zeros(rows, dtype=torch.float64)
            for q in range(rows):
                cols = [(q % 256 * plan.rotation + j) % d for j in range(d)]
                assert sorted(cols) == list(range(d))
                m[q] = float((tile[q, cols] * ud[cols]).sum())
            m = m.float() - c
            if off is not None:
                m = m + off[t * R: t * R + rows]
            lv, r = loss.value(m, y[t * R: t * R + rows]), loss.d1(m, y[t * R: t * R + rows])
            if wt is not None:
                w = wt[t * R: t * R + rows]
                lv, r = torch.where(w != 0, w * lv, 0.0), torch.where(w != 0, w * r, 0.0)
            value += float(lv.double().sum())
            r_sum += float(r.double().sum())
            rb = r.to(X.dtype).double()
            for owner in range(P * d):
                p, j = divmod(owner, d)
                grad[j] += float((rb[p::P] * tile[p::P, j]).sum())
    return torch.tensor(value).float(), grad.float(), torch.tensor(r_sum).float()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [5, 64, 65])
def test_tiles_schedule_model_matches_the_plain_version(d, dtype):
    """The schedule of ``vg_tiles_kernel`` with the plan ``tile_plan``
    gives, over seven blocks and a ragged last tile, the plain version's
    sums: each row's margin and each column's sum take every element once."""
    tdt = getattr(torch, dtype)
    plan = tfused.tile_plan(d, tdt)
    n = 2 * plan.rows + 37
    X, y, off, wt, u, *_ = _case(d, n, d, "logistic", with_aux=True)
    args = (_torch(X, tdt), _torch(y), _torch(off), _torch(wt), _torch(u), 0.3)
    got = _tiles_model(*args, TLOSSES["logistic"], plan, grid=3)
    ref = tfused.fused_value_grad_reference(*args, loss=TLOSSES["logistic"])
    torch.testing.assert_close(got[0], ref[0], rtol=1e-6, atol=0.0)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[2], ref[2], rtol=1e-6, atol=1e-6)


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
    # K1's layouts and the tiles layout's geometry
    for name, layout_id in (("kLayoutRows", 0), ("kLayoutTiles", 1)):
        assert tfused.LAYOUTS[name.removeprefix("kLayout").lower()] == layout_id
        assert re.search(rf"\b{name} = {layout_id}\b", src)
    assert re.search(r"\bkLayoutAuto = -1\b", src)
    constants = {
        "kTilesMaxFeaturesF32": tfused.TILES_MAX_FEATURES[torch.float32],
        "kTilesMaxFeaturesBf16": tfused.TILES_MAX_FEATURES[torch.bfloat16],
        "kStageBytes": tfused._STAGE_BYTES, "kTileMaxRows": tfused._TILE_MAX_ROWS,
        "kRingBytes": tfused._RING_BYTES, "kMaxStages": tfused._MAX_STAGES,
        "kAuxBytesPerRow": tfused._AUX_BYTES_PER_ROW, "kWarps": tfused._THREADS // 32,
    }
    for name, value in constants.items():
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert '#include "ring.cuh"' in src
    # the C entries the wrappers call, with the argument counts _cuda.load declares
    for entry, count in (("photon_fused_vg", 16), ("photon_fused_vg_layout", 17),
                         ("photon_fused_hvp", 19)):
        body = re.search(rf"\bint {entry}\(([^)]*)\)", src)
        assert body and body.group(1).count(",") + 1 == count, entry


def test_kernel_headers_feed_the_library_name(monkeypatch, tmp_path):
    from photon_ml_tpu_torch.ops import _cuda

    assert [h.name for h in _cuda.HEADERS] == ["ring.cuh"]
    before = _cuda.library_path()
    edited = tmp_path / "ring.cuh"
    edited.write_text(_cuda.HEADERS[0].read_text() + "\n// edited\n")
    monkeypatch.setattr(_cuda, "HEADERS", (edited,))
    assert _cuda.library_path() != before


# ---------------------------------------------------------------------------
# K2's schedule (``hvp_kernel``, then ``reduce_partials``)
# ---------------------------------------------------------------------------
def _rows_lanes(d: int, itemsize: int) -> list[list[int]]:
    """Each lane's columns in the rows layout: ``by_layout`` / ``by_width``
    pick 16-byte vectors of VEC elements where d is a multiple of VEC (X
    taken as aligned) and the fewest NV vectors a lane that reach d; lane l
    holds columns (k·32 + l)·VEC + e for k < NV, e < VEC, those below d."""
    wide = 16 // itemsize
    vec = wide if d % wide == 0 else 1
    nvs = (8, 32) if vec == 1 else (1, 2, 4) if vec == 8 else (1, 2, 4, 8)
    nv = next(k for k in nvs if d <= 32 * vec * k)
    return [[j for k in range(nv) for e in range(vec) if (j := (k * 32 + lane) * vec + e) < d]
            for lane in range(32)]


def _hvp_rows_model(X, y, off, wt, u, v, c, cv, loss, grid):
    """The rows kernel's schedule in float64: warp w of block b (W = 8·grid
    warps) takes rows 8b + w, 8b + w + W, ...; each lane dots its columns
    (``_rows_lanes``) and the butterfly adds the lanes; q in float32 (rounded
    to the storage type for Xᵀq); the warps of a block add into its row of
    partials in warp order; ``reduce_partials`` sums column j as 256
    threads, thread t over blocks t, t + 256, ..., then a halving tree.
    Every row and column must be counted exactly once."""
    n, d = X.shape
    lanes = _rows_lanes(d, X.element_size())
    assert sorted(j for cols in lanes for j in cols) == list(range(d))
    warps = 8 * grid
    xd, ud, vd = X.double(), u.to(X.dtype).double(), v.to(X.dtype).double()
    lane_of = torch.zeros((d, 32), dtype=torch.float64)
    for lane, cols in enumerate(lanes):
        lane_of[cols, lane] = 1.0
    du = ((xd * ud) @ lane_of).sum(1)  # each lane's partial dot, then the butterfly
    dv = ((xd * vd) @ lane_of).sum(1)
    m = du.float() - c
    if off is not None:
        m = m + off
    d2 = loss.d2(m, y)
    if wt is not None:
        d2 = torch.where(wt != 0, wt * d2, 0.0)
    q = d2 * (dv.float() - cv)
    rows = torch.cat([xd * q.to(X.dtype).double()[:, None], q.double()[:, None]], 1)
    per_warp = torch.zeros((warps, d + 1), dtype=torch.float64)
    per_warp.index_add_(0, torch.arange(n) % warps, rows)
    part = torch.zeros((grid, d + 1), dtype=torch.float64)
    for w in range(8):  # warp order within each block
        part += per_warp[w::8]
    threads = torch.zeros((256, d + 1), dtype=torch.float64)
    for t in range(min(256, grid)):
        for g in range(t, grid, 256):
            threads[t] += part[g]
    o = 128
    while o > 0:
        threads[:o] += threads[o:2 * o]
        o //= 2
    return threads[0, :d].float(), threads[0, d].float()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_rows_lanes_take_each_column_once(dtype):
    """At every width the lanes' columns cover the row once, at most 32 a
    lane (the kernel's register arrays)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    for d in range(1, tfused.MAX_FEATURES + 1):
        lanes = _rows_lanes(d, itemsize)
        assert sorted(j for cols in lanes for j in cols) == list(range(d))
        assert max(len(cols) for cols in lanes) <= 32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_aux", [False, True], ids=["no_aux", "aux"])
@pytest.mark.parametrize("d", [1, 7, 65, 124, 256, 300])
@pytest.mark.parametrize("loss", LOSS_NAMES)
def test_hvp_rows_schedule_model_matches_plain_and_pallas(loss, d, with_aux, dtype):
    """The schedule of ``hvp_kernel`` over the grid the launch path gives
    n = 4091 rows (one block per 128 rows: 32 blocks, 16 rows a warp) gives
    the plain version's sums (each row's dots and each column's sum take
    every element once) and the JAX package's Pallas kernel's, at
    tests/test_fused.py's tolerances."""
    n = 4091
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    X, y, off, wt, u, v, c, cv = _case(d + 1000 * with_aux, n, d, loss, with_aux)
    u = (u / max(1.0, math.sqrt(d) / 4)).astype(np.float32)  # margins of order one at every width
    v = (v / math.sqrt(d)).astype(np.float32)
    targs = (_torch(X, tdt), _torch(y), _torch(off), _torch(wt), _torch(u), _torch(v), float(c), float(cv))
    got = _hvp_rows_model(*targs, TLOSSES[loss], grid=-(-n // 128))
    ref = tfused.fused_hvp_reference(*targs, loss=TLOSSES[loss])
    torch.testing.assert_close(got[0], ref[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-6, atol=1e-6)
    jh, jq = jfused.fused_hvp(_jax(X, jdt), _jax(y), _jax(off), _jax(wt), _jax(u), _jax(v), c, cv,
                              loss=JLOSSES[loss], interpret=True)
    tol = TOL[dtype]["grad"]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jh), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(got[1]), float(jq), rtol=tol, atol=tol)

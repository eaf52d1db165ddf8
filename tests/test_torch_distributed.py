"""Data-parallel GLM training on row shards: the port's ``parallel/``
against the JAX package's, as ``tests/test_distributed.py`` holds the
reference's sharded solve to its single-node one. The reference runs on
its 8-device virtual CPU mesh (conftest), the port on 8 shards over the
CPU device (``data_mesh(8, devices=["cpu"])``); n = 333 is not a
multiple of 8, so every sharded batch carries padding rows.

Held to (the port is float32, so the JAX side runs on float32 arrays):
- solves: the same ``ConvergenceReason``, objective within rtol 1e-5 and
  coefficients within rtol = atol = 1e-4 of the reference's sharded solve
  (``tests/test_torch_optim.py``'s tolerances, stopping at 1e-3 above the
  float32 resolution of the logistic objective);
- contracts: against the reference's ``shard_map`` objective and the
  port's unsharded objective at rtol 1e-5 (values) / atol 1e-4 relative to
  the vector's scale (vectors), float32 sums in another order;
- one shard: bitwise the unsharded objective and solve; a repeated
  sharded solve: bitwise;
- the tiled branch: the reference's interpret-mode Pallas per-shard solve
  against the port's per-shard K3 plain version, coefficients within
  rtol = atol = 1e-4 after 6 L-BFGS iterations at tolerance 0.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.config import OptimizerConfig as JConfig
from photon_ml_tpu.normalization import build_normalization as j_build_normalization
from photon_ml_tpu.ops.batch import SparseBatch as JSparseBatch
from photon_ml_tpu.ops.batch import dense_batch_from_numpy as j_dense
from photon_ml_tpu.ops.batch import pad_batch as j_pad_batch
from photon_ml_tpu.ops.glm import GaussianPrior as JPrior
from photon_ml_tpu.ops.glm import make_objective as j_make_objective
from photon_ml_tpu.ops.losses import LOSSES as J_LOSSES
from photon_ml_tpu.parallel import DistributedTrainer as JTrainer
from photon_ml_tpu.parallel import data_mesh as j_data_mesh
from photon_ml_tpu.parallel import shard_batch as j_shard_batch
from photon_ml_tpu.types import NormalizationType as JNorm
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.convert import dense_batch_from_numpy, sparse_batch_from_numpy
from photon_ml_tpu_torch.normalization import build_normalization
from photon_ml_tpu_torch.ops import sparse_tiled
from photon_ml_tpu_torch.ops.batch import DenseBatch, pad_batch
from photon_ml_tpu_torch.ops.glm import GaussianPrior, make_objective
from photon_ml_tpu_torch.ops.losses import LOSSES
from photon_ml_tpu_torch.optim import lbfgs_minimize, owlqn_minimize, tron_minimize
from photon_ml_tpu_torch.optim.newton import newton_minimize
from photon_ml_tpu_torch.parallel import (
    DistributedTrainer,
    data_mesh,
    shard_batch,
    sharded_minimize,
    sharded_objective,
)
from photon_ml_tpu_torch.parallel.distributed import _densify_sharded
from photon_ml_tpu_torch.types import NormalizationType, OptimizerType

CPU8 = data_mesh(8, devices=["cpu"])
L1, L2, INTERCEPT = 2.0, 0.5, 5


def _problem(seed: int = 42, n: int = 333, d: int = 6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, -1] = 1.0
    w_true = rng.normal(size=d)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-X @ w_true))).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    return X, y, wt


def _vec_close(got, want, rtol=1e-5, atol=1e-4):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(want).max())))


def test_data_mesh_places_shards_round_robin(monkeypatch):
    assert data_mesh(5, devices=["cpu", "meta"]) == tuple(
        torch.device(d) for d in ("cpu", "meta", "cpu", "meta", "cpu"))
    assert data_mesh(devices=["cpu"]) == (torch.device("cpu"),)
    assert len(CPU8) == 8
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        data_mesh(2)
    with pytest.raises(ValueError, match="positive"):
        data_mesh(0, devices=["cpu"])


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_pad_batch_matches_the_reference(kind):
    X, y, wt = _problem(n=13)
    if kind == "dense":
        port = dense_batch_from_numpy(X, y, weights=wt, device="cpu")
        ref = j_dense(X, y, weights=wt)
        names = ("X", "labels", "offsets", "weights")
    else:
        idx = np.tile(np.arange(3), (13, 1))
        port = sparse_batch_from_numpy(idx, X[:, :3], y, weights=wt, num_features=6, device="cpu")
        ref = JSparseBatch(indices=jnp.asarray(idx, jnp.int32), values=jnp.asarray(X[:, :3]),
                           labels=jnp.asarray(y), offsets=jnp.zeros(13, jnp.float32),
                           weights=jnp.asarray(wt), num_features=6)
        names = ("indices", "values", "labels", "offsets", "weights")
    got, want = pad_batch(port, 16), j_pad_batch(ref, 16)
    for name in names:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    assert pad_batch(port, 13) is port
    with pytest.raises(ValueError, match="rows > target"):
        pad_batch(port, 12)


_REF_SOLVES: dict = {}


def _reference_solve(opt: str):
    """The JAX package's ``DistributedTrainer`` on its 8-device mesh."""
    if opt not in _REF_SOLVES:
        X, y, wt = _problem()
        cfg = JConfig(optimizer_type=JOpt.TRON if opt == "tron" else JOpt.LBFGS, max_iterations=100,
                      tolerance=1e-3)
        trainer = JTrainer(mesh=j_data_mesh(), config=cfg, loss=J_LOSSES["logistic"], l2_weight=L2,
                           l1_weight=L1 if opt == "owlqn" else 0.0, intercept_index=INTERCEPT)
        res = trainer.train(j_dense(X, y, weights=wt), jnp.zeros(6, jnp.float32))
        _REF_SOLVES[opt] = (int(res.reason), float(res.value), np.asarray(res.w))
    return _REF_SOLVES[opt]


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("opt", ["lbfgs", "tron", "owlqn"])
def test_sharded_minimize_matches_the_reference(opt, fused):
    """``fused`` runs K1 / K2's plain versions on every shard, each given
    its weights (the padding rows must read weight 0)."""
    X, y, wt = _problem()
    cfg = OptimizerConfig(optimizer_type=OptimizerType.TRON if opt == "tron" else OptimizerType.LBFGS,
                          max_iterations=100, tolerance=1e-3)
    batch = dense_batch_from_numpy(X, y, weights=wt, device="cpu")
    if fused:
        fn = tron_minimize if opt == "tron" else lbfgs_minimize
        res = sharded_minimize(owlqn_minimize if opt == "owlqn" else fn, batch, torch.zeros(6), cfg, CPU8,
                               LOSSES["logistic"], l2_weight=L2, intercept_index=INTERCEPT,
                               l1_weight=L1 if opt == "owlqn" else None, fused=True)
    else:
        trainer = DistributedTrainer(mesh=CPU8, config=cfg, loss=LOSSES["logistic"], l2_weight=L2,
                                     l1_weight=L1 if opt == "owlqn" else 0.0, intercept_index=INTERCEPT)
        res = trainer.train(batch, torch.zeros(6))
    reason, value, w = _reference_solve(opt)
    assert res.reason == reason
    np.testing.assert_allclose(float(res.value), value, rtol=1e-5)
    np.testing.assert_allclose(res.w.numpy(), w, rtol=1e-4, atol=1e-4)
    # and the port's own unsharded solve
    single = make_objective(dense_batch_from_numpy(X, y, weights=wt, device="cpu"), LOSSES["logistic"],
                            l2_weight=L2, intercept_index=INTERCEPT, fused=fused, device="cpu")
    fn = {"lbfgs": lbfgs_minimize, "tron": tron_minimize, "owlqn": owlqn_minimize}[opt]
    extra = {"l1_weight": L1} if opt == "owlqn" else {}
    one = fn(single, torch.zeros(6), cfg, **extra)
    np.testing.assert_allclose(res.w.numpy(), one.w.numpy(), rtol=1e-4, atol=1e-4)


def _contract_case(case: str):
    X, y, wt = _problem(seed=3, n=100)
    norm = prior = j_norm = j_prior = None
    if case == "normalized_prior":
        mean, var = X.mean(0), X.var(0)
        mag = np.abs(X).max(0)
        norm = build_normalization(NormalizationType.STANDARDIZATION, mean, var, mag, INTERCEPT, device="cpu")
        j_norm = j_build_normalization(JNorm.STANDARDIZATION, mean, var, mag, INTERCEPT)
        rng = np.random.default_rng(9)
        mu, pv = rng.normal(size=6).astype(np.float32), rng.uniform(0.2, 2.0, size=6).astype(np.float32)
        prior = GaussianPrior(means=torch.as_tensor(mu), variances=torch.as_tensor(pv))
        j_prior = JPrior(means=jnp.asarray(mu), variances=jnp.asarray(pv))
    return X, y, wt, norm, prior, j_norm, j_prior


@pytest.mark.parametrize("case", ["plain", "normalized_prior"])
def test_sharded_objective_contracts_match_the_reference(case):
    """``value`` / ``value_and_grad`` / ``hvp`` / ``hessian_diag`` /
    ``hessian`` of 8 shards against the reference's objective under
    ``shard_map`` (its ``psum``) and the port's unsharded objective; with
    a normalization and a Gaussian prior the regularizer is added once."""
    from jax.sharding import PartitionSpec as P

    from photon_ml_tpu.utils import compat

    X, y, wt, norm, prior, j_norm, j_prior = _contract_case(case)
    rng = np.random.default_rng(11)
    w, v = rng.normal(size=6).astype(np.float32), rng.normal(size=6).astype(np.float32)
    loss = "poisson"
    batch = dense_batch_from_numpy(X, y, weights=wt, device="cpu")
    obj = sharded_objective(batch, CPU8, LOSSES[loss], l2_weight=0.1, norm=norm, intercept_index=INTERCEPT,
                            prior=prior)
    single = make_objective(batch, LOSSES[loss], l2_weight=0.1, norm=norm, intercept_index=INTERCEPT,
                            prior=prior, device="cpu")
    mesh = j_data_mesh()

    def compute(b, w, v):
        o = j_make_objective(b, J_LOSSES[loss], l2_weight=0.1, norm=j_norm, intercept_index=INTERCEPT,
                             axis_name="data", prior=j_prior)
        f, g = o.value_and_grad(w)
        return o.value(w), f, g, o.hvp(w, v), o.hessian_diag(w), o.hessian(w)

    ref = jax.jit(compat.shard_map(compute, mesh=mesh, in_specs=(P("data"), P(), P()), out_specs=P(),
                                   check_vma=False))(j_shard_batch(j_dense(X, y, weights=wt), mesh),
                                                     jnp.asarray(w), jnp.asarray(v))
    tw, tv = torch.as_tensor(w), torch.as_tensor(v)
    f, g = obj.value_and_grad(tw)
    got = (obj.value(tw), f, g, obj.hvp(tw, tv), obj.hessian_diag(tw), obj.hessian(tw))
    f1, g1 = single.value_and_grad(tw)
    one = (single.value(tw), f1, g1, single.hvp(tw, tv), single.hessian_diag(tw), single.hessian(tw))
    for name, a, r, s in zip(("value", "vg_value", "grad", "hvp", "hessian_diag", "hessian"), got, ref, one):
        if a.dim() == 0:
            np.testing.assert_allclose(float(a), float(r), rtol=1e-5, err_msg=name)
            np.testing.assert_allclose(float(a), float(s), rtol=1e-5, err_msg=name)
        else:
            _vec_close(a.numpy(), r)
            _vec_close(a.numpy(), s.numpy())


def test_sharded_margin_api_keeps_one_margin_tensor_per_shard():
    X, y, wt, norm, prior, _, _ = _contract_case("normalized_prior")
    batch = dense_batch_from_numpy(X, y, weights=wt, device="cpu")
    obj = sharded_objective(batch, CPU8, LOSSES["logistic"], l2_weight=0.3, norm=norm,
                            intercept_index=INTERCEPT, prior=prior)
    single = make_objective(batch, LOSSES["logistic"], l2_weight=0.3, norm=norm, intercept_index=INTERCEPT,
                            prior=prior, device="cpu")
    rng = np.random.default_rng(12)
    w, p = torch.as_tensor(rng.normal(size=6).astype(np.float32)), torch.as_tensor(rng.normal(size=6).astype(np.float32))
    m = obj.margins(w)
    assert isinstance(m, tuple) and len(m) == 8 and all(mi.shape == (13,) for mi in m)  # 104 rows / 8
    torch.testing.assert_close(torch.cat(m)[:100], single.margins(w), rtol=1e-5, atol=1e-5)
    f, g = obj.value_and_grad_from_margins(m, w)
    f2, g2 = obj.value_and_grad(w)
    assert torch.equal(f, f2) and torch.equal(g, g2)
    assert torch.equal(obj.hessian_from_margins(m, w), obj.hessian(w))
    ts = torch.tensor([0.0, 0.5, 1.0])
    rays = obj.ray_values(w, p, ts)
    torch.testing.assert_close(rays, single.ray_values(w, p, ts), rtol=1e-5, atol=0.0)
    torch.testing.assert_close(rays[1], obj.value(w + 0.5 * p), rtol=1e-5, atol=0.0)
    torch.testing.assert_close(obj.direction_margins(p)[3], single.direction_margins(p)[39:52])


@pytest.mark.parametrize("given", [True, False], ids=["weights_given", "weights_absent"])
def test_padding_rows_are_inert(given):
    """333 rows over 8 shards pad 3 zero-weight rows in. With all-ones
    weights the fused objective would skip reading them (the weights
    hint); padding turns the hint off so K1's plain version reads each
    shard's weights, and the sums equal the unsharded ones."""
    X, y, wt = _problem()
    batch = dense_batch_from_numpy(X, y, weights=wt if given else None, device="cpu")
    obj = sharded_objective(batch, CPU8, LOSSES["logistic"], l2_weight=L2, intercept_index=INTERCEPT, fused=True)
    assert all(o.fused and not o.weights_one for o in obj.shards)
    assert sum(o.batch.num_rows for o in obj.shards) == 336 and float(obj.shards[-1].batch.weights[-3:].abs().sum()) == 0.0
    single = make_objective(batch, LOSSES["logistic"], l2_weight=L2, intercept_index=INTERCEPT, fused=True,
                            device="cpu")
    assert single.weights_one is (not given)
    w = torch.as_tensor(np.random.default_rng(2).normal(size=6).astype(np.float32))
    f, g = obj.value_and_grad(w)
    f1, g1 = single.value_and_grad(w)
    np.testing.assert_allclose(float(f), float(f1), rtol=1e-6)
    _vec_close(g.numpy(), g1.numpy(), atol=1e-5)
    _vec_close(obj.hvp(w, w).numpy(), single.hvp(w, w).numpy(), atol=1e-5)
    # and on 333 = 3 x 111 rows, no padding: the hint holds on every shard
    even = sharded_objective(batch, data_mesh(3, devices=["cpu"]), LOSSES["logistic"], fused=True)
    assert all(o.weights_one is (not given) for o in even.shards)


def test_one_shard_is_bitwise_the_unsharded_objective():
    X, y, wt, norm, prior, _, _ = _contract_case("normalized_prior")
    batch = dense_batch_from_numpy(X, y, weights=wt, device="cpu")
    for fused in (False, True):
        kw = dict(l2_weight=0.3, norm=norm, intercept_index=INTERCEPT, prior=prior, fused=fused)
        obj = sharded_objective(batch, data_mesh(1, devices=["cpu"]), LOSSES["logistic"], **kw)
        single = make_objective(batch, LOSSES["logistic"], device="cpu", **kw)
        w = torch.as_tensor(np.random.default_rng(4).normal(size=6).astype(np.float32))
        for a, b in ((obj.value_and_grad(w), single.value_and_grad(w)), ((obj.hvp(w, w),), (single.hvp(w, w),)),
                     ((obj.hessian_diag(w),), (single.hessian_diag(w),)), ((obj.value(w),), (single.value(w),))):
            assert all(torch.equal(x, z) for x, z in zip(a, b))
        cfg = OptimizerConfig(max_iterations=50, tolerance=1e-6)
        r1, r2 = lbfgs_minimize(obj, torch.zeros(6), cfg), lbfgs_minimize(single, torch.zeros(6), cfg)
        assert torch.equal(r1.w, r2.w) and r1.iterations == r2.iterations


def test_sharded_solve_repeats_bitwise():
    X, y, wt = _problem()
    batch = dense_batch_from_numpy(X, y, weights=wt, device="cpu")
    cfg = OptimizerConfig(optimizer_type=OptimizerType.TRON, max_iterations=30, tolerance=1e-7)
    runs = [sharded_minimize(tron_minimize, batch, torch.zeros(6), cfg, CPU8, LOSSES["logistic"], l2_weight=L2,
                             fused=True) for _ in range(2)]
    assert torch.equal(runs[0].w, runs[1].w) and torch.equal(runs[0].value, runs[1].value)
    assert runs[0].objective_passes == runs[1].objective_passes


def test_shard_batch_splits_contiguous_rows():
    X, y, wt = _problem(n=10)
    batch = dense_batch_from_numpy(X, y, weights=wt, device="cpu")
    shards = shard_batch(batch, data_mesh(4, devices=["cpu"]))
    assert [s.num_rows for s in shards] == [3, 3, 3, 3]
    np.testing.assert_array_equal(torch.cat([s.X for s in shards])[:10].numpy(), X)
    assert shards[-1].weights[-2:].tolist() == [0.0, 0.0]
    # rows that divide the shard count need no padding: each shard is a view
    X, y, wt = _problem(n=12)
    batch = dense_batch_from_numpy(X, y, weights=wt, device="cpu")
    shards = shard_batch(batch, data_mesh(4, devices=["cpu"]))
    assert [s.X.data_ptr() for s in shards] == [batch.X[3 * i:].data_ptr() for i in range(4)]
    idx, val, y = _sparse(12, 8, 2, seed=1)
    tiled = sparse_tiled.tile_sparse_batch(sparse_batch_from_numpy(idx, val, y, num_features=8, device="cpu"))
    with pytest.raises(TypeError, match="DenseBatch or a SparseBatch"):
        shard_batch(tiled, data_mesh(4, devices=["cpu"]))


def _sparse(n, d, k, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
    val = rng.normal(size=(n, k)).astype(np.float32)
    w_true = (rng.normal(size=d) * 0.3).astype(np.float32)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(val * w_true[idx]).sum(1)))).astype(np.float32)
    return idx, val, y


def test_sparse_batch_densifies_shard_by_shard(monkeypatch):
    """Dense bytes over one card's budget but within the mesh's cards: each
    shard densifies on its own (the reference's ``_densify_sharded``), and
    the solve matches the single-device sparse objective."""
    import photon_ml_tpu.ops.streaming as j_streaming
    from photon_ml_tpu.parallel.distributed import _densify_sharded as j_densify_sharded

    import photon_ml_tpu_torch.ops.streaming as streaming

    idx, val, y = _sparse(160, 16, 3, seed=5)
    port = sparse_batch_from_numpy(idx, val, y, num_features=16, device="cpu")
    ref = JSparseBatch(indices=jnp.asarray(idx), values=jnp.asarray(val), labels=jnp.asarray(y),
                       offsets=jnp.zeros(160, jnp.float32), weights=jnp.ones(160, jnp.float32), num_features=16)
    monkeypatch.setattr(j_streaming, "device_hbm_budget_bytes", lambda *a, **k: 4096.0)
    want = np.asarray(j_densify_sharded(ref, j_data_mesh(), "data").X)
    shards = _densify_sharded(port, CPU8)
    assert all(isinstance(s, DenseBatch) for s in shards)
    np.testing.assert_array_equal(torch.cat([s.X for s in shards]).numpy(), want)
    # 160 x 16 x 4 = 10240 bytes: over one "card" of 4096, within eight
    import photon_ml_tpu_torch.parallel.distributed as distributed

    monkeypatch.setattr(streaming, "device_hbm_budget_bytes", lambda *a, **k: 4096.0)
    monkeypatch.setattr(distributed, "_mesh_budget_bytes", lambda mesh: 8 * 4096.0)
    calls = []
    monkeypatch.setattr(distributed, "_densify_sharded", lambda b, m: calls.append(m) or _densify_sharded(b, m))
    obj = sharded_objective(port, CPU8, LOSSES["logistic"], l2_weight=0.5)
    assert calls == [CPU8] and all(isinstance(o.batch, DenseBatch) for o in obj.shards)
    cfg = OptimizerConfig(max_iterations=60, tolerance=1e-6)
    res = lbfgs_minimize(obj, torch.zeros(16), cfg)
    one = lbfgs_minimize(make_objective(port, LOSSES["logistic"], l2_weight=0.5, device="cpu"), torch.zeros(16), cfg)
    np.testing.assert_allclose(float(res.value), float(one.value), rtol=1e-5)
    np.testing.assert_allclose(res.w.numpy(), one.w.numpy(), rtol=5e-3, atol=5e-4)


@pytest.mark.kernel
def test_sparse_tiled_branch_matches_the_reference(monkeypatch):
    """A sparse batch over every budget takes one K3 layout per shard
    (``tile_sparse_batch_sharded``); its solve against the reference's
    per-shard tile-COO solve, whose Pallas kernel runs in interpret mode."""
    import photon_ml_tpu.ops.streaming as j_streaming
    from photon_ml_tpu.optim import lbfgs_minimize as j_lbfgs
    from photon_ml_tpu.parallel.distributed import sharded_minimize as j_sharded_minimize

    import photon_ml_tpu_torch.ops.streaming as streaming

    n, d, k = 2048, 4096, 4
    idx, val, y = _sparse(n, d, k, seed=6)
    monkeypatch.setattr(j_streaming, "device_hbm_budget_bytes", lambda *a, **kw: 1.0)
    monkeypatch.setattr(streaming, "device_hbm_budget_bytes", lambda *a, **kw: 1.0)
    ref_batch = JSparseBatch(indices=jnp.asarray(idx), values=jnp.asarray(val), labels=jnp.asarray(y),
                             offsets=jnp.zeros(n, jnp.float32), weights=jnp.ones(n, jnp.float32), num_features=d)
    ref = j_sharded_minimize(j_lbfgs, ref_batch, jnp.zeros(d, jnp.float32), JConfig(max_iterations=6, tolerance=0.0),
                             j_data_mesh(8), J_LOSSES["logistic"], l2_weight=1.0)
    port = sparse_batch_from_numpy(idx, val, y, num_features=d, device="cpu")
    obj = sharded_objective(port, CPU8, LOSSES["logistic"], l2_weight=1.0)
    assert all(isinstance(o.batch, sparse_tiled.TiledSparseBatch) for o in obj.shards)
    assert [o.batch.num_rows for o in obj.shards] == [256] * 8
    res = lbfgs_minimize(obj, torch.zeros(d), OptimizerConfig(max_iterations=6, tolerance=0.0))
    assert res.iterations == int(ref.iterations) == 6
    np.testing.assert_allclose(float(res.value), float(ref.value), rtol=1e-5)
    np.testing.assert_allclose(res.w.numpy(), np.asarray(ref.w), rtol=1e-4, atol=1e-4)
    shards, rows = sparse_tiled.tile_sparse_batch_sharded(port, 3)
    assert rows == 683 and [s.num_rows for s in shards] == [683] * 3
    assert float(shards[-1].weights[-1]) == 0.0 and shards[-1].m.write_len == 683


def test_newton_is_refused_on_shards():
    X, y, wt = _problem()
    batch = dense_batch_from_numpy(X, y, weights=wt, device="cpu")
    with pytest.raises(NotImplementedError, match="NEWTON_CHOLESKY"):
        sharded_minimize(newton_minimize, batch, torch.zeros(6), OptimizerConfig(), CPU8, LOSSES["logistic"])

"""Evaluators: the port's ``make_evaluator`` metrics against the JAX
package's on the same numpy fixtures, to 1e-6.

- The six scalar evaluators (AUC, RMSE and the four mean losses) on scores
  with ties, with zero weights and with no weights.
- ``MULTI_AUC(tag)`` and ``PRECISION_AT_K(k,tag)``: the port's device
  versions against the reference's host and device versions and against
  the port's own numpy copy of the host versions, with ties, zero
  weights (which per-group metrics ignore), single-class groups, groups
  absent from the ids (empty), and unseen-entity rows (id -1, left out).
- ``BUCKETED_AUC[(n)]``: the reference's quantization, so the same bins;
  exact against the rank-sum AUC when every bin holds one distinct score.
- Parsing: names, cut-offs, tags, ``larger_is_better``, and the errors for
  a missing tag and an unknown spec."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.evaluation import evaluators as jev
from photon_ml_tpu.evaluation import scalable as jsc
from photon_ml_tpu_torch.evaluation import (
    auc_roc,
    bucketed_auc,
    evaluate_all,
    grouped_auc,
    grouped_auc_device,
    grouped_precision_at_k,
    grouped_precision_at_k_device,
    make_evaluator,
)
from photon_ml_tpu_torch.evaluation.scalable import _score_histograms

SCALARS = ["AUC", "RMSE", "LOGISTIC_LOSS", "POISSON_LOSS", "SQUARED_LOSS", "SMOOTHED_HINGE_LOSS"]


def _scores(seed: int, n: int, ties: bool):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=n).astype(np.float32)
    if ties:
        s = np.round(s * 4) / 4  # a few dozen distinct values
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-2 * s))).astype(np.float32)
    return rng, s, y


@pytest.mark.parametrize("weights", ["none", "zeros", "uniform"])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("spec", SCALARS)
def test_scalar_evaluators_match_reference(spec, ties, weights):
    rng, s, y = _scores(1, 500, ties)
    if spec in ("RMSE", "SQUARED_LOSS"):
        y = (s + rng.normal(size=500)).astype(np.float32)
    elif spec == "POISSON_LOSS":
        y = rng.poisson(np.exp(s)).astype(np.float32)
    w = None
    if weights == "zeros":
        w = (rng.uniform(size=500) < 0.7).astype(np.float32)
    elif weights == "uniform":
        w = rng.uniform(0.5, 2.0, size=500).astype(np.float32)
    want = jev.make_evaluator(spec)(jnp.asarray(s), jnp.asarray(y),
                                    None if w is None else jnp.asarray(w))
    ev = make_evaluator(spec.lower())
    assert ev.name == spec and ev.larger_is_better == (spec == "AUC")
    got = ev(torch.as_tensor(s), torch.as_tensor(y), None if w is None else torch.as_tensor(w))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-6)


def _groups(seed: int, n: int = 400, G: int = 30, ties: bool = True):
    """Scores, labels, zero-and-positive weights and group ids: a few
    groups of one class, ids with gaps (groups absent from the data), and
    some unseen-entity rows (id -1)."""
    rng, s, y = _scores(seed, n, ties)
    g = rng.integers(0, G, size=n).astype(np.int64) * 3  # gaps: absent groups
    y[g == 0] = 1.0  # a single-class group
    y[g == 3] = 0.0  # and another
    g[rng.uniform(size=n) < 0.05] = -1
    w = (rng.uniform(size=n) < 0.8).astype(np.float32)
    return s, y, w, g


def _dense(g: np.ndarray):
    keep = g >= 0
    uniq, dense = np.unique(g[keep], return_inverse=True)
    return keep, dense, len(uniq)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("seed", [2, 3])
def test_multi_auc_matches_reference(seed, ties):
    s, y, w, g = _groups(seed, ties=ties)
    keep, dense, G = _dense(g)
    ref_host = jev.grouped_auc(s[keep], y[keep], dense)
    ref_device = float(jsc.grouped_auc_device(jnp.asarray(s[keep]), jnp.asarray(y[keep]),
                                              jnp.asarray(dense.astype(np.int32)), G))
    ref = jev.make_evaluator("MULTI_AUC(userId)")(jnp.asarray(s), jnp.asarray(y), jnp.asarray(w),
                                                   {"userId": g})
    ev = make_evaluator("MULTI_AUC(userId)")
    assert (ev.name, ev.group_by, ev.larger_is_better) == ("MULTI_AUC(userId)", "userId", True)
    got = ev(torch.as_tensor(s), torch.as_tensor(y), torch.as_tensor(w), {"userId": torch.as_tensor(g)})
    for want in (ref_host, ref_device, ref, grouped_auc(s[keep], y[keep], g[keep])):
        assert got == pytest.approx(want, abs=1e-6)
    # the device function with groups that hold no row (num_groups above
    # the ids present)
    t = torch.as_tensor
    padded = grouped_auc_device(t(s[keep]), t(y[keep]), t(dense), G + 5)
    assert float(padded) == pytest.approx(ref_host, abs=1e-6)


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_precision_at_k_matches_reference(ties, k):
    s, y, w, g = _groups(4, ties=ties)
    keep, dense, G = _dense(g)
    ref_host = jev.grouped_precision_at_k(s[keep], y[keep], dense, k)
    ref_device = float(jsc.grouped_precision_at_k_device(
        jnp.asarray(s[keep]), jnp.asarray(y[keep]), jnp.asarray(dense.astype(np.int32)), k, G))
    spec = f"PRECISION_AT_K({k}, userId)"
    ref = jev.make_evaluator(spec)(jnp.asarray(s), jnp.asarray(y), None, {"userId": g})
    ev = make_evaluator(spec)
    assert (ev.name, ev.group_by, ev.k) == (spec, "userId", k)
    got = ev(torch.as_tensor(s), torch.as_tensor(y), torch.as_tensor(w), {"userId": torch.as_tensor(g)})
    for want in (ref_host, ref_device, ref, grouped_precision_at_k(s[keep], y[keep], g[keep], k)):
        assert got == pytest.approx(want, abs=1e-6)
    t = torch.as_tensor
    padded = grouped_precision_at_k_device(t(s[keep]), t(y[keep]), t(dense), k, G + 5)
    assert float(padded) == pytest.approx(ref_host, abs=1e-6)


def test_grouped_edge_cases():
    """No group holds both classes: NaN on both sides; every row unseen:
    NaN; one row per group: precision is the positive share."""
    t = torch.as_tensor
    s = np.array([0.1, 0.4, 0.4, 0.9], np.float32)
    y = np.array([1, 1, 0, 0], np.float32)
    g = np.array([0, 0, 1, 1])
    ev = make_evaluator("MULTI_AUC(u)")
    assert np.isnan(ev(t(s), t(y), None, {"u": t(g)}))
    assert np.isnan(jev.make_evaluator("MULTI_AUC(u)")(jnp.asarray(s), jnp.asarray(y), None, {"u": g}))
    assert np.isnan(ev(t(s), t(y), None, {"u": t(np.full(4, -1))}))
    p = make_evaluator("PRECISION_AT_K(3,u)")(t(s), t(y), None, {"u": t(np.arange(4))})
    assert p == pytest.approx(0.5)
    with pytest.raises(KeyError, match="id tag 'u'"):
        ev(t(s), t(y))


@pytest.mark.parametrize("weights", [False, True], ids=["no_weights", "zero_weights"])
@pytest.mark.parametrize("spec,buckets", [("BUCKETED_AUC", 1 << 16), ("BUCKETED_AUC(64)", 64)])
def test_bucketed_auc_matches_reference(spec, buckets, weights):
    _, s, y = _scores(5, 3000, ties=False)
    w = (np.random.default_rng(6).uniform(size=3000) < 0.8).astype(np.float32) if weights else None
    t = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    want = float(jsc.bucketed_auc(j(s), j(y), j(w), num_buckets=buckets))
    ev = make_evaluator(spec.lower())
    assert ev.name == spec and ev.larger_is_better
    got = ev(t(s), t(y), t(w))
    assert got == pytest.approx(want, abs=1e-6)
    assert got == pytest.approx(jev.make_evaluator(spec)(j(s), j(y), j(w)), abs=1e-6)
    exact = float(auc_roc(t(s), t(y), t(w)))
    assert abs(got - exact) <= (1e-4 if buckets > 64 else 2e-2)
    # the same bins: equal per-bin counts
    inc = np.ones(3000, bool) if w is None else w > 0
    lo, hi = s[inc].min(), s[inc].max()
    want_hist = jsc._score_histograms(j(s), j(y), j(inc), j(lo), j(hi), buckets)
    got_hist = _score_histograms(t(s), t(y), t(inc), t(lo), t(hi), buckets)
    for a, b in zip(got_hist, want_hist):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bucketed_auc_is_exact_on_quantized_scores():
    """One distinct score per bin (with ties inside a bin): the histogram
    AUC is the rank-sum AUC."""
    rng = np.random.default_rng(7)
    s = rng.integers(0, 50, size=2000).astype(np.float32) / 49.0
    y = (rng.uniform(size=2000) < s).astype(np.float32)
    t = torch.as_tensor
    got = float(bucketed_auc(t(s), t(y), num_buckets=50))
    assert got == pytest.approx(float(auc_roc(t(s), t(y))), abs=1e-6)
    assert got == pytest.approx(float(jsc.bucketed_auc(jnp.asarray(s), jnp.asarray(y), num_buckets=50)),
                                abs=1e-6)


def test_parsing_and_evaluate_all():
    for bad in ("MULTI_AUC()", "PRECISION_AT_K(userId)", "BUCKETED_AUC(x)", "NDCG"):
        with pytest.raises(ValueError, match="unknown evaluator"):
            make_evaluator(bad)
    with pytest.raises(ValueError, match=">= 1"):
        make_evaluator("BUCKETED_AUC(0)")
    s, y, w, g = _groups(8)
    t = torch.as_tensor
    specs = ("MULTI_AUC(userId)", "AUC", "PRECISION_AT_K(2,userId)", "BUCKETED_AUC")
    got = evaluate_all(specs, t(s), t(y), t(w), group_ids={"userId": t(g)})
    want = jev.evaluate_all(specs, jnp.asarray(s), jnp.asarray(y), jnp.asarray(w), group_ids={"userId": g})
    assert got.primary_name == "MULTI_AUC(userId)" and list(got.metrics) == list(want.metrics)
    for name, value in want.metrics.items():
        assert got.metrics[name] == pytest.approx(value, abs=1e-6)

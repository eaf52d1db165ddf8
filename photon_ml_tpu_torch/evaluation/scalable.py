"""Device evaluators: the histogram AUC and the exact per-group (multi)
metrics (port of ``photon_ml_tpu/evaluation/scalable.py``).

- ``bucketed_auc``: O(n) AUC with no sort. Scores quantize into
  ``num_buckets`` bins over [min, max] by the reference's rule, bit for
  bit; positive and negative counts per bin accumulate by ``index_add_``,
  and the Mann-Whitney statistic runs over the bins with a tie-aware
  ½·P(b)·N(b) term inside each bin. Exact when every bin holds one
  distinct score; with 2¹⁶ bins and continuous scores the error is
  typically below 1e-4.
- ``grouped_auc_device`` / ``grouped_precision_at_k_device``: exact
  per-group metrics. Two stable sorts give the (group, score) order, run
  and group bounds come from ``cummax`` / ``cummin``, and per-group sums
  from ``index_add_``: no host loop.

- ``bucketed_auc_sharded`` / ``_padded``: the histogram AUC over a data
  mesh's row shards (``parallel/mesh.py``): each shard histograms its rows
  on its device against the global score range, and the per-shard
  histograms are summed in shard order (across processes after one gloo
  gather), so only O(buckets) crosses between devices.

Everything runs on the scores' device. Counts and rank sums are float64:
they are integers and half-integers, so their sums are exact in any
order (``index_add_`` on CUDA adds by atomics): the sharded histogram AUC
equals the unsharded one bit for bit.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _score_histograms(
    scores: Tensor, labels: Tensor, inc: Tensor, lo: Tensor, hi: Tensor, num_buckets: int
) -> tuple[Tensor, Tensor]:
    """Per-bin positive and negative counts (float64) of the included
    scores quantized into [lo, hi]: the reference's bins, bit for bit (the
    same float32 arithmetic, truncated toward zero)."""
    span = torch.clamp_min(hi - lo, 1e-30)
    s = torch.where(inc, scores, lo)
    bins = torch.clamp(((s - lo) / span * num_buckets).to(torch.int64), 0, num_buckets - 1)
    y = labels > 0
    f64 = dict(dtype=torch.float64, device=scores.device)
    pos_hist = torch.zeros(num_buckets, **f64).index_add_(0, bins, (inc & y).to(torch.float64))
    neg_hist = torch.zeros(num_buckets, **f64).index_add_(0, bins, (inc & ~y).to(torch.float64))
    return pos_hist, neg_hist


def bucketed_auc(
    scores: Tensor, labels: Tensor, weights: Tensor | None = None, num_buckets: int = 1 << 16
) -> Tensor:
    """Histogram AUC. Weights select samples (weight 0 excludes); the rank
    statistic itself is unweighted, as in ``auc_roc``."""
    inc = torch.ones_like(scores, dtype=torch.bool) if weights is None else weights > 0
    lo = torch.min(torch.where(inc, scores, float("inf")))
    hi = torch.max(torch.where(inc, scores, float("-inf")))
    return _auc_from_histograms(*_score_histograms(scores, labels, inc, lo, hi, num_buckets))


def _auc_from_histograms(pos_hist: Tensor, neg_hist: Tensor) -> Tensor:
    pos, neg = torch.sum(pos_hist), torch.sum(neg_hist)
    # negatives strictly below each bin, plus half the bin's own
    neg_below = torch.cumsum(neg_hist, 0) - neg_hist
    u = torch.sum(pos_hist * (neg_below + 0.5 * neg_hist))
    return torch.where((pos > 0) & (neg > 0), u / (pos * neg), float("nan"))


def bucketed_auc_sharded(
    scores: Tensor, labels: Tensor, weights: Tensor | None = None, num_buckets: int = 1 << 16, *, mesh
) -> Tensor:
    """``bucketed_auc`` over the row shards of ``mesh`` (a tuple of devices or
    a ``ProcessMesh``): ``scores`` holds every row (each process's same
    copy), whose count must divide the global shard count. This process's
    shards histogram their rows on their devices against the global
    [min, max] of the included scores (across processes one max gather),
    and every shard's histogram is summed in global shard order (across
    processes after one gather). Returns the AUC on the scores' device."""
    import numpy as np

    from photon_ml_tpu_torch.parallel.mesh import as_process_mesh
    from photon_ml_tpu_torch.parallel.multihost import _gather_arrays, allreduce_max_host

    pm = as_process_mesh(mesh)
    n = scores.shape[0]
    if n % pm.num_shards:
        raise ValueError(f"{n} rows do not divide {pm.num_shards} shards (use bucketed_auc_sharded_padded)")
    rows = n // pm.num_shards
    parts = []
    for shard, dev in zip(pm.global_shards(), pm.local):
        part = slice(shard * rows, (shard + 1) * rows)
        s, y = scores[part].to(dev), labels[part].to(dev)
        inc = torch.ones_like(s, dtype=torch.bool) if weights is None else weights[part].to(dev) > 0
        parts.append((s, y, inc))
    lo = min(float(torch.min(torch.where(inc, s, float("inf")))) for s, _, inc in parts)
    hi = max(float(torch.max(torch.where(inc, s, float("-inf")))) for s, _, inc in parts)
    if pm.spans_processes:
        neg_lo, hi = allreduce_max_host(np.asarray([-lo]), np.asarray([hi]))
        lo, hi = -float(neg_lo[0]), float(hi[0])
    hists = []
    for s, y, inc in parts:
        t = dict(dtype=s.dtype, device=s.device)
        hists.append(torch.stack(_score_histograms(s, y, inc, torch.tensor(lo, **t), torch.tensor(hi, **t),
                                                   num_buckets)).to(scores.device))
    if pm.spans_processes:
        ranks = _gather_arrays([torch.stack(hists).cpu().numpy()])
        hists = [torch.from_numpy(np.array(h)).to(scores.device) for rank in ranks for h in rank[0]]
    total = hists[0]
    for h in hists[1:]:
        total = total + h
    return _auc_from_histograms(total[0], total[1])


def bucketed_auc_sharded_padded(
    scores: Tensor, labels: Tensor, weights: Tensor | None = None, num_buckets: int = 1 << 16, *, mesh
) -> Tensor:
    """``bucketed_auc_sharded`` for any row count: weight-0 rows (excluded,
    as everywhere) pad the rows to a multiple of the global shard count."""
    from photon_ml_tpu_torch.parallel.mesh import as_process_mesh

    n = scores.shape[0]
    pad = -n % as_process_mesh(mesh).num_shards
    if pad:
        zeros = scores.new_zeros(pad)
        w = torch.ones_like(scores) if weights is None else weights.to(scores.dtype)
        scores, labels = torch.cat([scores, zeros]), torch.cat([labels, labels.new_zeros(pad)])
        weights = torch.cat([w, zeros])
    return bucketed_auc_sharded(scores, labels, weights, num_buckets, mesh=mesh)


def _group_score_order(scores: Tensor, group_ids: Tensor) -> Tensor:
    """Permutation sorting by (group, score) ascending: a stable sort by
    score, then a stable sort by group keeps the score order in a group."""
    by_score = torch.sort(scores, stable=True).indices
    by_group = torch.sort(group_ids[by_score], stable=True).indices
    return by_score[by_group]


def _starts(keys: Tensor) -> Tensor:
    """True where a sorted key run begins."""
    return torch.cat([torch.ones(1, dtype=torch.bool, device=keys.device), keys[1:] != keys[:-1]])


def _run_bounds(new_run: Tensor) -> tuple[Tensor, Tensor]:
    """First and last index of each run, broadcast to every element
    (``new_run[i]`` is True where a run starts): cumulative max from the
    left, cumulative min from the right."""
    n = new_run.shape[0]
    idx = torch.arange(n, device=new_run.device)
    first = torch.cummax(torch.where(new_run, idx, 0), 0).values
    is_last = torch.cat([new_run[1:], torch.ones(1, dtype=torch.bool, device=new_run.device)])
    from_right = torch.flip(torch.where(is_last, idx, n - 1), [0])
    last = torch.flip(torch.cummin(from_right, 0).values, [0])
    return first, last


def _group_sum(values: Tensor, groups: Tensor, num_groups: int) -> Tensor:
    return torch.zeros(num_groups, dtype=values.dtype, device=values.device).index_add_(
        0, groups, values
    )


def grouped_auc_device(
    scores: Tensor, labels: Tensor, group_ids: Tensor, num_groups: int
) -> Tensor:
    """Mean per-group rank-sum AUC over the groups that hold both classes
    (``group_ids`` dense in [0, num_groups)); the same values as the host
    ``grouped_auc``."""
    order = _group_score_order(scores, group_ids)
    g, s = group_ids[order], scores[order]
    y = (labels > 0).to(torch.float64)[order]
    new_seg = _starts(g)
    run_first, run_last = _run_bounds(new_seg | _starts(s))
    seg_first, _ = _run_bounds(new_seg)
    avg_rank = 0.5 * (run_first + run_last).to(torch.float64) - seg_first.to(torch.float64) + 1.0
    pos = _group_sum(y, g, num_groups)
    cnt = _group_sum(torch.ones_like(y), g, num_groups)
    rank_pos = _group_sum(avg_rank * y, g, num_groups)
    neg = cnt - pos
    valid = (pos > 0) & (neg > 0)
    u = rank_pos - pos * (pos + 1.0) / 2.0
    auc = torch.where(valid, u / torch.clamp_min(pos * neg, 1.0), 0.0)
    n_valid = torch.sum(valid)
    return torch.where(n_valid > 0, torch.sum(auc) / n_valid, float("nan"))


def grouped_precision_at_k_device(
    scores: Tensor, labels: Tensor, group_ids: Tensor, k: int, num_groups: int
) -> Tensor:
    """Mean per-group precision@k: the positives among each group's top-k
    scores over min(k, group size), averaged over the groups present."""
    order = _group_score_order(-scores, group_ids)  # descending score
    g = group_ids[order]
    y = (labels > 0).to(torch.float64)[order]
    seg_first, _ = _run_bounds(_starts(g))
    within_rank = torch.arange(g.shape[0], device=g.device) - seg_first
    hits = _group_sum(torch.where(within_rank < k, y, 0.0), g, num_groups)
    cnt = _group_sum(torch.ones_like(y), g, num_groups)
    present = cnt > 0
    prec = torch.where(present, hits / torch.clamp_min(torch.clamp_max(cnt, k), 1.0), 0.0)
    n_present = torch.sum(present)
    return torch.where(n_present > 0, torch.sum(prec) / n_present, float("nan"))

"""LIBSVM reader (port of ``photon_ml_tpu/data/libsvm.py``).

Feature indices are bound-checked on the host, before any device work.
"""

from __future__ import annotations

import numpy as np
import torch

from photon_ml_tpu_torch.ops.batch import SparseBatch, dense_batch_from_arrays


def parse_libsvm(
    path: str, zero_based: bool = False
) -> tuple[np.ndarray, list[np.ndarray], list[np.ndarray]]:
    """Parse a LIBSVM file. Returns (labels, per-row index arrays, per-row
    value arrays). Labels -1/+1 are mapped to 0/1."""
    labels: list[float] = []
    rows_idx: list[np.ndarray] = []
    rows_val: list[np.ndarray] = []
    with open(path) as f:
        for line_no, line in enumerate(f, 1):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            y = float(parts[0])
            idx = np.empty(len(parts) - 1, np.int64)
            val = np.empty(len(parts) - 1, np.float32)
            for j, tok in enumerate(parts[1:]):
                k, v = tok.split(":")
                idx[j] = int(k)
                val[j] = float(v)
            if not zero_based:
                idx -= 1
            if len(idx) and idx.min() < 0:
                raise ValueError(f"{path}:{line_no}: negative feature index")
            labels.append(y)
            rows_idx.append(idx)
            rows_val.append(val)
    y = np.asarray(labels, np.float32)
    if set(np.unique(y).tolist()) <= {-1.0, 1.0}:
        y = (y + 1.0) / 2.0  # -1/+1 → 0/1
    return y, rows_idx, rows_val


def _feature_dim(
    rows_idx: list[np.ndarray], num_features: int | None, add_intercept: bool
) -> tuple[int, int, int | None]:
    """(d_raw, d_total, intercept_index); the intercept is the LAST column."""
    max_idx = max((int(r.max()) for r in rows_idx if len(r)), default=-1)
    d_raw = num_features if num_features is not None else max_idx + 1
    if max_idx >= d_raw:
        raise ValueError(f"feature index {max_idx} out of range for num_features={d_raw}")
    intercept_index = d_raw if add_intercept else None
    return d_raw, d_raw + (1 if add_intercept else 0), intercept_index


def to_padded_sparse(
    labels: np.ndarray,
    rows_idx: list[np.ndarray],
    rows_val: list[np.ndarray],
    num_features: int | None = None,
    add_intercept: bool = True,
    pad_to_multiple: int = 8,
    device="cpu",
) -> tuple[SparseBatch, int | None]:
    """Pack ragged rows into fixed-width (n, k) index/value tensors; k is
    the largest row nnz (+1 for the intercept), padded entries are (0, 0.0).
    Returns (batch, intercept_index)."""
    n = len(rows_idx)
    _, d, intercept_index = _feature_dim(rows_idx, num_features, add_intercept)
    k = max((len(r) for r in rows_idx), default=0) + (1 if add_intercept else 0)
    k = max(k, 1)
    k = -(-k // pad_to_multiple) * pad_to_multiple
    idx = np.zeros((n, k), np.int64)
    val = np.zeros((n, k), np.float32)
    for i, (ri, rv) in enumerate(zip(rows_idx, rows_val)):
        m = len(ri)
        idx[i, :m] = ri
        val[i, :m] = rv
        if add_intercept:
            idx[i, m] = intercept_index
            val[i, m] = 1.0
    f32 = dict(dtype=torch.float32, device=device)
    batch = SparseBatch(
        indices=torch.as_tensor(idx, device=device),
        values=torch.as_tensor(val, device=device),
        labels=torch.as_tensor(labels, **f32),
        offsets=torch.zeros((n,), **f32),
        weights=torch.ones((n,), **f32),
        num_features=d,
    )
    return batch, intercept_index


def read_libsvm(
    path: str,
    num_features: int | None = None,
    dense: bool = False,
    add_intercept: bool = True,
    zero_based: bool = False,
    device="cpu",
):
    """Read a LIBSVM file into a batch on ``device``. Returns (batch,
    intercept_index). ``dense=True`` materializes the (n, d) matrix;
    otherwise rows stay padded (n, k) pairs."""
    labels, rows_idx, rows_val = parse_libsvm(path, zero_based=zero_based)
    if not dense:
        return to_padded_sparse(
            labels, rows_idx, rows_val, num_features=num_features,
            add_intercept=add_intercept, device=device,
        )
    n = len(rows_idx)
    _, d, intercept_index = _feature_dim(rows_idx, num_features, add_intercept)
    X = np.zeros((n, d), np.float32)
    for i, (ri, rv) in enumerate(zip(rows_idx, rows_val)):
        np.add.at(X[i], ri, rv)  # duplicate indices accumulate
    if intercept_index is not None:
        X[:, intercept_index] = 1.0
    return dense_batch_from_arrays(X, labels, device=device), intercept_index

"""The port's sparse kernel path (``photon_ml_tpu_torch/ops/sparse_tiled.py``,
K3's plain version on the CPU) against the JAX package: its XLA
gather/scatter ``SparseBatch`` and its tile-COO ``TiledSparseBatch``, whose
Pallas kernels run in interpret mode here (``kernel``-marked tests). The
interpret-mode cases run both reference kernel variants,
``SEGMENT_BATCHED`` True (``_tile_kernel_seg``, K3) and False
(``_tile_kernel``, K4), on every storage rung, so one port kernel answers
for both."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import photon_ml_tpu.ops.sparse_tiled as jst
from photon_ml_tpu.ops.batch import SparseBatch as JSparse
from photon_ml_tpu_torch.convert import sparse_batch_from_numpy
from photon_ml_tpu_torch.ops import sparse_tiled as st
from photon_ml_tpu_torch.ops.batch import DenseBatch, optimize_batch_layout

F32_TOL = 1e-5  # tests/test_sparse_tiled.py's rtol = atol
# the reference's reduced-rung gates against XLA, as a share of max|ref|
# (tests/test_kernel_dtype.py::test_reduced_rungs_match_xla_reference)
XLA_GATE = {"bf16": 2e-2, "int8": 6e-2}


def _pair(idx, val, *, d, y=None, off=None, wt=None):
    """The same padded-sparse data as a JAX and a port ``SparseBatch``."""
    n = idx.shape[0]
    y = np.zeros(n, np.float32) if y is None else y
    off = np.zeros(n, np.float32) if off is None else off
    wt = np.ones(n, np.float32) if wt is None else wt
    jb = JSparse(
        indices=jnp.asarray(idx, jnp.int32), values=jnp.asarray(val), labels=jnp.asarray(y),
        offsets=jnp.asarray(off), weights=jnp.asarray(wt), num_features=d,
    )
    tb = sparse_batch_from_numpy(idx, val, y, off, wt, num_features=d, device="cpu")
    return jb, tb


def _problem(seed, n=1100, d=4608, k=5):
    """tests/test_sparse_tiled.py's ``_sparse_problem``: uniform indices,
    normal values, 10% explicit zero slots, offsets and labels."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
    val = rng.normal(size=(n, k)).astype(np.float32)
    val[rng.uniform(size=(n, k)) < 0.1] = 0.0
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    off = (rng.normal(size=n) * 0.1).astype(np.float32)
    return _pair(idx, val, d=d, y=y, off=off)


def _duplicates(seed):
    """tests/test_sparse_tiled.py::test_duplicate_indices_accumulate."""
    rng = np.random.default_rng(seed)
    n, d = 256, 4096
    idx = np.zeros((n, 4), np.int32)
    idx[:, 0] = 7
    idx[:, 1] = 7  # duplicate column in the same row
    idx[:, 2] = np.arange(n) % d
    idx[:, 3] = 2048
    return _pair(idx, rng.normal(size=(n, 4)).astype(np.float32), d=d)


def _one_column(seed):
    """Every nonzero in column 7: one write index of the gradient layout
    holds all n·k of them, every other one none."""
    rng = np.random.default_rng(seed)
    n, d, k = 1100, 4608, 4
    return _pair(np.full((n, k), 7, np.int32), rng.normal(size=(n, k)).astype(np.float32), d=d)


SHAPES = {
    "reference": lambda: _problem(1),
    "ragged": lambda: _problem(2, n=1101, d=4109),
    "duplicates": lambda: _duplicates(3),
    "one_column": lambda: _one_column(4),
}


def _vectors(tb, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=tb.num_features).astype(np.float32)
    r = rng.normal(size=tb.num_rows).astype(np.float32)
    return w, r


def _outputs(batch, w, r, as_array):
    return {
        "matvec": np.asarray(batch.matvec(as_array(w))),
        "rmatvec": np.asarray(batch.rmatvec(as_array(r))),
        "rmatvec_sq": np.asarray(batch.rmatvec_sq(as_array(r))),
    }


def _port(tb, w, r):
    return _outputs(tb, w, r, torch.as_tensor)


def _jax(jb, w, r):
    return _outputs(jb, w, r, jnp.asarray)


# ---------------------------------------------------------------------------
# 1. against the XLA gather/scatter SparseBatch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("direction", st.DIRECTIONS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_matches_xla_sparse_batch(monkeypatch, shape, direction):
    monkeypatch.delenv("PHOTON_KERNEL_DTYPE", raising=False)
    jb, tb = SHAPES[shape]()
    tiled = st.tile_sparse_batch(tb)
    assert tiled.storage == "f32"
    w, r = _vectors(tb)
    got = _port(tiled, w, r)[direction]
    assert got.shape == ((tb.num_rows,) if direction == "matvec" else (tb.num_features,))
    np.testing.assert_allclose(got, _jax(jb, w, r)[direction], rtol=F32_TOL, atol=F32_TOL)


def _tile(monkeypatch, tb, rung):
    monkeypatch.setenv("PHOTON_KERNEL_DTYPE", rung)
    return st.tile_sparse_batch(tb)


def test_layout_is_csr_sorted_and_drops_zero_slots(monkeypatch):
    _, tb = SHAPES["reference"]()
    tiled = _tile(monkeypatch, tb, "f32")
    nnz = int((tb.values != 0).sum())
    for lay, write_len, read_len in ((tiled.m, tb.num_rows, tb.num_features),
                                     (tiled.g, tb.num_features, tb.num_rows)):
        assert lay.nnz == nnz and lay.write_len == write_len and lay.read_len == read_len
        assert lay.offsets.dtype == torch.int64 and lay.read.dtype == torch.int32
        assert int(lay.offsets[0]) == 0 and int(lay.offsets[-1]) == nnz
        key = st._write_ids(lay) * read_len + lay.read.long()
        assert bool((key[1:] >= key[:-1]).all())
        assert bool((lay.values != 0).all())
        # f32 stream: 8 bytes a nonzero plus 8 per write index
        assert lay.stream_bytes() == 8 * nnz + 8 * (write_len + 1)
    again = st.tile_sparse_batch(tb)
    for a, b in ((tiled.m, again.m), (tiled.g, again.g)):
        assert torch.equal(a.offsets, b.offsets) and torch.equal(a.read, b.read)
        assert torch.equal(a.values, b.values)


@pytest.mark.parametrize("storage,itemsize", [("f32", 4), ("bf16", 2), ("int8", 1)])
def test_rung_storage_widths(monkeypatch, storage, itemsize):
    _, tb = SHAPES["ragged"]()
    tiled = _tile(monkeypatch, tb, storage)
    for lay in (tiled.m, tiled.g):
        assert lay.values.element_size() == itemsize and lay.storage == storage
    assert (tiled.m.scale is None) == (storage != "int8")


def test_out_of_range_index_is_refused():
    _, tb = SHAPES["duplicates"]()
    idx = tb.indices.clone()
    idx[3, 1] = tb.num_features
    from dataclasses import replace

    with pytest.raises(ValueError, match="out of range"):
        st.tile_sparse_batch(replace(tb, indices=idx))
    with pytest.raises(ValueError, match="out of range"):
        sparse_batch_from_numpy(idx.numpy(), tb.values.numpy(), tb.labels.numpy(),
                                num_features=tb.num_features, device="cpu")


def test_kernel_source_agrees_with_the_wrapper():
    import re

    from photon_ml_tpu_torch.ops import _cuda

    assert [p.name for p in _cuda.SOURCES] == ["fused_glm.cu", "sparse_tiled.cu"]
    src = _cuda.SOURCES[1].read_text()
    for storage, sid in st._STORAGE_ID.items():
        enum = {"f32": "kF32", "bf16": "kBf16", "int8": "kInt8"}[storage]
        assert re.search(rf"\b{enum} = {sid}\b", src)
    assert re.search(rf"kSlabShift = {st._SLAB_SHIFT};", src) and st.SLAB == 1 << st._SLAB_SHIFT
    assert re.search(rf"kTileNnz = {st.TILE_NNZ};", src)
    # no atomic call: one plain store per output, so results repeat bitwise
    assert re.search(r"\batomic\w*\s*\(", src) is None
    # every source feeds the library's name, so editing either rebuilds it
    assert _cuda.library_path().name.startswith("libphoton_kernels_")


def test_wrapper_runs_plain_version_on_cpu_and_refuses_other_devices(monkeypatch):
    _, tb = SHAPES["duplicates"]()
    tiled = _tile(monkeypatch, tb, "f32")
    st.reset_launch_counts()
    w, _ = _vectors(tb)
    got = st.sparse_apply(tiled.m, torch.as_tensor(w))
    assert torch.equal(got, st.tiled_apply_reference(tiled.m, torch.as_tensor(w)))
    assert st.launch_counts == {"matvec": 0, "rmatvec": 0, "rmatvec_sq": 0}
    with pytest.raises(ValueError, match="CPU or CUDA"):
        st.sparse_apply(tiled.m, torch.empty(tb.num_features, device="meta"))


# ---------------------------------------------------------------------------
# 2. against the reference's tile-COO kernels in interpret mode (K3 and K4)
# ---------------------------------------------------------------------------
def _assert_rung_parity(jb, tb, rung):
    """Port vs the JAX tiled batch on one rung (same quantization, so
    bf16/int8 agree to float32 summation order: atol 1e-5·max|ref|), and
    the reduced rungs also within the reference's own gate vs XLA."""
    jt = jst.tile_sparse_batch(jb)
    tiled = st.tile_sparse_batch(tb)
    assert tiled.storage == rung
    w, r = _vectors(tb, seed=5)
    got, ref, xla = _port(tiled, w, r), _jax(jt, w, r), _jax(jb, w, r)
    for key in st.DIRECTIONS:
        if rung == "f32":
            np.testing.assert_allclose(got[key], ref[key], rtol=F32_TOL, atol=F32_TOL)
            continue
        scale = float(np.max(np.abs(ref[key]))) or 1.0
        np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=F32_TOL * scale)
        xscale = float(np.max(np.abs(xla[key]))) or 1.0
        np.testing.assert_allclose(got[key] / xscale, xla[key] / xscale, atol=XLA_GATE[rung])
    return jt


@pytest.mark.kernel
@pytest.mark.parametrize("rung", st.KERNEL_DTYPES)
def test_matches_reference_segment_batched_kernel(monkeypatch, rung):
    # SEGMENT_BATCHED = True: _tile_kernel_seg (K3), at _sparse_problem's shape
    monkeypatch.setattr(jst, "SEGMENT_BATCHED", True)
    monkeypatch.setenv("PHOTON_KERNEL_DTYPE", rung)
    jb, tb = _problem(6)
    _assert_rung_parity(jb, tb, rung)


@pytest.mark.kernel
@pytest.mark.parametrize("rung", st.KERNEL_DTYPES)
def test_matches_reference_per_group_kernel(monkeypatch, rung):
    # SEGMENT_BATCHED = False: _tile_kernel (K4), which unrolls per group,
    # at the reference's own small shape and constants for it
    # (tests/test_sparse_tiled.py::test_fallback_kernel_pipelines_too)
    monkeypatch.setattr(jst, "SEGMENT_BATCHED", False)
    monkeypatch.setattr(jst, "GROUPS_PER_STEP", 4)
    monkeypatch.setattr(jst, "SEGMENTS_PER_DMA", 2)
    monkeypatch.setattr(jst, "GROUPS_PER_RUN", 2)
    monkeypatch.setenv("PHOTON_KERNEL_DTYPE", rung)
    rng = np.random.default_rng(7)
    n, d, k = 640, 2048, 2
    jb, tb = _pair(rng.integers(0, d, size=(n, k)).astype(np.int32),
                   rng.normal(size=(n, k)).astype(np.float32), d=d)
    _assert_rung_parity(jb, tb, rung)


@pytest.mark.kernel
def test_single_layout_equals_reference_chunk_sum(monkeypatch):
    # the reference splits beyond its VMEM bounds into row/col chunks and
    # sums the chunks' outputs; the port keeps one layout for any shape
    monkeypatch.setattr(jst, "_MAX_TABLE_ROWS", st.SLAB)
    monkeypatch.setattr(jst, "_MAX_TABLE_COLS", 2 * st.SLAB)
    monkeypatch.setenv("PHOTON_KERNEL_DTYPE", "f32")
    jb, tb = _problem(8)
    jt = _assert_rung_parity(jb, tb, "f32")
    assert len(jt.chunks) == 2 * 3


# ---------------------------------------------------------------------------
# 3. the int8 quantization
# ---------------------------------------------------------------------------
def test_int8_quantization_exact_for_uniform_cells(monkeypatch):
    """tests/test_kernel_dtype.py's identity case: values in {-s, 0, s}
    quantize to q in {-127, 127} with cell scale s/127."""
    rng = np.random.default_rng(9)
    n, d, k = 1024, 2048, 3
    idx = rng.integers(0, d, size=(n, k))
    val = (rng.choice([-1.0, 0.0, 1.0], size=(n, k)) * 0.375).astype(np.float32)
    _, tb = _pair(idx, val, d=d)
    tiled = _tile(monkeypatch, tb, "int8")
    for lay in (tiled.m, tiled.g):
        assert set(torch.unique(lay.values).tolist()) <= {-127, 127}
    live = tiled.m.scale[tiled.m.scale != 1.0]
    assert live.numel() == tiled.m.scale.numel()  # every cell holds a nonzero here
    np.testing.assert_allclose(live.numpy(), 0.375 / 127.0, rtol=1e-6)
    # the layouts of both rungs hold the nonzeros in one order
    np.testing.assert_allclose(
        st.decoded_values(tiled.m).numpy(),
        st.decoded_values(_tile(monkeypatch, tb, "f32").m).numpy(), rtol=1e-6,
    )


@pytest.mark.parametrize("direction", ["margins", "gradient"])
def test_int8_cell_scales_equal_reference_run_scales(monkeypatch, direction):
    """The reference carries each cell's scale on every run of the cell
    (``srun``); the port's scale table holds the same float32 per cell."""
    rng = np.random.default_rng(10)
    n, d, k = 3000, 5000, 4
    idx = rng.integers(0, d, size=(n, k))
    val = rng.normal(size=(n, k)).astype(np.float32)
    val[rng.uniform(size=(n, k)) < 0.1] = 0.0
    _, tb = _pair(idx, val, d=d)
    table = _tile(monkeypatch, tb, "int8").m.scale.numpy()
    rows = np.repeat(np.arange(n), k)
    cols, vals = idx.reshape(-1), val.reshape(-1)
    keep = vals != 0
    n_pad, d_pad = -(-n // st.SLAB) * st.SLAB, -(-d // st.SLAB) * st.SLAB
    gps, gpr = 8, 2
    if direction == "margins":
        lay = jst.build_write_major_layout(rows[keep], cols[keep], vals[keep], n_pad, d_pad,
                                           groups_per_step=gps, groups_per_run=gpr, storage="int8")
    else:
        lay = jst.build_write_major_layout(cols[keep], rows[keep], vals[keep], d_pad, n_pad,
                                           groups_per_step=gps, groups_per_run=gpr, storage="int8")
    ws = lay.wslab[np.arange(len(lay.rrun)) // (gps // gpr)]
    live = lay.srun != 1.0
    got = table[ws[live], lay.rrun[live]] if direction == "margins" else table[lay.rrun[live], ws[live]]
    assert live.sum() > 20
    np.testing.assert_array_equal(got, lay.srun[live])
    # and the cells the reference scales are exactly the port's scaled cells
    cells = set(zip(ws[live].tolist(), lay.rrun[live].tolist()))
    port = {(a, b) if direction == "margins" else (b, a) for a, b in zip(*np.nonzero(table != 1.0))}
    assert cells == port


# ---------------------------------------------------------------------------
# 4. the PHOTON_KERNEL_DTYPE knob
# ---------------------------------------------------------------------------
def test_kernel_dtype_default_is_f32(monkeypatch):
    monkeypatch.delenv("PHOTON_KERNEL_DTYPE", raising=False)
    monkeypatch.setattr(st, "KERNEL_DTYPE", "f32")
    assert st.kernel_dtype() == "f32"


def test_kernel_dtype_env_wins_and_is_read_at_call_time(monkeypatch):
    monkeypatch.setattr(st, "KERNEL_DTYPE", "f32")
    monkeypatch.setenv("PHOTON_KERNEL_DTYPE", "bf16")
    assert st.kernel_dtype() == "bf16"
    monkeypatch.setenv("PHOTON_KERNEL_DTYPE", "int8")
    assert st.kernel_dtype() == "int8"
    _, tb = SHAPES["duplicates"]()
    assert st.tile_sparse_batch(tb).storage == "int8"  # read when the layout is built
    monkeypatch.delenv("PHOTON_KERNEL_DTYPE")
    monkeypatch.setattr(st, "KERNEL_DTYPE", "bf16")
    assert st.kernel_dtype() == "bf16"
    monkeypatch.setenv("PHOTON_KERNEL_DTYPE", "")
    assert st.kernel_dtype() == "bf16"  # empty means unset


@pytest.mark.parametrize("bad", ["fp16", "float32", "8", "x", " ", "f64"])
def test_kernel_dtype_unknown_rung_rejected(monkeypatch, bad):
    monkeypatch.setenv("PHOTON_KERNEL_DTYPE", bad)
    with pytest.raises(ValueError, match="f32, bf16, int8"):
        st.kernel_dtype()
    with pytest.raises(ValueError, match="f32, bf16, int8"):
        st.validate_kernel_dtype(bad)


def test_kernel_dtype_case_and_whitespace_normalized(monkeypatch):
    monkeypatch.setenv("PHOTON_KERNEL_DTYPE", " BF16 ")
    assert st.kernel_dtype() == "bf16"
    assert st.validate_kernel_dtype("Int8") == "int8"


# ---------------------------------------------------------------------------
# 7. the layout decision and its gate
# ---------------------------------------------------------------------------
def test_supports_tiling_gate():
    rng = np.random.default_rng(11)
    _, big = _pair(rng.integers(0, 8192, size=(st.SLAB * 2, 4)),
                   rng.normal(size=(st.SLAB * 2, 4)).astype(np.float32), d=8192)
    assert st.supports_tiling(big)
    _, small = _pair(rng.integers(0, 512, size=(200, 4)),
                     rng.normal(size=(200, 4)).astype(np.float32), d=512)
    assert not st.supports_tiling(small)
    from photon_ml_tpu_torch.ops.batch import densify

    assert not st.supports_tiling(densify(small))
    from dataclasses import replace

    assert not st.supports_tiling(replace(big, values=torch.zeros_like(big.values)))
    assert st.tiling_economical_features(4096) and st.tiling_economical_features(1 << 23)
    assert not st.tiling_economical_features(4095)
    assert not st.tiling_economical_features((1 << 23) + 1)


@pytest.mark.parametrize("n,d,tiles", [
    (st.SLAB - 1, 8192, False), (st.SLAB, 8192, True), (st.SLAB, 4095, False), (st.SLAB, 4096, True),
])
def test_supports_tiling_bounds_match_reference(n, d, tiles):
    rng = np.random.default_rng(12)
    jb, tb = _pair(rng.integers(0, d, size=(n, 2)), rng.normal(size=(n, 2)).astype(np.float32), d=d)
    assert st.supports_tiling(tb) is tiles
    assert jst.supports_tiling(jb) is tiles


def test_optimize_batch_layout_decision():
    """tests/test_sparse_tiled.py::test_optimize_batch_layout_decision:
    small-d sparse densifies, over-budget high-d sparse gets the port's
    tiled batch, dense passes through."""
    rng = np.random.default_rng(13)
    _, small = _pair(rng.integers(0, 600, size=(300, 4)),
                     rng.normal(size=(300, 4)).astype(np.float32), d=600)
    out = optimize_batch_layout(small, hbm_budget_bytes=1e9)
    assert isinstance(out, DenseBatch)
    assert optimize_batch_layout(out) is out

    jb, big = _pair(rng.integers(0, 8192, size=(st.SLAB + 5, 4)),
                    rng.normal(size=(st.SLAB + 5, 4)).astype(np.float32), d=8192)
    tiled = optimize_batch_layout(big, hbm_budget_bytes=1)  # force no densify
    assert isinstance(tiled, st.TiledSparseBatch)
    assert tiled.labels is big.labels and tiled.weights is big.weights
    w, _ = _vectors(big)
    np.testing.assert_allclose(_port(tiled, w, np.zeros(big.num_rows, np.float32))["matvec"],
                               np.asarray(jb.matvec(jnp.asarray(w))), rtol=F32_TOL, atol=F32_TOL)
    # within budget the same data densifies, as in the reference
    assert isinstance(optimize_batch_layout(big, hbm_budget_bytes=1e9), DenseBatch)


# ---------------------------------------------------------------------------
# 8. the kernel's tiles: metadata and a model of its schedule
# ---------------------------------------------------------------------------
T = st.TILE_NNZ
ITEMS = 8  # ``kItems`` in csrc/sparse_tiled.cu: nonzeros a thread walks
THREADS = T // ITEMS


def _layout(counts, seed=0, read_len=50):
    """A gradient-style layout whose write index i holds counts[i] nonzeros
    (0 makes it empty), through the builder ``tile_sparse_batch`` uses."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts, np.int64)
    write = torch.as_tensor(np.repeat(np.arange(len(counts)), counts))
    read = torch.as_tensor(rng.integers(0, read_len, size=int(counts.sum())))
    vals = torch.as_tensor(rng.normal(size=int(counts.sum())).astype(np.float32))
    return st._csr(write, read, vals, len(counts), read_len, "f32", None)


def _kernel_model(lay, src):
    """The kernel's schedule on the CPU, step by step: per tile, each
    thread's run walks its write indices from a binary search in the
    offsets slice [wf, wn]; pieces that cross threads join in a segmented
    scan; pieces that cross tiles go through the two carry slots and the
    second kernel. Returns (out, stores per write index)."""
    off = lay.offsets.tolist()
    tw = lay.tile_write.tolist()
    nnz, n_tiles = lay.nnz, lay.num_tiles
    prod = (lay.values.double() * src.double()[lay.read.long()]).tolist()
    out = np.full(lay.write_len, np.nan)
    stores = np.zeros(lay.write_len, np.int64)
    carry = [None] * (2 * n_tiles)

    def store(w, v):
        out[w] = v
        stores[w] += 1

    for t in range(n_tiles):
        wf, wn = max(tw[t] - 1, 0), tw[t + 1]
        assert wn - wf + 1 <= lay.write_len + 1
        s0, e = t * T, min((t + 1) * T, nnz)
        threads = []
        for tid in range(THREADS):
            k0 = s0 + tid * ITEMS
            k1 = min(k0 + ITEMS, e)
            if k0 >= e:
                threads.append(None)
                continue
            lo, hi = wf, wn
            assert off[lo] <= k0
            while lo < hi:
                mid = lo + (hi - lo + 1) // 2
                lo, hi = (mid, hi) if off[mid] <= k0 else (lo, mid - 1)
            w_first = lo
            head_open = off[w_first] < k0
            if not head_open:
                lo, hi = wf, w_first
                while lo < hi:
                    mid = (lo + hi) // 2
                    lo, hi = (mid + 1, hi) if off[mid] < k0 else (lo, mid)
                for q in range(lo, w_first):
                    store(q, 0.0)
            st_ = dict(w_first=w_first, head_open=head_open, head=None, tail_open=False, k1=k1)

            def finish(wi, acc, st_=st_):
                if wi == st_["w_first"] and st_["head_open"]:
                    st_["head"] = acc
                else:
                    store(wi, acc)

            w, acc = w_first, 0.0
            end = off[w + 1]
            for k in range(k0, k1):
                while end <= k:
                    finish(w, acc)
                    acc, w = 0.0, w + 1
                    end = off[w + 1]
                acc += prod[k]
            if end == k1:
                finish(w, acc)
                flag, val = 1, 0.0
            else:
                st_["tail_open"] = True
                flag, val = int(not (w == w_first and head_open)), acc
            st_.update(w=w, flag=flag, val=val)
            threads.append(st_)
        incl, run = [], 0.0  # the segmented scan, in thread order
        for th in threads:
            if th is not None:
                run = th["val"] if th["flag"] else run + th["val"]
            incl.append(run)
        for tid, th in enumerate(threads):
            if th is None:
                continue
            excl = incl[tid - 1] if tid else 0.0
            if th["head"] is not None:
                if off[th["w_first"]] >= s0:
                    store(th["w_first"], excl + th["head"])
                else:
                    assert carry[2 * t] is None
                    carry[2 * t] = excl + th["head"]
            if th["tail_open"] and th["k1"] == e:
                slot = 2 * t + 1 if off[th["w"]] >= s0 else 2 * t
                assert carry[slot] is None
                carry[slot] = incl[tid]
    # the second kernel: boundaries, then the empties past the last nonzero
    for b in range(1, n_tiles):
        pos, first = b * T, tw[b]
        if off[first] == pos:
            continue
        w = first - 1
        if off[w] < pos - T:
            continue
        total, j = carry[2 * (b - 1) + 1], b
        while True:
            total += carry[2 * j]
            if off[w + 1] <= (j + 1) * T:
                break
            j += 1
        store(w, total)
    for w in range(tw[n_tiles], lay.write_len):
        store(w, 0.0)
    return out, stores


def _long_column():
    # write index 2 spans four tiles; empties sit on both of its sides
    return [3, 0, 3 * T + 17, 0, 0, 5] + [7] * 300


def _edge_empties():
    # rows of 8: every tile edge falls between rows, and two empty rows sit
    # on each edge, as does a run of empties past the last nonzero
    counts = []
    for t in range(3):
        counts += [8] * (T // 8) + [0, 0]
    return counts + [0] * 5


TILING_CASES = {
    "whole_tiles": lambda: [16] * (2 * T // 16),
    "one_past_whole": lambda: [16] * (2 * T // 16) + [1],
    "under_one_tile": lambda: [3, 0, 5, 7, 0],
    "span_three_tiles": _long_column,
    "empties_on_tile_edges": _edge_empties,
    "no_nonzeros": lambda: [0] * 9,
    "tile_edge_inside_a_run": lambda: [T - 3, 10, 0, T + 6, 1],
}


def test_kernel_model_constants_match_the_source():
    from photon_ml_tpu_torch.ops import _cuda

    src = _cuda.SOURCES[1].read_text()
    assert f"kItems = {ITEMS};" in src and f"kThreads = {THREADS};" in src


@pytest.mark.parametrize("case", list(TILING_CASES))
def test_tile_write_agrees_with_direct_search(case):
    lay = _layout(TILING_CASES[case]())
    off = lay.offsets.tolist()
    nnz = lay.nnz
    assert lay.num_tiles == -(-nnz // T)
    starts = [min(t * T, nnz) for t in range(lay.num_tiles + 1)]
    direct = [next(w for w in range(lay.write_len + 1) if off[w] >= p) for p in starts]
    assert lay.tile_write.tolist() == direct
    assert lay.tile_write.dtype == torch.int64
    # the storage padding the bulk copies read past the logical streams
    assert st._room(lay.read) >= lay.num_tiles * T and st._room(lay.values) >= lay.num_tiles * T
    assert st._room(lay.offsets) >= lay.write_len + 3
    st._check_kernel_layout(lay)


@pytest.mark.parametrize("case", list(TILING_CASES))
def test_kernel_schedule_model_matches_plain_version(case):
    """Every write index is stored exactly once and the model's sums match
    the plain version: a fault in the tile arithmetic, the carry slots or
    the empties would show here, not only on the card."""
    lay = _layout(TILING_CASES[case](), seed=1)
    src = torch.as_tensor(np.random.default_rng(2).normal(size=lay.read_len).astype(np.float32))
    got, stores = _kernel_model(lay, src)
    assert (stores == 1).all(), np.nonzero(stores != 1)[0][:10]
    ref = st.tiled_apply_reference(lay, src).numpy()
    np.testing.assert_allclose(got.astype(np.float32), ref, rtol=1e-6, atol=1e-6)


def test_kernel_layout_check_refuses_unpadded_streams():
    lay = _layout([16] * 200)
    from dataclasses import replace

    with pytest.raises(ValueError, match="tile_sparse_batch"):
        st._check_kernel_layout(replace(lay, read=lay.read.clone()))
    with pytest.raises(ValueError, match="tile_sparse_batch"):
        st._check_kernel_layout(replace(lay, tile_write=lay.tile_write[:-1]))


def test_int8_scale_tables_are_write_major_with_aligned_rows(monkeypatch):
    _, tb = SHAPES["ragged"]()
    tiled = _tile(monkeypatch, tb, "int8")
    assert torch.equal(tiled.g.scale, tiled.m.scale.T)
    for lay in (tiled.m, tiled.g):
        assert lay.scale.stride(1) == 1 and lay.scale.stride(0) % 4 == 0
        st._check_kernel_layout(lay)

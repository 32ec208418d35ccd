"""Sparse matrix containers and dense<->sparse conversion.

A re-design of the reference's CSR weight machinery
(`src/caffe/layers/base_conv_layer.cpp:46-273` WeightAlign,
`src/caffe/util/math_functions.cu:103-152` caffe_gpu_sparse_dense2csr,
`include/caffe/util/sconv.hpp` column-blocked CSR).

Three formats, each a registered JAX pytree with *static* shape metadata so a
pruned model traces/compiles once:

* ``CSR``   — classic values/colidx/rowptr. Semantics + interchange format;
              row lengths are data-dependent so it is NOT used inside jit
              compute paths directly.
* ``ELL``   — row-padded CSR (every row padded to the max nnz/row). Static
              shapes; the analogue of the reference's per-row CSR kernels
              (`sconv_shm`, `math_functions.cu:264-319`): the gather-FMA inner
              loop becomes a fixed-trip-count loop with masked tail.
* ``BSR``   — block compressed sparse row with fixed (bm, bk) blocks sized to
              matrix-unit tiles. The performance-carrying format: nonzero
              blocks run as dense tile products, zero blocks are skipped
              entirely. The analogue of the reference's column-blocked CSR
              (`base_conv_layer.cpp:108-231` + OC_BLOCK=16 register blocking in
              `sconv.hpp:57-589`), re-sized from AVX registers to 128x128
              tiles.

Conversions are vectorized numpy/jnp (never per-element Python loops) and run
once at weight-align time, mirroring the reference's one-shot dense->CSR
conversion at model load (`net.cpp:819`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


def _static_field(**kw):
    return dataclasses.field(metadata={"static": True}, **kw)


def _register(cls):
    """Register a dataclass as a pytree; fields marked static go to aux data."""
    fields = dataclasses.fields(cls)
    data_names = [f.name for f in fields if not f.metadata.get("static")]
    static_names = [f.name for f in fields if f.metadata.get("static")]

    def flatten(obj):
        return (
            tuple(getattr(obj, n) for n in data_names),
            tuple(getattr(obj, n) for n in static_names),
        )

    def unflatten(aux, children):
        kwargs = dict(zip(data_names, children))
        kwargs.update(dict(zip(static_names, aux)))
        return cls(**kwargs)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


# ---------------------------------------------------------------------------
# CSR
# ---------------------------------------------------------------------------


@_register
@dataclasses.dataclass(frozen=True)
class CSR:
    """values[nnz], colidx[nnz] (int32), rowptr[rows+1] (int32)."""

    values: Array
    colidx: Array
    rowptr: Array
    shape: Tuple[int, int] = _static_field(default=(0, 0))

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @property
    def density(self) -> float:
        r, c = self.shape
        return self.nnz / max(1, r * c)

    def to_dense(self) -> Array:
        rows, cols = self.shape
        nnz = self.values.shape[0]
        if nnz == 0:
            return jnp.zeros(self.shape, self.values.dtype)
        # row index per nonzero via searchsorted on rowptr
        row_of = (
            jnp.searchsorted(self.rowptr, jnp.arange(nnz, dtype=jnp.int32), side="right")
            - 1
        )
        dense = jnp.zeros((rows, cols), self.values.dtype)
        return dense.at[row_of, self.colidx].set(self.values)


def dense_to_csr(w, dtype=None) -> CSR:
    """Dense (rows, cols) -> CSR. Host-side numpy; runs once per layer at
    weight-align time (reference: `math_functions.cpp:77-126`)."""
    w = np.asarray(w)
    if dtype is not None:
        w = w.astype(dtype)
    rows, cols = w.shape
    mask = w != 0
    nnz_per_row = mask.sum(axis=1).astype(np.int32)
    rowptr = np.zeros(rows + 1, np.int32)
    np.cumsum(nnz_per_row, out=rowptr[1:])
    ridx, cidx = np.nonzero(mask)
    return CSR(
        values=jnp.asarray(w[ridx, cidx]),
        colidx=jnp.asarray(cidx.astype(np.int32)),
        rowptr=jnp.asarray(rowptr),
        shape=(rows, cols),
    )


# ---------------------------------------------------------------------------
# ELL (row-padded CSR)
# ---------------------------------------------------------------------------


@_register
@dataclasses.dataclass(frozen=True)
class ELL:
    """Row-padded sparse matrix.

    values[rows, width], colidx[rows, width]; padding entries have value 0 and
    colidx clamped to a valid column (0), so an unmasked gather-FMA still
    computes the correct result (0 * garbage row = 0).  ``row_nnz`` is kept for
    kernels that prefer early exit / masking.
    """

    values: Array
    colidx: Array
    row_nnz: Array
    shape: Tuple[int, int] = _static_field(default=(0, 0))

    @property
    def width(self) -> int:
        return int(self.values.shape[1])

    @property
    def nnz(self) -> int:
        # true nnz (excludes padding)
        return int(np.asarray(self.row_nnz).sum())

    def to_dense(self) -> Array:
        rows, cols = self.shape
        dense = jnp.zeros((rows, cols), self.values.dtype)
        r = jnp.repeat(jnp.arange(rows, dtype=jnp.int32), self.values.shape[1])
        return dense.at[r, self.colidx.reshape(-1)].add(self.values.reshape(-1))


def dense_to_ell(w, width: int | None = None, lane_pad: int = 1) -> ELL:
    """Dense -> ELL. ``width`` defaults to max nnz/row, rounded up to a
    multiple of ``lane_pad`` (use 8 to keep fori_loop trip counts friendly)."""
    w = np.asarray(w)
    rows, cols = w.shape
    mask = w != 0
    row_nnz = mask.sum(axis=1).astype(np.int32)
    if width is None:
        width = int(row_nnz.max()) if rows else 0
    width = -(-max(1, width) // lane_pad) * lane_pad
    values = np.zeros((rows, width), w.dtype)
    colidx = np.zeros((rows, width), np.int32)
    # scatter: rank of each nonzero within its row
    ridx, cidx = np.nonzero(mask)
    if len(ridx):
        within = np.concatenate([np.arange(n) for n in row_nnz])
        values[ridx, within] = w[ridx, cidx]
        colidx[ridx, within] = cidx
    return ELL(
        values=jnp.asarray(values),
        colidx=jnp.asarray(colidx),
        row_nnz=jnp.asarray(row_nnz),
        shape=(rows, cols),
    )


# ---------------------------------------------------------------------------
# BSR (block compressed sparse row), padded per-blockrow ("block-ELL") layout
# ---------------------------------------------------------------------------


@_register
@dataclasses.dataclass(frozen=True)
class BSR:
    """Block-sparse matrix with fixed (bm, bk) blocks.

    Stored in padded per-block-row layout so all shapes are static:

    * ``blocks``    [n_brows, max_bw, bm, bk] — nonzero block payloads, zero
                    padded.
    * ``block_col`` [n_brows, max_bw] int32 — block-column index per slot;
                    padding slots point at block-column 0 with zero payload.
    * ``brow_nnz``  [n_brows] int32 — live slots per block row.

    Additionally a *flat* view used by the pallas scalar-prefetch kernel:
    ``flat_blocks`` [n_flat, bm, bk], ``flat_row``/``flat_col`` [n_flat]
    (n_flat = sum over rows, padded up so n_flat >= 1).
    """

    blocks: Array
    block_col: Array
    brow_nnz: Array
    flat_blocks: Array
    flat_row: Array
    flat_col: Array
    shape: Tuple[int, int] = _static_field(default=(0, 0))
    block_shape: Tuple[int, int] = _static_field(default=(0, 0))

    @property
    def n_brows(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def n_bcols(self) -> int:
        return -(-self.shape[1] // self.block_shape[1])

    @property
    def max_bw(self) -> int:
        return int(self.blocks.shape[1])

    @property
    def n_flat(self) -> int:
        return int(self.flat_blocks.shape[0])

    @property
    def nnz_blocks(self) -> int:
        return int(np.asarray(self.brow_nnz).sum())

    @property
    def block_density(self) -> float:
        return self.nnz_blocks / max(1, self.n_brows * self.n_bcols)

    def to_dense(self) -> Array:
        bm, bk = self.block_shape
        rows, cols = self.shape
        dense = jnp.zeros((self.n_brows, self.n_bcols, bm, bk), self.blocks.dtype)
        br = jnp.repeat(
            jnp.arange(self.n_brows, dtype=jnp.int32), self.block_col.shape[1]
        )
        dense = dense.at[br, self.block_col.reshape(-1)].add(
            self.blocks.reshape(-1, bm, bk)
        )
        return dense.transpose(0, 2, 1, 3).reshape(self.n_brows * bm, self.n_bcols * bk)[
            :rows, :cols
        ]


# ---------------------------------------------------------------------------
# BSC (block compressed sparse column), padded per-block-column layout
# ---------------------------------------------------------------------------


@_register
@dataclasses.dataclass(frozen=True)
class BSC:
    """Block-sparse matrix stored by *columns* of (bk, bn) blocks.

    This is the layout the conv kernels consume: for a GEMM-view conv weight
    W[K = KH*KW*Cin, N = Cout], each output-channel block-column j carries the
    list of its nonzero K-blocks. Because W's rows are ordered (kh, kw, cin)
    and bk divides Cin, every K-block index decodes statically to a single
    (kernel offset, cin-block) pair — the rebirth of the reference's
    "stretched" column index (`caffe_gpu_stretch`,
    `src/caffe/util/math_functions.cu:706-727`): the same block list drives
    both im2col+SpMM (index into columns) and direct conv (decode to a shifted
    ifmap slice).

    * ``blocks``    [n_bcols, max_bw, bk, bn] — zero-padded payloads.
    * ``block_row`` [n_bcols, max_bw] int32 — K-block index per slot; padding
                    slots point at K-block 0 with zero payload.
    * ``bcol_nnz``  [n_bcols] int32 — live slots per block column.

    Plus a *flat* view consumed by the Pallas scalar-prefetch kernels: all live
    blocks concatenated column-major (sorted by block column), with the
    invariant that EVERY block column contributes at least one slot (empty
    columns get one zero block) so every output tile is visited and
    initialized exactly once per revisit chain:

    * ``flat_blocks`` [n_flat, bk, bn], ``flat_row``/``flat_col`` [n_flat].
    """

    blocks: Array
    block_row: Array
    bcol_nnz: Array
    flat_blocks: Array
    flat_row: Array
    flat_col: Array
    shape: Tuple[int, int] = _static_field(default=(0, 0))
    block_shape: Tuple[int, int] = _static_field(default=(0, 0))

    @property
    def n_flat(self) -> int:
        return int(self.flat_blocks.shape[0])

    @property
    def n_bcols(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def n_brows(self) -> int:
        return -(-self.shape[0] // self.block_shape[0])

    @property
    def max_bw(self) -> int:
        return int(self.blocks.shape[1])

    @property
    def nnz_blocks(self) -> int:
        return int(np.asarray(self.bcol_nnz).sum())

    @property
    def block_density(self) -> float:
        return self.nnz_blocks / max(1, self.n_brows * self.n_bcols)

    def to_dense(self) -> Array:
        bk, bn = self.block_shape
        rows, cols = self.shape
        dense = jnp.zeros((self.n_brows, self.n_bcols, bk, bn), self.blocks.dtype)
        bc = jnp.repeat(
            jnp.arange(self.n_bcols, dtype=jnp.int32), self.block_row.shape[1]
        )
        dense = dense.at[self.block_row.reshape(-1), bc].add(
            self.blocks.reshape(-1, bk, bn)
        )
        return dense.transpose(0, 2, 1, 3).reshape(
            self.n_brows * bk, self.n_bcols * bn
        )[:rows, :cols]


def dense_to_bsc(w, block_shape: Tuple[int, int], pad_to: int = 1) -> BSC:
    """Dense (K, N) -> BSC with fixed (bk, bn) blocks (zero-padded edges).

    Large f32 weights route through the threaded native packer
    (csrc/csrpack.cc via data/native.py) — the WeightAlign hot path the
    reference runs in C++ (`base_conv_layer.cpp:46-273`); numpy fallback
    otherwise."""
    w = np.asarray(w)
    rows, cols = w.shape
    bk, bn = block_shape
    R, C = -(-rows // bk) * bk, -(-cols // bn) * bn
    wp = np.zeros((R, C), w.dtype)
    wp[:rows, :cols] = w
    n_brows, n_bcols = R // bk, C // bn
    blocked = wp.reshape(n_brows, bk, n_bcols, bn).transpose(2, 0, 1, 3)  # [bc, br, bk, bn]
    live = (blocked != 0).any(axis=(2, 3))  # [n_bcols, n_brows]
    bcol_nnz = live.sum(axis=1).astype(np.int32)
    max_bw = max(1, int(bcol_nnz.max()) if n_bcols else 1)
    max_bw = -(-max_bw // pad_to) * pad_to

    native_done = False
    if w.dtype == np.float32 and w.size >= 1 << 20 and pad_to == 1:
        from caffe_escoin_tpu.data.native import native_bsc_pack

        packed = native_bsc_pack(wp, (bk, bn))
        if packed is not None:
            blocks, block_row, nnz_native, max_bw_native = packed
            # native scan agrees with numpy by construction; trust-but-verify
            if (max_bw_native == max_bw
                    and np.array_equal(nnz_native, bcol_nnz)):
                native_done = True
    if not native_done:
        blocks = np.zeros((n_bcols, max_bw, bk, bn), w.dtype)
        block_row = np.zeros((n_bcols, max_bw), np.int32)
        bc, br = np.nonzero(live)
        if len(bc):
            within = np.concatenate([np.arange(n) for n in bcol_nnz])
            blocks[bc, within] = blocked[bc, br]
            block_row[bc, within] = br

    # flat view, column-major, every column >= 1 slot (zero filler if empty)
    f_blocks, f_row, f_col = [], [], []
    for j in range(n_bcols):
        rows_j = np.nonzero(live[j])[0]
        if len(rows_j) == 0:
            f_blocks.append(np.zeros((bk, bn), w.dtype))
            f_row.append(0)
            f_col.append(j)
        else:
            for r in rows_j:
                f_blocks.append(blocked[j, r])
                f_row.append(r)
                f_col.append(j)
    return BSC(
        blocks=jnp.asarray(blocks),
        block_row=jnp.asarray(block_row),
        bcol_nnz=jnp.asarray(bcol_nnz),
        flat_blocks=jnp.asarray(np.stack(f_blocks)),
        flat_row=jnp.asarray(np.asarray(f_row, np.int32)),
        flat_col=jnp.asarray(np.asarray(f_col, np.int32)),
        shape=(rows, cols),
        block_shape=(bk, bn),
    )


def dense_to_bsr(w, block_shape: Tuple[int, int], pad_to: int = 1) -> BSR:
    """Dense (rows, cols) -> BSR with fixed blocks. rows/cols are zero-padded
    up to block multiples. A block is "nonzero" iff any entry is nonzero.

    ``pad_to`` rounds max_bw up (keeps pallas grid sizes stable across layers
    with similar sparsity)."""
    w = np.asarray(w)
    rows, cols = w.shape
    bm, bk = block_shape
    R, C = -(-rows // bm) * bm, -(-cols // bk) * bk
    wp = np.zeros((R, C), w.dtype)
    wp[:rows, :cols] = w
    n_brows, n_bcols = R // bm, C // bk
    blocked = wp.reshape(n_brows, bm, n_bcols, bk).transpose(0, 2, 1, 3)
    live = (blocked != 0).any(axis=(2, 3))  # [n_brows, n_bcols]
    brow_nnz = live.sum(axis=1).astype(np.int32)
    max_bw = max(1, int(brow_nnz.max()) if n_brows else 1)
    max_bw = -(-max_bw // pad_to) * pad_to
    blocks = np.zeros((n_brows, max_bw, bm, bk), w.dtype)
    block_col = np.zeros((n_brows, max_bw), np.int32)
    br, bc = np.nonzero(live)
    within = np.concatenate([np.arange(n) for n in brow_nnz]) if len(br) else br
    blocks[br, within] = blocked[br, bc]
    block_col[br, within] = bc

    # flat view (row-major over live blocks), padded to >=1
    n_flat = max(1, len(br))
    flat_blocks = np.zeros((n_flat, bm, bk), w.dtype)
    flat_row = np.zeros(n_flat, np.int32)
    flat_col = np.zeros(n_flat, np.int32)
    if len(br):
        flat_blocks[: len(br)] = blocked[br, bc]
        flat_row[: len(br)] = br
        flat_col[: len(br)] = bc
    return BSR(
        blocks=jnp.asarray(blocks),
        block_col=jnp.asarray(block_col),
        brow_nnz=jnp.asarray(brow_nnz),
        flat_blocks=jnp.asarray(flat_blocks),
        flat_row=jnp.asarray(flat_row),
        flat_col=jnp.asarray(flat_col),
        shape=(rows, cols),
        block_shape=(bm, bk),
    )

"""Block-sparse SpMM through Pallas' Triton route: dense (M, K) @ BSC (K, N).

The executor for a sparsity pattern that is TRACED rather than closed over
(aligned weights passed as jit arguments, e.g. `__graft_entry__.entry`).
There the pattern is run-time data, so XLA cannot unroll it into static dots
(kernels/xla_block_sparse.py) and this kernel walks it in one launch. It is
the counterpart of cuSPARSE `csrmm2` on the lowered path
(`src/caffe/util/math_functions.cu:48-79`), at block granularity.

Design, for one GPU thread block per output tile:

* The grid is (M tiles, output block-columns). Program (i, j) reads its own
  ``bcol_nnz[j]`` and loops over column j's live K-blocks: for slot s it
  loads the (tile_m, bk) slice of A at K-block ``block_row[j, s]`` and the
  (bk, bn) weight block, and accumulates their `pl.dot` in float32. Zero
  blocks cost nothing; no program carries state to another.
* Rows past M are masked on load and store, so A and the output are never
  padded or copied along M.
* Triton pipelines the loop's loads over ``num_stages`` shared-memory
  buffers; `_config` keeps the stages under the block's shared memory.
* Float32 operands multiply in IEEE float32 unless the caller passes a
  TF32 precision: the kernel never loosens a float32 product on its own.
  Each weight block's product is then split into K chunks (``k_chunk``)
  so the CUDA-core dot's operands fit in registers.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from caffe_escoin_tpu.sparse.formats import BSC

# shared memory the pipelined loads may take: below the 227 KB a block can
# use, leaving room for Triton's epilogue layout conversion
_SMEM_BUDGET = 160 * 1024
# Triton's dot needs every operand dimension >= 16
_MIN_DOT_DIM = 16


def _pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def pallas_supported(bsc: BSC) -> bool:
    """Triton loads power-of-two shapes only, and its dot needs each
    dimension >= 16: both block dimensions must satisfy that."""
    bk, bn = bsc.block_shape
    return all(_pow2(d) and d >= _MIN_DOT_DIM for d in (bk, bn))


def _config(m: int, bk: int, bn: int, itemsize: int, tile_m=None):
    """(tile_m, k_chunk, num_warps, num_stages) for one call.

    bf16 operands: 64-row tiles, one tensor-core dot per weight block.
    float32 operands multiply in IEEE float32 on the CUDA cores, where a
    dot's operands live in registers: 32-row tiles and 16-deep K chunks
    keep them from spilling (measured on an H100 at the ResNet-50 GEMM
    views, see PERF.md)."""
    if tile_m is None:
        tile_m = 64 if itemsize <= 2 else 32
    k_chunk = bk if itemsize <= 2 else _MIN_DOT_DIM
    tile_m = max(_MIN_DOT_DIM, min(tile_m, pl.next_power_of_2(m)))
    stage_bytes = (tile_m * bk + bk * bn) * itemsize
    stages = max(1, min(3, _SMEM_BUDGET // stage_bytes))
    return tile_m, k_chunk, 4, stages


def _kernel(row_ref, nnz_ref, a_ref, w_ref, out_ref, *, m, tile_m, bk, bn,
            k_chunk, precision):
    i = pl.program_id(0)
    j = pl.program_id(1)
    rows = pl.ds(pl.multiple_of(i * tile_m, tile_m), tile_m)
    row_ok = (i * tile_m + jnp.arange(tile_m) < m)[:, None]

    def body(s, acc):
        k0 = pl.multiple_of(row_ref[j, s] * bk, bk)
        for c in range(0, bk, k_chunk):  # static: one dot per K chunk
            a = plt.load(a_ref.at[rows, pl.ds(k0 + c, k_chunk)],
                         mask=jnp.broadcast_to(row_ok, (tile_m, k_chunk)),
                         other=0)
            w = w_ref[j, s, pl.ds(c, k_chunk), :]
            acc = acc + pl.dot(a, w, precision=precision)
        return acc

    acc = lax.fori_loop(0, nnz_ref[j], body,
                        jnp.zeros((tile_m, bn), jnp.float32))
    plt.store(out_ref.at[rows, pl.ds(pl.multiple_of(j * bn, bn), bn)],
              acc.astype(out_ref.dtype),
              mask=jnp.broadcast_to(row_ok, (tile_m, bn)))


@functools.partial(
    jax.jit,
    static_argnames=("shape", "block_shape", "tile_m", "interpret",
                     "out_dtype_name", "precision"),
)
def _run(amat, blocks, block_row, bcol_nnz, *, shape, block_shape, tile_m,
         interpret, out_dtype_name, precision):
    bk, bn = block_shape
    k_logical, n_logical = shape
    m = amat.shape[0]
    n_bcols, max_bw = blocks.shape[:2]
    kp = -(-k_logical // bk) * bk
    if amat.shape[1] != kp:  # K tail: the last K-block reads zeros
        amat = jnp.pad(amat, ((0, 0), (0, kp - amat.shape[1])))
    # weights multiply in A's dtype (small, cast once); accumulation is f32
    blocks = blocks.astype(amat.dtype)
    tile_m, k_chunk, num_warps, num_stages = _config(
        m, bk, bn, jnp.dtype(amat.dtype).itemsize, tile_m)
    out = pl.pallas_call(
        functools.partial(_kernel, m=m, tile_m=tile_m, bk=bk, bn=bn,
                          k_chunk=k_chunk, precision=precision),
        grid=(pl.cdiv(m, tile_m), n_bcols),
        out_shape=jax.ShapeDtypeStruct((m, n_bcols * bn),
                                       jnp.dtype(out_dtype_name)),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps,
                                           num_stages=num_stages),
        interpret=interpret,
        name="bsc_spmm",
    )(block_row.astype(jnp.int32), bcol_nnz.astype(jnp.int32), amat, blocks)
    return out if n_bcols * bn == n_logical else out[:, :n_logical]


def bsc_spmm_pallas(amat, bsc: BSC, *, out_dtype=None, precision=None,
                    interpret: bool = False, tile_m=None):
    """amat: (M, K) dense; bsc: (K, N). Returns (M, N) in ``out_dtype``
    (default amat's dtype).

    ``precision`` is the product's `lax.Precision`. Float32 operands default
    to HIGHEST (IEEE float32); pass DEFAULT or HIGH to allow TF32. For
    bf16 operands it has no effect."""
    if amat.shape[1] != bsc.shape[0]:
        raise ValueError(f"amat cols {amat.shape[1]} != sparse K {bsc.shape[0]}")
    if not pallas_supported(bsc):
        raise ValueError(f"block shape {bsc.block_shape} outside the Triton "
                         "route's constraints (powers of two, >= 16)")
    out_dtype = jnp.dtype(out_dtype or amat.dtype)
    if precision is None:
        precision = (lax.Precision.HIGHEST if amat.dtype == jnp.float32
                     else lax.Precision.DEFAULT)
    return _run(
        amat,
        bsc.blocks,
        bsc.block_row,
        bsc.bcol_nnz,
        shape=bsc.shape,
        block_shape=bsc.block_shape,
        tile_m=tile_m,
        interpret=interpret,
        out_dtype_name=out_dtype.name,
        precision=lax.Precision(precision),
    )

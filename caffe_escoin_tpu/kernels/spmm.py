"""Sparse-matrix x dense-matrix products (SpMM): portable jnp executors.

The reference's counterpart is cuSPARSE `csrmm2` for the lowered path
(`src/caffe/util/math_functions.cu:48-79` caffe_gpu_sparse_csrmm) and MKL
`mkl_scsrmm` on CPU (`src/caffe/util/math_functions.cpp:36-75`). Here:

* ``ell_spmm`` — unstructured sparsity. A fixed-trip-count scan over padded
  row slots; each step is a full-width row gather + FMA. This is the
  reference GPU kernel's per-nonzero gather-FMA loop
  (`math_functions.cu:298-308`) restructured so every step is a *vectorized*
  (rows, N) operation instead of a per-thread scalar.
* ``bsr_spmm`` — block-structured sparsity. A scan over padded block slots;
  each step is a batched (bm, bk) @ (bk, N) matmul. Zero blocks are never
  touched: compute scales with nnz_blocks/max_bw per row.
* ``bsc_spmm`` — the dense x BSC orientation of the same scan; the Pallas
  kernel (kernels/bsc_pallas.py) walks the pattern without the padding
  slots or the per-column copies of A (``bsc_spmm_traced`` picks).

Both are jit-compatible (static shapes, lax control flow) and differentiable
w.r.t. the dense operand.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from caffe_escoin_tpu.sparse.formats import BSC, BSR, ELL


def ell_spmm(ell: ELL, bmat, *, preferred_element_type=jnp.float32):
    """out[r, n] = sum_j ell.values[r, j] * bmat[ell.colidx[r, j], n].

    ell: (R, K) sparse; bmat: (K, N) dense -> (R, N).
    Padding slots have value 0 so they contribute nothing.
    """
    values, colidx = ell.values, ell.colidx
    rows, width = values.shape
    n = bmat.shape[1]

    def term(j):
        rows_gathered = jnp.take(bmat, colidx[:, j], axis=0)  # (R, N)
        return values[:, j][:, None].astype(preferred_element_type) * (
            rows_gathered.astype(preferred_element_type)
        )

    # seed with slot 0 (width >= 1 by construction) instead of zeros: keeps
    # the carry's device-varying type under shard_map
    return lax.fori_loop(1, width, lambda j, acc: acc + term(j), term(0))


def bsr_spmm(bsr: BSR, bmat, *, preferred_element_type=jnp.float32):
    """Block-sparse matmul: (R, K) BSR @ (K, N) dense -> (R, N).

    bmat rows beyond K (when K was padded up to a block multiple) are treated
    as zero; callers pass bmat of logical height K and we pad here.
    """
    bm, bk = bsr.block_shape
    n_brows, max_bw = bsr.block_col.shape
    rows, k = bsr.shape
    n = bmat.shape[1]
    if bmat.shape[0] != k:
        raise ValueError(f"bmat rows {bmat.shape[0]} != sparse K {k}")
    kp = bsr.n_bcols * bk
    if k != kp:
        bmat = jnp.pad(bmat, ((0, kp - k), (0, 0)))
    bblocks = bmat.reshape(bsr.n_bcols, bk, n)

    def term(s):
        w_s = bsr.blocks[:, s]  # (n_brows, bm, bk)
        b_s = jnp.take(bblocks, bsr.block_col[:, s], axis=0)  # (n_brows, bk, N)
        return jnp.einsum(
            "rik,rkn->rin", w_s, b_s, preferred_element_type=preferred_element_type
        )

    out = lax.fori_loop(1, max_bw, lambda s, acc: acc + term(s), term(0))
    return out.reshape(n_brows * bm, n)[:rows]


def bsc_spmm(amat, bsc: BSC, *, preferred_element_type=jnp.float32):
    """Dense x block-sparse: (M, K) @ (K, N) BSC -> (M, N).

    The conv lowered path's natural orientation: amat = im2col patches,
    bsc = GEMM-view weight. A scan over padded block slots; each step gathers
    one K-block of A per output block-column and runs a batched matmul.
    """
    bk, bn = bsc.block_shape
    m = amat.shape[0]
    k = bsc.shape[0]
    if amat.shape[1] != k:
        raise ValueError(f"amat cols {amat.shape[1]} != sparse K {k}")
    kp = bsc.n_brows * bk
    if k != kp:
        amat = jnp.pad(amat, ((0, 0), (0, kp - k)))
    ablocks = amat.reshape(m, bsc.n_brows, bk)

    def term(s):
        a_s = jnp.take(ablocks, bsc.block_row[:, s], axis=1)  # (M, n_bcols, bk)
        w_s = bsc.blocks[:, s]  # (n_bcols, bk, bn)
        return jnp.einsum(
            "mjk,jkn->mjn", a_s, w_s, preferred_element_type=preferred_element_type
        )

    out = lax.fori_loop(1, bsc.max_bw, lambda s, acc: acc + term(s), term(0))
    return out.reshape(m, bsc.n_bcols * bn)[:, : bsc.shape[1]]


def bsc_spmm_traced(amat, bsc: BSC, policy=None):
    """Dense x BSC for a pattern known only at run time: the Pallas kernel
    (kernels/bsc_pallas.py) where the policy enables it and the block shape
    fits its route, else `bsc_spmm`."""
    from caffe_escoin_tpu.engine.context import ExecutionPolicy
    from caffe_escoin_tpu.kernels import bsc_pallas

    policy = policy or ExecutionPolicy()
    if policy.pallas_enabled() and bsc_pallas.pallas_supported(bsc):
        return bsc_pallas.bsc_spmm_pallas(amat, bsc,
                                          interpret=policy.interpret)
    return bsc_spmm(amat, bsc)


def spmm(sparse, bmat, **kw):
    """Dispatch on format."""
    if isinstance(sparse, ELL):
        return ell_spmm(sparse, bmat, **kw)
    if isinstance(sparse, BSR):
        return bsr_spmm(sparse, bmat, **kw)
    raise TypeError(f"unsupported sparse operand {type(sparse)!r}")

"""Inner product (fully connected) with optional sparse weight execution.

Reference: `src/caffe/layers/inner_product_layer.cpp` (dense GEMM) — the FC
timing bucket of the paper's benchmarks. Sparse FC reuses the same SpMM
machinery as the lowered conv path (the reference never sparsified FC; this is
a capability superset that falls out of the unified GEMM view).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from caffe_escoin_tpu.engine.context import ExecutionPolicy
from caffe_escoin_tpu.kernels import spmm as spmm_kernels
from caffe_escoin_tpu.sparse.formats import BSC, ELL


def linear(x, w, bias=None, *, relu=False):
    """x: [..., K] @ w: [K, M] (+ bias[M])."""
    out = jnp.dot(x, w, preferred_element_type=jnp.float32).astype(x.dtype)
    if bias is not None:
        out = out + bias
    if relu:
        out = jnp.maximum(out, 0.0)
    return out


def linear_sparse(x, sparse_w, bias=None, *, relu=False,
                  policy: Optional[ExecutionPolicy] = None):
    """Sparse-weight FC. sparse_w: BSC of W[K, M] or ELL of W^T[M, K].

    BSC with a trace-time-concrete pattern (weights closed over — the
    inference deployment) routes through the XBSP static block unroll,
    the same fast executor the conv path uses; zero blocks cost nothing
    and the bias/relu epilogue fuses per block-column. Traced patterns
    run the run-time SpMM executor (`spmm.bsc_spmm_traced`)."""
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    if isinstance(sparse_w, BSC):
        from caffe_escoin_tpu.kernels import xla_block_sparse

        m = sparse_w.shape[1]
        if xla_block_sparse.spmm_supported(sparse_w, policy):
            out = xla_block_sparse.spmm(x2d, sparse_w, bias=bias,
                                        relu=relu).reshape(*lead, m)
            return out
        out2d = spmm_kernels.bsc_spmm_traced(x2d, sparse_w, policy)
    elif isinstance(sparse_w, ELL):
        out2d = spmm_kernels.ell_spmm(sparse_w, x2d.T).T
        m = sparse_w.shape[0]
    else:
        raise TypeError(type(sparse_w))
    out = out2d.reshape(*lead, m)
    if bias is not None:
        out = out + bias
    if relu:
        out = jnp.maximum(out, 0.0)
    return out

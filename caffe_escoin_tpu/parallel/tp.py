"""Tensor parallelism: output-channel (weight row/block) partitioning.

Not present in the reference (SURVEY.md section 2.3: "Tensor parallelism —
No"); BASELINE.json asks for weight matrices row/block-partitioned across the
mesh. Two mechanisms:

* **Dense/GSPMD**: annotate conv/FC weights with P(..., "model") shardings and
  jit the whole net — XLA's SPMD partitioner propagates activation shardings
  and inserts all-gathers where layers need full channels (LRN, shortcuts).
  This is the idiomatic XLA path: no explicit collectives in user code.
* **Sparse/shard_map**: the BSC block-column arrays are sharded on their
  leading (cout block-column) axis; each device runs the run-time SpMM
  executor on its local block columns, producing its cout slice. Activations are replicated
  in, outputs stay cout-sharded (gather only when a consumer needs them
  unsharded).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from caffe_escoin_tpu.sparse.formats import BSC
from caffe_escoin_tpu.sparse.weight_align import AlignedConvWeight


def param_shardings(net, params, mesh: Mesh):
    """Sharding pytree for GSPMD tensor parallelism: conv HWIO weights and FC
    (K, M) weights sharded on the output-channel axis, biases likewise,
    everything else replicated."""

    def spec_for(path_key, leaf):
        if hasattr(leaf, "ndim"):
            if leaf.ndim == 4:  # HWIO conv weight
                return NamedSharding(mesh, P(None, None, None, "model"))
            if leaf.ndim == 2:  # FC (K, M)
                return NamedSharding(mesh, P(None, "model"))
            if leaf.ndim == 1:  # bias / bn stats
                return NamedSharding(mesh, P("model"))
        return NamedSharding(mesh, P())

    out = {}
    for name, p in params.items():
        if isinstance(p, AlignedConvWeight):
            out[name] = NamedSharding(mesh, P())  # sparse TP via shard_map
        else:
            out[name] = jax.tree_util.tree_map(
                lambda l: spec_for(name, l), p
            )
    return out


def shard_bsc_cout(bsc: BSC, n_dev: int):
    """Validate + describe the cout-block partitioning of a BSC. Returns the
    per-device local n_bcols. Requires n_bcols % n_dev == 0 (pad cout at
    weight-align time for uneven cases)."""
    if bsc.n_bcols % n_dev != 0:
        raise ValueError(
            f"n_bcols {bsc.n_bcols} not divisible by model axis {n_dev}"
        )
    return bsc.n_bcols // n_dev


def tp_conv_lowered(x, aligned: AlignedConvWeight, *, mesh: Mesh,
                    stride=(1, 1), padding=(0, 0), dilation=(1, 1),
                    relu=False, policy=None, axis_name: str = "model"):
    """Lowered sparse conv with cout-sharded BSC over `axis_name`.
    x replicated in; output [N,Ho,Wo,Cout_padded] cout-sharded out.
    Call with concrete (non-traced) `aligned` (shard_map closure rule)."""
    from caffe_escoin_tpu.engine.context import ExecutionPolicy
    from caffe_escoin_tpu.kernels.spmm import bsc_spmm_traced
    from caffe_escoin_tpu.ops.conv import im2col

    policy = policy or ExecutionPolicy()
    bsc = aligned.bsc
    n_dev = mesh.shape[axis_name]
    local_nb = shard_bsc_cout(bsc, n_dev)
    bk, bn = bsc.block_shape
    kh, kw = aligned.kernel_shape

    cols, (ho, wo) = im2col(x, (kh, kw), stride=stride, padding=padding,
                            dilation=dilation)
    n = x.shape[0]
    cols2d = cols.reshape(n * ho * wo, kh * kw, aligned.cin)
    if aligned.cin_pad != aligned.cin:
        cols2d = jnp.pad(cols2d, ((0, 0), (0, 0),
                                  (0, aligned.cin_pad - aligned.cin)))
    cols2d = cols2d.reshape(n * ho * wo, aligned.k)

    local_shape = (bsc.shape[0], local_nb * bn)

    def fn(cols_l, blocks_l, brow_l, bnnz_l, bias_l):
        local = dataclasses.replace(
            bsc, blocks=blocks_l, block_row=brow_l, bcol_nnz=bnnz_l,
            shape=local_shape,
        )
        out = bsc_spmm_traced(cols_l, local, policy)
        out = out + bias_l
        if relu:
            out = jnp.maximum(out, 0.0)
        return out

    bias = aligned.bias
    if bias is None:
        bias = jnp.zeros((aligned.cout,), x.dtype)
    bias_p = jnp.pad(bias, (0, bsc.n_bcols * bn - bias.shape[0]))

    out = jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(), P(axis_name), P(axis_name), P(axis_name), P(axis_name)),
        out_specs=P(None, axis_name),
        check_vma=False,  # pallas outputs carry no varying-axis metadata
    )(cols2d, bsc.blocks, bsc.block_row, bsc.bcol_nnz, bias_p)
    # out: (M, n_bcols*bn) cout-sharded; slice logical cout + reshape
    return out[:, : aligned.cout].reshape(n, ho, wo, aligned.cout)

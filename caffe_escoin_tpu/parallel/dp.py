"""Data parallelism: batch-sharded training and inference steps.

Reference counterpart: the whole of `src/caffe/parallel.cpp` — per-GPU solver
replicas, rank-0 weight broadcast, gradient ncclAllReduce + 1/N scaling
(`parallel.cpp:189-256`). Here all of that machinery collapses into
shardings: params replicated over the mesh, batch split on the ``data`` axis;
XLA inserts the gradient all-reduce (the psum) during SPMD partitioning, and
overlap with backward compute comes from the latency-hiding scheduler rather
than the reference's hand-rolled side-stream `layer_wise_reduce`.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from caffe_escoin_tpu.engine import solvers
from caffe_escoin_tpu.nn.net import Net


def shard_batch(mesh: Mesh, batch: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
    s = NamedSharding(mesh, P("data"))
    return {k: jax.device_put(v, s) for k, v in batch.items()}


def replicate_params(mesh: Mesh, params):
    s = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, s), params)


def make_dp_train_step(net: Net, cfg: solvers.SolverConfig, mesh: Mesh):
    """Returns jitted (params, state, net_state, batch, lr, it, rng) ->
    (params, state, net_state, loss) with batch sharded over `data` and
    params/state replicated. net_state carries non-trainable buffers
    (BatchNorm moving stats); under batch sharding the batch statistics are
    computed over the GLOBAL batch (XLA inserts the cross-device mean), so
    the moving-average update is replica-identical by construction — the
    reference's per-GPU BN, by contrast, averaged only local stats."""
    rep = NamedSharding(mesh, P())
    bsharded = NamedSharding(mesh, P("data"))

    def step(params, state, net_state, batch, lr, it, rng):
        def loss_of(p, ns):
            return net.loss(p, batch, train=True, rng=rng, state=ns,
                            return_state=True)

        (loss, new_ns), grads = jax.value_and_grad(loss_of, has_aux=True)(
            params, net_state)
        grads = solvers.regularize(cfg, params, grads)
        grads = solvers.clip_gradients(cfg, grads)
        new_params, new_state = solvers.update(cfg, params, grads, state, lr, it)
        return new_params, new_state, new_ns, loss

    return jax.jit(
        step,
        in_shardings=(rep, rep, rep, {"data": bsharded, "label": bsharded},
                      None, None, None),
        out_shardings=(rep, rep, rep, None),
    )


def make_dp_eval_step(net: Net, mesh: Mesh):
    rep = NamedSharding(mesh, P())
    bsharded = NamedSharding(mesh, P("data"))

    def fwd(params, batch):
        return net.apply(params, batch)

    return jax.jit(fwd, in_shardings=(rep, {"data": bsharded}))

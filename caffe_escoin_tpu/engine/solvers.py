"""SGD-family solvers with Caffe-exact update rules.

Reference: `src/caffe/solvers/{sgd,nesterov,adagrad,rmsprop,adadelta,
adam}_solver.cpp` (922 LoC of C++/CUDA update kernels). Here each solver is a
pair of pure functions (init_state, update) over parameter pytrees — the
whole update jits and pjits (on a mesh, gradients arrive already psum-med, so
multi-chip data parallelism needs no NCCL analogue at this layer).

Caffe formula notes (these differ from optax/torch conventions, and the
gradient-based-solver tests check them analytically, mirroring
`src/caffe/test/test_gradient_based_solver.cpp`):

* SGD:       v = momentum*v + lr*g ;  w -= v          (sgd_solver.cpp:213-243)
* Nesterov:  v' = momentum*v + lr*g ; w -= (1+momentum)*v' - momentum*v
* AdaGrad:   h += g^2 ;  w -= lr * g / (sqrt(h) + eps)
* RMSProp:   h = delta*h + (1-delta)*g^2 ; w -= lr * g / (sqrt(h) + eps)
* AdaDelta:  h = m*h + (1-m)*g^2 ;
             u = g * sqrt((h2 + eps) / (h + eps)) ;
             h2 = m*h2 + (1-m)*u^2 ;  w -= lr * u
* Adam:      m = b1*m + (1-b1)*g ; v = b2*v + (1-b2)*g^2 ;
             w -= lr * sqrt(1-b2^t)/(1-b1^t) * m / (sqrt(v) + eps)

Regularization (SGDSolver::Regularize, sgd_solver.cpp:144-206): L2 adds
decay*w to the gradient, L1 adds decay*sign(w) — the fork's pruning pressure
via `ParamSpec.regularization_type` maps to per-leaf regularization overrides.
Gradient normalization by iter_size and L2-norm clipping mirror
Normalize/ClipGradients (sgd_solver.cpp:102-142).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp

Pytree = Any


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    solver_type: str = "sgd"  # sgd|nesterov|adagrad|rmsprop|adadelta|adam
    base_lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 0.0
    regularization_type: str = "L2"  # "L1" | "group_lasso" (block-L1)
    # block shape for group_lasso regularization (matches the executor's
    # BSC block granularity so the pressure shrinks whole skippable
    # blocks — the SSL/group-lasso route to structured sparsity)
    group_block: tuple = (128, 128)
    delta: float = 1e-8  # eps for adaptive solvers
    rms_decay: float = 0.99
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    clip_gradients: float = -1.0  # <=0 disables
    iter_size: int = 1
    # lr policy
    lr_policy: str = "fixed"
    gamma: float = 0.1
    step_size: int = 100000
    stepvalues: tuple = ()
    power: float = 1.0
    max_iter: int = 100000


def group_lasso_grad(w, block, eps: float = 1e-12):
    """d/dw of sum_b ||w_b||_2 over (bm, bk) blocks of the weight's GEMM
    view: w / ||block(w)||, the group-lasso (SSL-style) pressure that
    shrinks whole blocks toward zero — the block-granular analogue of the
    reference's L1 `regularization_type` pruning lever
    (`caffe.proto:307-308`, `sgd_solver.cpp:144-206`). Blocks match the
    executor's BSC granularity so regularization-driven sparsity is
    exactly the sparsity the block executors can skip. Conv weights [kh, kw,
    ci, co] block their per-offset (ci, co) planes (the direct-conv BSC
    structure); 2-D fc weights block directly; other ranks fall back to
    plain L2 direction (w)."""
    if w.ndim == 4:
        kh, kw, ci, co = w.shape
        w2 = w.reshape(kh * kw, ci, co)
    elif w.ndim == 2:
        w2 = w.reshape((1,) + w.shape)
    else:
        return w
    bm, bk = block
    R = -(-w2.shape[1] // bm) * bm
    C = -(-w2.shape[2] // bk) * bk
    wp = jnp.pad(w2, ((0, 0), (0, R - w2.shape[1]), (0, C - w2.shape[2])))
    b = wp.reshape(wp.shape[0], R // bm, bm, C // bk, bk)
    norms = jnp.sqrt((b * b).sum(axis=(2, 4), keepdims=True) + eps)
    g = (b / norms).reshape(wp.shape)[:, : w2.shape[1], : w2.shape[2]]
    return g.reshape(w.shape)


def regularize(cfg: SolverConfig, params: Pytree, grads: Pytree,
               reg_overrides: Optional[Dict[str, str]] = None,
               decay_mults: Optional[Pytree] = None) -> Pytree:
    """Add decay term to gradients. reg_overrides maps layer name -> "L1"/"L2"
    (the `ParamSpec.regularization_type` analogue, caffe.proto:307-308).
    decay_mults is a params-congruent pytree of per-blob multipliers
    (ParamSpec.decay_mult, caffe.proto:300-310; applied as
    local_decay = weight_decay * decay_mult, `sgd_solver.cpp:144-206` —
    how Caffe models zero-decay their biases)."""
    if cfg.weight_decay == 0.0:
        return grads

    def leaf(path_name, w, g, dm=1.0):
        kind = (reg_overrides or {}).get(path_name, cfg.regularization_type)
        decay = cfg.weight_decay * dm
        if kind == "L1":
            return g + decay * jnp.sign(w)
        if kind == "group_lasso":
            return g + decay * group_lasso_grad(w, cfg.group_block)
        return g + decay * w

    if reg_overrides or decay_mults is not None:
        out = {}
        for name in grads:
            if decay_mults is not None and name in decay_mults:
                out[name] = jax.tree_util.tree_map(
                    lambda w, g, dm, n=name: leaf(n, w, g, dm),
                    params[name], grads[name], decay_mults[name])
            else:
                out[name] = jax.tree_util.tree_map(
                    lambda w, g, n=name: leaf(n, w, g),
                    params[name], grads[name])
        return out
    return jax.tree_util.tree_map(lambda w, g: leaf(None, w, g), params, grads)


def clip_gradients(cfg: SolverConfig, grads: Pytree) -> Pytree:
    if cfg.clip_gradients <= 0:
        return grads
    leaves = jax.tree_util.tree_leaves(grads)
    norm = jnp.sqrt(sum(jnp.sum(g * g) for g in leaves))
    scale = jnp.where(norm > cfg.clip_gradients, cfg.clip_gradients / norm, 1.0)
    return jax.tree_util.tree_map(lambda g: g * scale, grads)


def init_state(cfg: SolverConfig, params: Pytree) -> Pytree:
    zeros = lambda: jax.tree_util.tree_map(jnp.zeros_like, params)
    t = cfg.solver_type
    if t in ("sgd", "nesterov", "adagrad", "rmsprop"):
        return {"h": zeros()}
    if t == "adadelta":
        return {"h": zeros(), "h2": zeros()}
    if t == "adam":
        return {"m": zeros(), "v": zeros()}
    raise ValueError(f"unknown solver {t!r}")


def update(cfg: SolverConfig, params: Pytree, grads: Pytree, state: Pytree,
           lr, it=None, lr_mults: Optional[Pytree] = None):
    """One solver step. Returns (new_params, new_state). `lr` may be a traced
    scalar; `it` (1-based iteration) is needed by adam.

    ``lr_mults`` is a params-congruent pytree of per-blob LR multipliers
    (ParamSpec.lr_mult, caffe.proto:300-310): each blob steps with
    local_rate = lr * lr_mult, matching `sgd_solver.cpp`'s
    GetLearningRate-per-param — lr_mult 0 freezes a blob, 2 doubles its
    bias LR (the Caffe convention). Accumulator statistics (adagrad/adam
    moments) stay unscaled, exactly like the reference (the multiplier
    applies in ComputeUpdateValue, not to the raw gradient)."""
    tmap = jax.tree_util.tree_map
    if lr_mults is None:
        lrs = tmap(lambda p: lr, params)
    else:
        lrs = tmap(lambda m: lr * m, lr_mults)
    t = cfg.solver_type
    if t == "sgd":
        v = tmap(lambda h, g, l: cfg.momentum * h + l * g,
                 state["h"], grads, lrs)
        return tmap(lambda w, vi: w - vi, params, v), {"h": v}
    if t == "nesterov":
        v = tmap(lambda h, g, l: cfg.momentum * h + l * g,
                 state["h"], grads, lrs)
        upd = tmap(lambda vn, vo: (1 + cfg.momentum) * vn - cfg.momentum * vo,
                   v, state["h"])
        return tmap(lambda w, u: w - u, params, upd), {"h": v}
    if t == "adagrad":
        h = tmap(lambda h, g: h + g * g, state["h"], grads)
        new = tmap(lambda w, g, hi, l: w - l * g / (jnp.sqrt(hi) + cfg.delta),
                   params, grads, h, lrs)
        return new, {"h": h}
    if t == "rmsprop":
        d = cfg.rms_decay
        h = tmap(lambda h, g: d * h + (1 - d) * g * g, state["h"], grads)
        new = tmap(lambda w, g, hi, l: w - l * g / (jnp.sqrt(hi) + cfg.delta),
                   params, grads, h, lrs)
        return new, {"h": h}
    if t == "adadelta":
        mom = cfg.momentum
        h = tmap(lambda h, g: mom * h + (1 - mom) * g * g, state["h"], grads)
        u = tmap(
            lambda g, hi, h2: g * jnp.sqrt((h2 + cfg.delta) / (hi + cfg.delta)),
            grads, h, state["h2"],
        )
        h2 = tmap(lambda h2, ui: mom * h2 + (1 - mom) * ui * ui, state["h2"], u)
        return (tmap(lambda w, ui, l: w - l * ui, params, u, lrs),
                {"h": h, "h2": h2})
    if t == "adam":
        b1, b2 = cfg.adam_beta1, cfg.adam_beta2
        m = tmap(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
        v = tmap(lambda v, g: b2 * v + (1 - b2) * g * g, state["v"], grads)
        it = jnp.asarray(1 if it is None else it, jnp.float32)
        corr = jnp.sqrt(1.0 - b2 ** it) / (1.0 - b1 ** it)
        new = tmap(
            lambda w, mi, vi, l: w - l * corr * mi / (jnp.sqrt(vi) + cfg.delta),
            params, m, v, lrs)
        return new, {"m": m, "v": v}
    raise ValueError(f"unknown solver {t!r}")


# Caffe blob order per layer type (param_specs[i] addresses blobs[i]);
# default is (weights, bias)
_BLOB_ORDER = {
    "Scale": ("gamma", "beta"),
    "PReLU": ("alpha",),
    "Parameter": ("w",),
    "Embed": ("w",),
}


def param_multipliers(net, params):
    """Derive (lr_mults, decay_mults) pytrees from the net's ParamSpec
    entries (`spec.params["param_specs"]`, as parsed from prototxt
    `param { lr_mult decay_mult }` blocks or set on LayerSpecs directly).

    Returns (None, None) when no layer declares multipliers — the common
    case keeps the scalar-lr fast path."""
    any_set = False
    lr_mults: Dict[str, Any] = {}
    decay_mults: Dict[str, Any] = {}
    for layer in net.layers:
        name = layer.spec.name
        if name not in params or not isinstance(params[name], dict):
            continue
        order = _BLOB_ORDER.get(layer.spec.type, ("w", "b"))
        pspecs = layer.spec.params.get("param_specs") or []
        lm = {k: 1.0 for k in params[name]}
        dm = {k: 1.0 for k in params[name]}
        for i, ps in enumerate(pspecs):
            if i >= len(order) or order[i] not in params[name]:
                continue
            if "lr_mult" in ps or "decay_mult" in ps:
                any_set = True
            lm[order[i]] = float(ps.get("lr_mult", 1.0))
            dm[order[i]] = float(ps.get("decay_mult", 1.0))
        lr_mults[name] = lm
        decay_mults[name] = dm
    if not any_set:
        return None, None
    return lr_mults, decay_mults

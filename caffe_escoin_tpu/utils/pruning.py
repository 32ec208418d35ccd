"""Weight pruning utilities.

The reference consumes pre-pruned SkimCaffe/GESL models (`run.sh:3-5`); it does
not prune itself beyond L1 regularization pressure during training
(`src/caffe/solvers/sgd_solver.cpp:144-206`, `ParamSpec.regularization_type`).
This framework must *produce* its own sparse models for benchmarks, so we
provide magnitude pruning at two granularities:

* element-wise (unstructured) — parity with the reference's CSR models;
* block-wise — prunes (bm, bk) blocks by Frobenius norm, producing BSR-friendly
  structured sparsity that the block-skipping executors turn into wall-clock
  speedup (an unstructured 90%-sparse matrix has almost no empty 128-wide
  blocks).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np


def prune_magnitude(w, sparsity: float):
    """Zero out the smallest-|w| fraction ``sparsity`` of entries."""
    w = np.asarray(w).copy()
    if sparsity <= 0:
        return w
    k = int(round(w.size * sparsity))
    if k >= w.size:
        return np.zeros_like(w)
    if k == 0:
        return w
    thresh = np.partition(np.abs(w).ravel(), k - 1)[k - 1]
    w[np.abs(w) <= thresh] = 0
    return w


def prune_blocks(w, sparsity: float, block_shape: Tuple[int, int]):
    """Zero out the lowest-norm fraction ``sparsity`` of (bm, bk) blocks of a
    2-D matrix (zero-padding partial edge blocks into consideration)."""
    w = np.asarray(w).copy()
    rows, cols = w.shape
    bm, bk = block_shape
    R, C = -(-rows // bm) * bm, -(-cols // bk) * bk
    wp = np.zeros((R, C), w.dtype)
    wp[:rows, :cols] = w
    nbr, nbc = R // bm, C // bk
    blocked = wp.reshape(nbr, bm, nbc, bk).transpose(0, 2, 1, 3)
    norms = np.sqrt((blocked.astype(np.float64) ** 2).sum(axis=(2, 3)))
    n_blocks = nbr * nbc
    k = int(round(n_blocks * sparsity))
    if k > 0:
        flat = norms.ravel()
        if k >= n_blocks:
            blocked[:] = 0
        else:
            thresh = np.partition(flat, k - 1)[k - 1]
            blocked[norms <= thresh] = 0
    out = blocked.transpose(0, 2, 1, 3).reshape(R, C)[:rows, :cols]
    return out


def prune_conv_weight(w_hwio, sparsity: float, block_shape=None):
    """Prune a conv weight [KH,KW,Cin,Cout]. If ``block_shape`` is given the
    weight is pruned block-wise in its per-offset (Cin, Cout) GEMM views
    (matching the direct-conv per-offset BSC execution), with blocks ranked
    GLOBALLY across all kernel offsets — per-offset ranking would zero whole
    small layers through rounding. Otherwise element-wise magnitude."""
    w = np.asarray(w_hwio)
    if block_shape is None:
        return prune_magnitude(w, sparsity)
    kh, kw, cin, cout = w.shape
    bm, bk = block_shape
    R, C = -(-cin // bm) * bm, -(-cout // bk) * bk
    nbr, nbc = R // bm, C // bk
    # blocked view over all offsets: [kh*kw, nbr, nbc, bm, bk]
    wp = np.zeros((kh * kw, R, C), w.dtype)
    wp[:, :cin, :cout] = w.reshape(kh * kw, cin, cout)
    blocked = wp.reshape(kh * kw, nbr, bm, nbc, bk).transpose(0, 1, 3, 2, 4)
    norms = np.sqrt((blocked.astype(np.float64) ** 2).sum(axis=(3, 4)))
    n_blocks = norms.size
    # never prune a layer to emptiness: keep at least one block (a
    # fully-zero conv would make downstream benchmarks measure nothing)
    k = min(int(round(n_blocks * sparsity)), n_blocks - 1) if sparsity < 1 \
        else n_blocks
    if k > 0:
        if k >= n_blocks:
            blocked[:] = 0
        else:
            thresh = np.partition(norms.ravel(), k - 1)[k - 1]
            blocked[norms <= thresh] = 0
    out = blocked.transpose(0, 1, 3, 2, 4).reshape(kh * kw, R, C)[:, :cin, :cout]
    return out.reshape(kh, kw, cin, cout)


def prune_net_params(net, params, sparsity: float,
                     block_shape: Optional[Tuple[int, int]] = (128, 128)):
    """Prune a Net's conv and InnerProduct weights for a sparse deployment:
    block-wise in ``block_shape`` tiles, or element-wise when it is None.
    The stem conv over the image (fewer than 32 input channels) stays
    dense. Returns a new params dict; other layers' params are shared."""
    import jax.numpy as jnp

    out = dict(params)
    for layer in net.layers:
        name, kind = layer.spec.name, layer.spec.type
        p = params.get(name)
        if not isinstance(p, dict) or "w" not in p:
            continue
        w = np.asarray(p["w"])
        if kind in ("Convolution", "ConvolutionReLU"):
            if w.shape[2] < 32:
                continue
            q = prune_conv_weight(w, sparsity, block_shape)
        elif kind == "InnerProduct":
            q = (prune_magnitude(w, sparsity) if block_shape is None
                 else prune_blocks(w, sparsity, block_shape))
        else:
            continue
        out[name] = dict(p, w=jnp.asarray(q))
    return out


def sparsity_of(w) -> float:
    w = np.asarray(w)
    return float((w == 0).mean())


def densify_blocks(w, block_shape: Tuple[int, int], min_density: float):
    """Convert an unstructured-sparse matrix into a block-executable one by
    zeroing blocks whose element density is below ``min_density`` (the lossy
    step of deploying an unstructured checkpoint on block-skipping
    executors; pair with masked fine-tuning to recover accuracy).

    Returns (w_densified, stats) with the extra-zeroed weight fraction and
    the resulting block density."""
    w = np.asarray(w).copy()
    rows, cols = w.shape
    bm, bk = block_shape
    R, C = -(-rows // bm) * bm, -(-cols // bk) * bk
    wp = np.zeros((R, C), w.dtype)
    wp[:rows, :cols] = w
    blocked = wp.reshape(R // bm, bm, C // bk, bk).transpose(0, 2, 1, 3)
    dens = (blocked != 0).mean(axis=(2, 3))
    nnz_before = int((w != 0).sum())
    kill = dens < min_density
    blocked[kill] = 0
    out = blocked.transpose(0, 2, 1, 3).reshape(R, C)[:rows, :cols]
    nnz_after = int((out != 0).sum())
    stats = dict(
        nnz_before=nnz_before,
        nnz_after=nnz_after,
        extra_zeroed_frac=round(
            (nnz_before - nnz_after) / max(1, nnz_before), 4),
        block_density=round(float((~kill).mean()), 4),
    )
    return out, stats


def agp_sparsity(it: int, *, start_iter: int, end_iter: int,
                 final_sparsity: float, initial_sparsity: float = 0.0,
                 freq: int = 100) -> float:
    """Automated-Gradual-Pruning target sparsity at iteration ``it``
    (Zhu & Gupta 2017's cubic ramp): s(t) ramps from ``initial_sparsity``
    at ``start_iter`` to ``final_sparsity`` at ``end_iter``, updated every
    ``freq`` iterations (stepwise-constant between updates).

    ONE-SHOT block-90% pruning can collapse AlexNet-scale training to
    chance, and masked fine-tuning cannot repair it, while a gradual ramp
    lets the surviving blocks absorb the pruned capacity step by step. The
    reference consumed externally pruned models and its only in-training
    lever was L1/`regularization_type` pressure (`caffe.proto:307-308`,
    `sgd_solver.cpp:144-206`); producing accurate BLOCK-sparse models is
    this framework's own burden because block skipping is what turns
    sparsity into wall-clock time."""
    if it < start_iter:
        return float(initial_sparsity)
    if it >= end_iter:
        return float(final_sparsity)
    t = ((it - start_iter) // max(1, freq)) * max(1, freq)
    frac = t / max(1, end_iter - start_iter)
    return float(final_sparsity + (initial_sparsity - final_sparsity)
                 * (1.0 - frac) ** 3)


@dataclasses.dataclass(frozen=True)
class PruningSchedule:
    """Config for in-training gradual pruning (Solver.set_pruning_schedule).

    ``granularity`` "block" prunes (block_shape) tiles of each weight's
    GEMM view (conv: per-offset (Cin, Cout) planes ranked globally, the
    direct-conv BSC structure — prune_conv_weight); "element" prunes by
    |w|. Masks are recomputed from the CURRENT weights at every ``freq``
    iterations inside [start_iter, end_iter] — weights pruned early can
    come back if they regrow before the next recompute (standard AGP
    behavior), and the final mask is frozen after end_iter."""
    final_sparsity: float
    start_iter: int
    end_iter: int
    freq: int = 100
    initial_sparsity: float = 0.0
    granularity: str = "block"  # "block" | "element"
    block_shape: Tuple[int, int] = (128, 128)


def default_prune_select(name: str, key: str, leaf) -> bool:
    """Which leaves a schedule prunes by default: weight blobs of conv
    (4-D, receptive field >= 32 — conv1's 3-channel input stays dense, as
    in bench/the reference) and fc (2-D) layers."""
    if key != "w":
        return False
    shp = np.shape(leaf)
    if len(shp) == 4:
        return int(np.prod(shp[:3])) >= 32
    return len(shp) == 2


def gradual_masks(params, sparsity: float, *, granularity: str = "block",
                  block_shape: Tuple[int, int] = (128, 128),
                  select: Optional[Callable] = None):
    """Recompute pruning masks from the CURRENT weights at ``sparsity``.

    Returns a 0/1 float32 pytree congruent with ``params`` (ones on
    non-selected leaves). Used by the AGP loop: at each schedule step the
    lowest-magnitude (element) or lowest-norm (block) fraction of each
    selected weight is masked; the solver then pins those at zero."""
    import jax

    select = select or default_prune_select

    def leaf_mask(name, key, leaf):
        w = np.asarray(jax.device_get(leaf))
        if not select(name, key, w) or sparsity <= 0:
            return np.ones(w.shape, np.float32)
        if granularity == "element":
            pruned = prune_magnitude(w, sparsity)
        elif w.ndim == 4:
            pruned = prune_conv_weight(w, sparsity, block_shape)
        else:
            pruned = prune_blocks(w, sparsity, block_shape)
        return (pruned != 0).astype(np.float32)

    out = {}
    for name, node in params.items():
        if isinstance(node, dict):
            out[name] = {k: leaf_mask(name, k, v) for k, v in node.items()}
        else:
            out[name] = jax.tree_util.tree_map(
                lambda l: np.ones(np.shape(l), np.float32), node)
    return out


def masks_of(params, keys=("w",)):
    """0/1 pytree for Solver.set_param_masks: the nonzero pattern of every
    leaf whose dict key is in ``keys`` (the pruned weights), all-ones
    elsewhere (biases, norms — a zero-initialized bias must stay free to
    move, so it is never pattern-masked)."""
    import jax

    def rec(node, masked):
        if isinstance(node, dict):
            return {k: rec(v, masked or k in keys) for k, v in node.items()}
        return jax.tree_util.tree_map(
            lambda l: (np.asarray(l) != 0).astype(np.float32) if masked
            else np.ones(np.shape(l), np.float32), node)

    return rec(params, False)

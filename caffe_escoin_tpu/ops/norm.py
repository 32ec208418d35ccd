"""Normalization ops: LRN, batch norm, scale/bias, MVN.

Reference: `src/caffe/layers/{lrn,batch_norm,scale,bias,mvn}_layer.cpp`.
Caffe splits inference batch-norm into BatchNorm (normalize by moving stats)
followed by Scale (learned gamma/beta); we provide both the split pieces and a
fused `batch_norm` for model-zoo convenience.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def lrn_across_channels(x, *, local_size=5, alpha=1e-4, beta=0.75, k=1.0,
                        groups: int = 1):
    """Local response normalization across channels (NHWC last axis).

    y = x / (k + alpha/n * sum_{c in window} x_c^2)^beta — matches Caffe's
    ACROSS_CHANNELS with alpha pre-divided by local_size
    (`lrn_layer.cpp:104` uses alpha/size).

    Perf note: LRN can dominate AlexNet/GoogLeNet e2e (the "other"
    bucket). Two fixes: (a) the windowed sum is built from
    shifted channel slices (the reference's scale_ running update,
    `lrn_layer.cpp:86-116`) instead of reduce_window over the lane
    dimension; (b) for Caffe's default beta=0.75, s^-0.75 = r*sqrt(r) with
    r = rsqrt(s) — three cheap elementwise ops instead of the exp/log `power`
    lowering. Division becomes a multiply.

    ``groups=r`` runs the normalization over r INDEPENDENT logical
    channel blocks sharing the lane axis — the W-pair packed layout
    (ops/wpack.py), where lanes carry (pixel-phase, channel) and the LRN
    window must not cross phases. Implemented with constant lane masks on
    the shifted slices (the masks fuse into the elementwise chain; no
    extra pass, no lane reshuffle)."""
    half = local_size // 2
    xf = x.astype(jnp.float32)
    sq = xf * xf
    padded = jnp.pad(
        sq, ((0, 0),) * (x.ndim - 1) + ((half, local_size - 1 - half),))
    c = x.shape[-1]
    cg = c // groups

    def mask_for(shift_i):
        # lane l holds (group l//cg, channel l%cg); the window term at
        # offset d = i - half reads logical channel (l%cg)+d, valid only
        # inside the group
        import numpy as np
        d = shift_i - half
        lane_c = np.arange(c) % cg
        return jnp.asarray(((lane_c + d >= 0) & (lane_c + d < cg))
                           .astype(np.float32))

    window = padded[..., :c] if groups == 1 else \
        padded[..., :c] * mask_for(0)
    for i in range(1, local_size):
        term = padded[..., i:i + c]
        if groups > 1:
            term = term * mask_for(i)
        window = window + term
    s = k + (alpha / local_size) * window
    if beta == 0.75:
        r = lax.rsqrt(s)
        scale = r * jnp.sqrt(r)  # s^-0.75, exactly
    else:
        scale = jnp.power(s, -beta)
    return (xf * scale).astype(x.dtype)


def batch_norm_inference(x, mean, var, *, eps=1e-5):
    """Caffe BatchNorm layer at TEST: normalize by stored moving stats."""
    inv = lax.rsqrt(var + eps)
    return (x - mean) * inv


def batch_norm_train(x, *, axis=(0, 1, 2), eps=1e-5):
    """Returns (normalized, batch_mean, batch_var) for the train path."""
    mean = jnp.mean(x, axis=axis)
    var = jnp.var(x, axis=axis)
    return (x - mean) * lax.rsqrt(var + eps), mean, var


def scale_bias(x, gamma, beta=None):
    """Caffe Scale layer (per-channel gamma, optional bias)."""
    out = x * gamma
    if beta is not None:
        out = out + beta
    return out


def batch_norm(x, mean, var, gamma=None, beta=None, *, eps=1e-5):
    """Fused inference BN + scale (BatchNorm + Scale layer pair)."""
    inv = lax.rsqrt(var + eps)
    if gamma is not None:
        inv = inv * gamma
    out = x * inv + ((beta if beta is not None else 0.0) - mean * inv)
    return out


def mvn(x, *, axis=(1, 2, 3), normalize_variance=True, eps=1e-9):
    """Mean-variance normalization over all non-batch axes (mvn_layer.cpp)."""
    mean = jnp.mean(x, axis=axis, keepdims=True)
    out = x - mean
    if normalize_variance:
        std = jnp.sqrt(jnp.mean(out * out, axis=axis, keepdims=True))
        out = out / (std + eps)
    return out

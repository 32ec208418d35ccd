"""Pooling (max / average / global), Caffe-compatible semantics.

Reference: `src/caffe/layers/pooling_layer.cpp`. Two Caffe-isms preserved
because the model zoo shapes depend on them:

* **ceil-mode output sizing**: pooled = ceil((in + 2p - k) / s) + 1, with the
  last window clipped so it starts inside the padded input. AlexNet's 3x3/s2
  pools and GoogLeNet's tower pools rely on this.
* **average pooling divides by the full window size** (padding included).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


def _pooled_size(size, k, s, p, ceil_mode):
    if ceil_mode:
        out = int(np.ceil((size + 2 * p - k) / s)) + 1
    else:
        out = int(np.floor((size + 2 * p - k) / s)) + 1
    if p > 0 and (out - 1) * s >= size + p:
        out -= 1  # last window must start strictly inside (pooling_layer.cpp:90)
    return out


def _pool_patches(x, kernel, stride, padding, ho, wo):
    """[N,H,W,C] -> [N,Ho,Wo,C,kh*kw] window patches (zero-padded edges)."""
    kh, kw = kernel
    sh, sw = stride
    ph, pw = padding
    n, h, w, c = x.shape
    pad_h2 = max(0, (ho - 1) * sh + kh - h - ph)
    pad_w2 = max(0, (wo - 1) * sw + kw - w - pw)
    xp = jnp.pad(x, ((0, 0), (ph, pad_h2), (pw, pad_w2), (0, 0)))
    pats = [
        xp[:, i : i + (ho - 1) * sh + 1 : sh, j : j + (wo - 1) * sw + 1 : sw]
        for i in range(kh)
        for j in range(kw)
    ]
    return jnp.stack(pats, axis=-1)


def pool2d(x, kernel, *, stride=None, padding=(0, 0), mode="max",
           ceil_mode=True, global_pool=False, train=False, rng=None):
    """x: [N, H, W, C] -> [N, Ho, Wo, C].

    ``mode="stochastic"`` implements the reference's stochastic pooling
    (`pooling_layer.cpp:119,221`, Zeiler-Fergus): in train mode each window
    samples one element with probability proportional to its (non-negative)
    activation, in test mode it outputs the activation-weighted average
    sum(a^2)/sum(a) (0 for all-zero windows). Train mode needs ``rng``.
    """
    n, h, w, c = x.shape
    if global_pool:
        kernel, stride, padding = (h, w), (1, 1), (0, 0)
    kh, kw = kernel
    stride = stride or kernel
    sh, sw = stride
    ph, pw = padding
    ho = _pooled_size(h, kh, sh, ph, ceil_mode)
    wo = _pooled_size(w, kw, sw, pw, ceil_mode)
    # pad right/bottom enough to cover the (possibly ceil-extended) last window
    need_h = (ho - 1) * sh + kh
    need_w = (wo - 1) * sw + kw
    pad_h2 = max(0, need_h - h - ph)
    pad_w2 = max(0, need_w - w - pw)
    if mode == "max":
        xp = jnp.pad(
            x, ((0, 0), (ph, pad_h2), (pw, pad_w2), (0, 0)),
            constant_values=-jnp.inf,
        )
        out = lax.reduce_window(
            xp, -jnp.inf, lax.max, (1, kh, kw, 1), (1, sh, sw, 1), "VALID"
        )
    elif mode == "avg":
        xp = jnp.pad(x, ((0, 0), (ph, pad_h2), (pw, pad_w2), (0, 0)))
        out = lax.reduce_window(
            xp, 0.0, lax.add, (1, kh, kw, 1), (1, sh, sw, 1), "VALID"
        ) / float(kh * kw)
    elif mode == "stochastic":
        pats = _pool_patches(x, (kh, kw), (sh, sw), (ph, pw), ho, wo)
        total = jnp.sum(pats, axis=-1)
        if train:
            if rng is None:
                raise ValueError("stochastic pooling in train mode needs rng")
            # threshold r ~ U(0, sum); pick the first window element whose
            # cumulative sum crosses it (pooling_layer.cpp:119-160)
            r = jax.random.uniform(rng, total.shape, dtype=x.dtype) * total
            cum = jnp.cumsum(pats, axis=-1)
            ge = cum > r[..., None]
            first = jnp.logical_and(
                ge,
                jnp.logical_not(
                    jnp.concatenate(
                        [jnp.zeros_like(ge[..., :1]), ge[..., :-1]], axis=-1)
                ),
            )
            out = jnp.sum(pats * first.astype(pats.dtype), axis=-1)
        else:
            safe = jnp.where(total > 0, total, 1.0)
            out = jnp.where(total > 0,
                            jnp.sum(pats * pats, axis=-1) / safe, 0.0)
        return out
    else:
        raise ValueError(f"unknown pool mode {mode!r}")
    return out[:, :ho, :wo, :]


def pool2d_packed_out(x, kernel, *, stride=None, padding=(0, 0),
                      mode="max", ceil_mode=True, r: int = 2):
    """Pooling that EMITS the W-pair packed layout (ops/wpack.py):
    [N, H, W, C] -> [N, Ho, Wo//r, r*C] with out_p[..., v, j*C+c] =
    pool_out[..., r*v + j, c].

    Output phase j's windows start at W positions (r*v + j)*sw - pw, i.e.
    phase j is an ordinary pooling of x at W offset j*sw with W stride
    r*sw; the r phase results concatenate on the lane axis — no retile
    pass ever materializes, which is the whole point (packing via reshape
    of the unpacked pool output would be a physical tiled-layout copy).
    Max/avg only (the packed towers' pools; stochastic pooling stays
    unpacked). Used by PoolingLayer when the pack pass marks its top."""
    n, h, w, c = x.shape
    kh, kw = kernel
    stride = stride or kernel
    sh, sw = stride
    ph, pw = padding
    ho = _pooled_size(h, kh, sh, ph, ceil_mode)
    wo = _pooled_size(w, kw, sw, pw, ceil_mode)
    assert wo % r == 0, f"pooled width {wo} not divisible by pack {r}"
    need_h = (ho - 1) * sh + kh
    need_w = (wo - 1) * sw + kw
    pad_h2 = max(0, need_h - h - ph)
    pad_w2 = max(0, need_w - w - pw)
    if mode == "max":
        init, op, post = -jnp.inf, lax.max, None
    elif mode == "avg":
        init, op, post = 0.0, lax.add, float(kh * kw)
    else:
        raise ValueError(f"pool2d_packed_out: unsupported mode {mode!r}")
    xp = jnp.pad(x, ((0, 0), (ph, pad_h2), (pw, pad_w2), (0, 0)),
                 constant_values=init)
    phases = []
    for j in range(r):
        out_j = lax.reduce_window(
            xp[:, :, j * sw:, :], init, op,
            (1, kh, kw, 1), (1, sh, r * sw, 1), "VALID")
        phases.append(out_j[:, :ho, : wo // r, :])
    out = jnp.concatenate(phases, axis=-1)
    if post is not None:
        out = out / post
    return out


def pool2d_packed(x, kernel, *, stride=None, padding=(0, 0), mode="max",
                  ceil_mode=True, r_in: int = 1, r_out: int = 1):
    """Pooling between W-pair packed layouts (ops/wpack.py):
    [N, H, W/r_in, r_in*C] -> [N, Ho, Wo/r_out, r_out*C].

    Same tap algebra as `repack_weight`: output phase j's tap dx reads
    packed pixel offset du = floor((sw*j + dx - pw)/r_in), lane block
    i = (sw*j + dx - pw) mod r_in; valid iff the packed W stride
    s' = sw*r_out/r_in is integral. The H dimension pools normally
    (reduce_window per lane), then each output phase reduces its tap set
    of (W-sliced, lane-block-sliced) views and the phases concatenate on
    lanes. This is what lets packed chains flow THROUGH pools (VGG's
    2x2/s2 between packed conv stacks; GoogLeNet's stem 3x3/s2
    terminator with r_out=1) instead of dying at them."""
    if r_in == 1 and r_out > 1:
        return pool2d_packed_out(x, kernel, stride=stride, padding=padding,
                                 mode=mode, ceil_mode=ceil_mode, r=r_out)
    n, h, wp, cc = x.shape
    kh, kw = kernel
    stride = stride or kernel
    sh, sw = stride
    ph, pw = padding
    assert (sw * r_out) % r_in == 0, "packed pool stride not integral"
    s_p = sw * r_out // r_in
    c = cc // r_in
    w_log = wp * r_in
    ho = _pooled_size(h, kh, sh, ph, ceil_mode)
    wo = _pooled_size(w_log, kw, sw, pw, ceil_mode)
    assert wo % r_out == 0, f"pooled width {wo} not divisible by {r_out}"
    if mode == "max":
        init, op, post = -jnp.inf, jnp.maximum, None
    elif mode == "avg":
        init, op, post = 0.0, jnp.add, float(kh * kw)
    else:
        raise ValueError(f"pool2d_packed: unsupported mode {mode!r}")
    # H pooling (per lane, ordinary windows)
    need_h = (ho - 1) * sh + kh
    pad_h2 = max(0, need_h - h - ph)
    xh = jnp.pad(x, ((0, 0), (ph, pad_h2), (0, 0), (0, 0)),
                 constant_values=init)
    xh = lax.reduce_window(xh, init, lax.max if mode == "max" else lax.add,
                           (1, kh, 1, 1), (1, sh, 1, 1), "VALID")
    # W/lane taps per output phase
    if sw == r_in:
        # Phase j's tap set is phase 0's shifted by j packed pixels
        # (t = sw*j + dx - pw with sw == r_in shifts du by j, same lane
        # block), so ONE per-packed-pixel reduction U over unit-stride
        # shifted lane-block views serves every phase: out_j[v] =
        # U[r_out*v + j], i.e. the packed output is the row-major
        # lane-merge reshape of U. No strided slices: the strided-slice
        # form below lowers to gather/relayout copies, while this
        # formulation is a bytes-bound elementwise chain.
        taps0 = [((dx - pw) // r_in, (dx - pw) % r_in) for dx in range(kw)]
        du_min = min(du for du, _ in taps0)
        du_max = max(du for du, _ in taps0)
        pl_p = max(0, -du_min)
        pr_p = max(0, (wo - 1) + du_max - (wp - 1))
        xw = jnp.pad(xh, ((0, 0), (0, 0), (pl_p, pr_p), (0, 0)),
                     constant_values=init)
        acc = None
        for du, i in taps0:
            sl = xw[:, :, pl_p + du: pl_p + du + wo, i * c:(i + 1) * c]
            acc = sl if acc is None else op(acc, sl)
        out = acc.reshape(n, ho, wo // r_out, r_out * c)
        if post is not None:
            out = out / post
        return out
    taps = {}  # j -> [(du, i)]
    for j in range(r_out):
        taps[j] = []
        for dx in range(kw):
            t = sw * j + dx - pw
            taps[j].append((t // r_in, t % r_in))
    all_du = [du for tl in taps.values() for du, _ in tl]
    du_min, du_max = min(all_du), max(all_du)
    vmax = wo // r_out - 1
    pl_p = max(0, -du_min)
    pr_p = max(0, s_p * vmax + du_max - (wp - 1))
    xw = jnp.pad(xh, ((0, 0), (0, 0), (pl_p, pr_p), (0, 0)),
                 constant_values=init)
    phases = []
    for j in range(r_out):
        acc = None
        for du, i in taps[j]:
            u0 = pl_p + du
            sl = xw[:, :, u0 : u0 + s_p * vmax + 1 : s_p,
                    i * c : (i + 1) * c]
            acc = sl if acc is None else op(acc, sl)
        phases.append(acc)
    out = jnp.concatenate(phases, axis=-1) if r_out > 1 else phases[0]
    if post is not None:
        out = out / post
    return out


def spp(x, pyramid_height: int, *, mode="max"):
    """Spatial pyramid pooling (spp_layer.cpp): levels 0..h-1 pool to
    (2^l x 2^l) bins each, flattened+concatenated -> [N, C * sum 4^l]."""
    import numpy as np

    n, h, w, c = x.shape
    outs = []
    for level in range(pyramid_height):
        bins = 2 ** level
        kh = int(np.ceil(h / bins))
        kw = int(np.ceil(w / bins))
        ph = (kh * bins - h + 1) // 2
        pw = (kw * bins - w + 1) // 2
        pooled = pool2d(x, (kh, kw), stride=(kh, kw), padding=(ph, pw),
                        mode=mode, ceil_mode=True)
        pooled = pooled[:, :bins, :bins, :]
        outs.append(pooled.reshape(n, -1))
    return jnp.concatenate(outs, axis=-1)

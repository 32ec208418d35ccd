"""W-pair packed layout: full-lane execution for narrow-channel towers.

Built for an accelerator whose arrays tile the last dimension into
128-element lanes: there an NHWC activation with C < 128 is PHYSICALLY
padded to 128 lanes, so every device-memory read/write of a C=64 tensor
moves 2x its logical bytes, and the ResNet-50 56x56/C=64 tower sits at
that physical bound whatever the executor. The GPU has no such padding;
whether the pass pays there is an open measurement (ROADMAP design
item 2).

The fix is a LAYOUT, not a kernel: pack r adjacent W-pixels into the lane
dimension (r = 128//C), turning (N, H, W, C) into (N, H, W/r, C*r) — full
128-lane occupancy, half the physical bytes. Any stride-1 conv has an
exact reparametrization in the packed domain, and the pack/unpack at tower
boundaries folds into the adjacent convs as pure conv transforms (no
retile pass ever materializes):

* interior (packed in -> packed out): kernel (kh, kw) becomes
  (kh, kw_p) over packed pixels with lanes carrying the (phase, channel)
  product — `packed_weight`.
* entry (unpacked in -> packed out): a stride-(sw*r) conv whose kernel
  width covers the r output phases — `entry_weight` (for 1x1 entries this
  is a (1, r) kernel, stride (1, r)).
* exit (packed in -> unpacked out): an lhs-dilated (transposed-stride)
  conv — `exit_weight`.

Everything remains an ordinary XLA conv / XBSP block-sparse conv on the
packed weight; block sparsity survives as the packed weight's own zero
structure. The reference has no counterpart (GPU gathers are per-lane;
this is tiled-layout physics) — the closest analogue is its channel-
blocked weight reorganization at model-load time
(`src/caffe/layers/base_conv_layer.cpp:46-273`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def pack_factor(c: int, w: int, *, lanes: int = 128) -> int:
    """Largest r with c*r <= lanes, r | w, and r a power of two (keeps the
    phase arithmetic exact and the packed width tile-friendly). 1 means
    "don't pack"."""
    r = 1
    while (r * 2 * c <= lanes) and (w % (r * 2) == 0):
        r *= 2
    return r


def pack_nhwc(x, r: int):
    """(N, H, W, C) -> (N, H, W//r, r*C) reference packer (tests/host prep;
    the deployment path never materializes this — packing folds into the
    producer conv)."""
    n, h, w, c = x.shape
    return x.reshape(n, h, w // r, r * c)


def unpack_nhwc(xp, r: int):
    n, h, wp, rc = xp.shape
    return xp.reshape(n, h, wp * r, rc // r)


def packed_weight(w_hwio: np.ndarray, r: int, pad_w: int
                  ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Packed-in -> packed-out reparametrization of a stride-1 conv.

    out[n,h,r*v+j,co] = sum_{dy,dx,ci} xpad[n,h+dy,(r*v+j)+dx-pad_w,ci]
                        * w[dy,dx,ci,co]
    with the W tap rewritten as r*(v+du)+i:
        du = floor((j+dx-pad_w)/r),  i = (j+dx-pad_w) mod r.

    Returns (wp [kh, kw_p, r*ci, r*co], (pw_left, pw_right)) for a conv on
    the packed tensors with the SAME H padding/stride and the returned
    asymmetric W padding in packed pixels. Taps landing outside [0, W/r)
    read packed-domain zero padding, which corresponds exactly to original
    pixels outside [0, W) (the phase arithmetic cannot map an out-of-range
    original tap onto a valid packed pixel)."""
    kh, kw, ci, co = w_hwio.shape
    du_min = (0 - pad_w) // r  # python floor division: exact for negatives
    du_max = (r - 1 + kw - 1 - pad_w) // r
    kw_p = du_max - du_min + 1
    wp = np.zeros((kh, kw_p, r * ci, r * co), w_hwio.dtype)
    for j in range(r):
        for dx in range(kw):
            t = j + dx - pad_w
            du, i = t // r, t % r
            wp[:, du - du_min, i * ci:(i + 1) * ci, j * co:(j + 1) * co] \
                += w_hwio[:, dx]
    return wp, (-du_min, du_max)


def repack_weight(w_hwio: np.ndarray, r_in: int, r_out: int,
                  stride_w: int, pad_w: int, w_in: int
                  ) -> Tuple[np.ndarray, Tuple[int, int], int]:
    """General W-packed reparametrization: input packed ``r_in``, output
    packed ``r_out`` (either may be 1 = unpacked). Covers packed_weight
    (r_in == r_out, sw 1), entry_weight (r_in 1) and the strided boundary
    consumers (e.g. r_in 2 -> r_out 1 at stride 2) in one formula:

        out[w = r_out*v + j] = sum_dx x[w_in = sw*(r_out*v + j) + dx - pw]
        w_in = r_in*u + i  =>  t = sw*j + dx - pw ;  i = t mod r_in ;
                               du = t // r_in  (floor)

    valid iff the packed stride  s' = sw*r_out / r_in  is an integer (the
    stride-1 unpack case sw*r_out < r_in needs the lhs-dilated
    `exit_weight` instead). Returns (wp [kh, kw_p, r_in*ci, r_out*co],
    (pad_left, pad_right), stride_packed); the padding is SYMMETRIZED by
    growing the kernel with zero taps on the short side (zero taps are
    free in the XBSP executors — dead blocks are skipped at trace time —
    and near-free in a dense conv).

    Polymorphic over numpy and jax arrays (jax path supports traced /
    abstract weights, e.g. under `jax.eval_shape` for net shape
    inference)."""
    kh, kw, ci, co = w_hwio.shape
    geo = repack_geometry(kw, r_in, r_out, stride_w, pad_w, w_in)
    kw_p, (pl, pr), s_p, du_min, front = geo
    is_np = isinstance(w_hwio, np.ndarray)
    if is_np:
        xp = np
    else:
        import jax.numpy as xp
    wp = xp.zeros((kh, kw_p, r_in * ci, r_out * co), w_hwio.dtype)
    for j in range(r_out):
        for dx in range(kw):
            t = stride_w * j + dx - pad_w
            i, du = t % r_in, t // r_in
            sl = (slice(None), du - du_min + front,
                  slice(i * ci, (i + 1) * ci), slice(j * co, (j + 1) * co))
            if is_np:
                wp[sl] += w_hwio[:, dx]
            else:
                wp = wp.at[sl].add(w_hwio[:, dx])
    return wp, (pl, pr), s_p


def repack_geometry(kw: int, r_in: int, r_out: int, stride_w: int,
                    pad_w: int, w_in: int):
    """Tap-grid geometry of `repack_weight` without building the weight:
    (kw_p, (pad_l, pad_r), stride_packed, du_min, front_zero_taps)."""
    assert (stride_w * r_out) % r_in == 0, (
        f"packed stride sw*r_out/r_in = {stride_w}*{r_out}/{r_in} "
        "not integral (use exit_weight)")
    s_p = stride_w * r_out // r_in
    dus = [(stride_w * j + dx - pad_w) // r_in
           for j in range(r_out) for dx in range(kw)]
    du_min, du_max = min(dus), max(dus)
    kw_p = du_max - du_min + 1
    pl = -du_min
    # right padding from the output-width equation:
    #   (Wp_in + pl + pr - kw_p) // s_p + 1 == Wo // r_out
    wo = (w_in + 2 * pad_w - kw) // stride_w + 1
    pr = (wo // r_out - 1) * s_p + kw_p - w_in // r_in - pl
    front = 0
    if pl != pr:  # symmetrize with zero taps on the short side
        d = abs(pl - pr)
        kw_p += d
        if pl < pr:
            front = d
            pl = pr
        else:
            pr = pl
    return kw_p, (pl, pr), s_p, du_min, front


def packed_pad_right(w_in: int, kw: int, pad_w: int, r: int) -> int:
    """Right W padding (in packed pixels) making the packed conv emit
    exactly Wo/r pixels. Equals the `packed_weight` du_max for same-size
    ('SAME'-style) convs; smaller for valid convs (Wo < W)."""
    wo = (w_in + 2 * pad_w - kw) + 1
    du_min = (0 - pad_w) // r
    du_max = (r - 1 + kw - 1 - pad_w) // r
    kw_p = du_max - du_min + 1
    return wo // r - 1 + kw_p - (-du_min) - w_in // r


def entry_weight(w_hwio: np.ndarray, r: int, stride_w: int, pad_w: int
                 ) -> Tuple[np.ndarray, Tuple[int, int], int]:
    """Unpacked-in -> packed-out: one conv whose W stride is r*stride_w and
    whose kernel width covers all r output phases.

    out_p[n,h,v,j*co+c] = out[n,h,r*v+j,c]
                        = sum_dx x[n,h, sw*(r*v+j)+dx-pad_w, ci] w[.,dx,.]
    tap offset relative to the packed base sw*r*v:  t = sw*j + dx - pad_w
    (+pad_w left padding keeps t >= 0). Returns (wp [kh, kw_e, ci, r*co],
    (pw_left, pw_right), stride_w_packed)."""
    kh, kw, ci, co = w_hwio.shape
    kw_e = stride_w * (r - 1) + kw
    wp = np.zeros((kh, kw_e, ci, r * co), w_hwio.dtype)
    for j in range(r):
        for dx in range(kw):
            wp[:, stride_w * j + dx, :, j * co:(j + 1) * co] += w_hwio[:, dx]
    return wp, (pad_w, None), stride_w * r


def entry_pad_right(w_in: int, kw: int, stride_w: int, pad_w: int, r: int
                    ) -> int:
    """Right W padding making the entry conv emit exactly Wo/r packed
    pixels: solve (W + pl + pr - kw_e) // (sw*r) + 1 == Wo // r."""
    wo = (w_in + 2 * pad_w - kw) // stride_w + 1
    kw_e = stride_w * (r - 1) + kw
    return (wo // r - 1) * stride_w * r + kw_e - w_in - pad_w


def exit_weight(w_hwio: np.ndarray, r: int, pad_w: int
                ) -> Tuple[np.ndarray, Tuple[int, int], int]:
    """Packed-in -> unpacked-out (stride 1): an lhs-dilated conv.

    Dilate the packed input by r along W (xd[r*u] = xp[u]); then
    out[n,h,w,co] = sum_t xd[w + t - pq] K[t] with
        K[dy, t, i*ci+c, co] = w[dy, t+i-(r-1), c, co]   (zero outside),
        pq = pad_w + r - 1.
    The phase selection is w-independent, which is what makes this a valid
    conv kernel. Returns (K [kh, kw+r-1, r*ci, co], (pq_l, pq_r),
    lhs_dilation_w)."""
    kh, kw, ci, co = w_hwio.shape
    kw_d = kw + r - 1
    K = np.zeros((kh, kw_d, r * ci, co), w_hwio.dtype)
    for t in range(kw_d):
        for i in range(r):
            dx = t + i - (r - 1)
            if 0 <= dx < kw:
                K[:, t, i * ci:(i + 1) * ci, :] += w_hwio[:, dx]
    pq = pad_w + r - 1
    return K, (pq, None), r


def exit_pad_right(w_packed: int, kw: int, pad_w: int, r: int) -> int:
    """Right W padding making the exit (lhs-dilated) conv emit exactly Wo
    unpacked pixels: solve Ld + pl + pr - kw_d + 1 == Wo with
    Ld = (Wp-1)*r + 1."""
    w_in = w_packed * r
    wo = w_in + 2 * pad_w - kw + 1
    ld = (w_packed - 1) * r + 1
    kw_d = kw + r - 1
    pl = pad_w + r - 1
    return wo - 1 + kw_d - pl - ld

"""Space-to-depth reformulation of small-cin strided stem convs.

Why: the first conv of every ImageNet CNN (GoogLeNet/ResNet 7x7/s2,
AlexNet 11x11/s4, reference `models/*/train_val.prototxt`) reads a
3-channel image: cin=3 fills 3 of a matrix unit's 128-wide contraction
per tap, AND the conv iterates 7x7 kernel windows over a stride-2 access
pattern, so the stem runs far from its compute bound.

The fix (the well-known "space-to-depth" stem transform, used by MLPerf
ResNet submissions; re-derived here for arbitrary k/s/p): when
stride == r in both dims, an [N, H, W, C] image can be re-laid-out as
[N, H/r, W/r, r*r*C] (phases move into lanes) and the stride-r conv
becomes a STRIDE-1 conv over the s2d grid with a remapped kernel:

    out(i) reads input rows  r*i + di - p,          di in [0, k)
    s2d row (ps, phase a) holds input row  r*ps + a
    =>  ps = i + floor((di - p) / r),   a = (di - p) mod r

so tap (dp, a) of the packed kernel carries original tap
di = r*(dp - pl) + a + p  (zero weight when di is outside [0, k)), with
packed kernel size kp = floor((k-1-p)/r) - floor(-p/r) + 1 and left pad
pl = -floor(-p/r) applied explicitly in the s2d domain.  Inputs whose
H/W are not multiples of r are zero-padded up first; the extra phantom
taps land on zero weights by construction, so the result is EXACT
(tested bit-level against the dense strided conv in tests/test_s2d.py).

Zero structure is preserved tap-by-tap, so a pruned stem weight stays
pruned and the remapped conv flows through the ordinary XBSP/autotune
dispatch unchanged.  Applied by `nn/fuse.fold_stem_s2d`.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import jax.numpy as jnp


def s2d_axis_geometry(k: int, r: int, p: int, size: int
                      ) -> Tuple[int, int, int, int, int]:
    """One-axis geometry: (kp, pad_lo, pad_hi, out, grid) for a kernel-k
    stride-r pad-p conv over a size-`size` axis seen in the s2d domain."""
    lo = math.floor(-p / r)
    hi = math.floor((k - 1 - p) / r)
    kp = hi - lo + 1
    pad_lo = -lo
    out = (size + 2 * p - k) // r + 1
    grid = -(-size // r)  # ceil: input zero-padded up to a multiple of r
    pad_hi = max(0, (out - 1) - pad_lo + kp - 1 - (grid - 1))
    return kp, pad_lo, pad_hi, out, grid


def s2d_weight(w: np.ndarray, r: int, pad: Tuple[int, int]) -> np.ndarray:
    """[kh, kw, cin, cout] stride-(r, r) kernel -> [kph, kpw, r*r*cin, cout]
    stride-1 kernel over the s2d input layout (lane = (a*r + b)*cin + c)."""
    kh, kw, cin, cout = w.shape
    ph, pw = pad
    kph = s2d_axis_geometry(kh, r, ph, r)[0]
    kpw = s2d_axis_geometry(kw, r, pw, r)[0]
    wp = np.zeros((kph, kpw, r * r * cin, cout), w.dtype)
    plh = -math.floor(-ph / r)
    plw = -math.floor(-pw / r)
    for dp in range(kph):
        for a in range(r):
            di = r * (dp - plh) + a + ph
            if not 0 <= di < kh:
                continue
            for dq in range(kpw):
                for b in range(r):
                    dj = r * (dq - plw) + b + pw
                    if not 0 <= dj < kw:
                        continue
                    base = (a * r + b) * cin
                    wp[dp, dq, base:base + cin, :] = w[di, dj, :, :]
    return wp


def space_to_depth(x, r: int):
    """[N, H, W, C] -> [N, ceil(H/r), ceil(W/r), r*r*C] (zero-padding the
    bottom/right remainder rows; lane order (phase_h, phase_w, c))."""
    n, h, w, c = x.shape
    hs, ws = -(-h // r), -(-w // r)
    if hs * r != h or ws * r != w:
        x = jnp.pad(x, ((0, 0), (0, hs * r - h), (0, ws * r - w), (0, 0)))
    x = x.reshape(n, hs, r, ws, r, c)
    x = x.transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(n, hs, ws, r * r * c)


def s2d_input(x, r: int, kernel: Tuple[int, int], pad: Tuple[int, int]):
    """space_to_depth + the explicit (pad_lo, pad_hi) edge padding so the
    remapped kernel runs stride-1 pad-0."""
    kh, kw = kernel
    ph, pw = pad
    n, h, w, c = x.shape
    _, plh, phh, _, _ = s2d_axis_geometry(kh, r, ph, h)
    _, plw, phw, _, _ = s2d_axis_geometry(kw, r, pw, w)
    xs = space_to_depth(x, r)
    if plh or phh or plw or phw:
        xs = jnp.pad(xs, ((0, 0), (plh, phh), (plw, phw), (0, 0)))
    return xs

"""Reference (oracle) implementations in plain jnp.

Mirrors the role of the reference's in-test scalar convolution `caffe_conv`
(`src/caffe/test/test_convolution_layer.cpp:22-148`) and the scalar sparse
kernel `caffe_cpu_sconv_default` (`include/caffe/util/sconv.hpp:594-678`):
simple, obviously-correct implementations every optimized kernel is checked
against. These are vectorized per-kernel-offset shift+matmul loops (not
per-element Python loops) so the tests run fast, but they use no conv
primitive — `lax.conv_general_dilated` is itself validated against this.

Canonical layouts: activations NHWC, conv weights HWIO.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def conv2d_reference(
    x,
    w,
    b=None,
    *,
    stride=(1, 1),
    padding=(0, 0),
    dilation=(1, 1),
    groups: int = 1,
    relu: bool = False,
):
    """Direct convolution by explicit kernel-offset accumulation.

    x: [N, H, W, Cin]  w: [KH, KW, Cin//groups, Cout]  b: [Cout] or None.
    Returns [N, Ho, Wo, Cout] in float32.
    """
    x = jnp.asarray(x, jnp.float32)
    w = jnp.asarray(w, jnp.float32)
    n, h, wd, cin = x.shape
    kh, kw, cin_g, cout = w.shape
    sh, sw = stride
    ph, pw = padding
    dh, dw = dilation
    assert cin == cin_g * groups, (cin, cin_g, groups)
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (wd + 2 * pw - dw * (kw - 1) - 1) // sw + 1

    xp = jnp.pad(x, ((0, 0), (ph, ph), (pw, pw), (0, 0)))
    cout_g = cout // groups
    out = jnp.zeros((n, ho, wo, cout), jnp.float32)
    for g in range(groups):
        xg = xp[..., g * cin_g : (g + 1) * cin_g]
        acc = jnp.zeros((n, ho, wo, cout_g), jnp.float32)
        for i in range(kh):
            for j in range(kw):
                # input window for this kernel offset, strided
                patch = xg[
                    :,
                    i * dh : i * dh + (ho - 1) * sh + 1 : sh,
                    j * dw : j * dw + (wo - 1) * sw + 1 : sw,
                    :,
                ]
                acc = acc + jnp.einsum(
                    "nhwc,co->nhwo",
                    patch,
                    w[i, j, :, g * cout_g : (g + 1) * cout_g],
                    preferred_element_type=jnp.float32,
                )
        out = out.at[..., g * cout_g : (g + 1) * cout_g].set(acc)
    if b is not None:
        out = out + jnp.asarray(b, jnp.float32)
    if relu:
        out = jnp.maximum(out, 0.0)
    return out


def spmm_reference(w_dense, bmat):
    """C = W @ B oracle (W is the densified sparse operand)."""
    return jnp.dot(
        jnp.asarray(w_dense, jnp.float32),
        jnp.asarray(bmat, jnp.float32),
        preferred_element_type=jnp.float32,
    )


def im2col_reference(x, kernel, *, stride=(1, 1), padding=(0, 0), dilation=(1, 1)):
    """Patch extraction oracle: [N,H,W,C] -> [N, Ho, Wo, KH*KW*C].

    Column ordering is (kh, kw, c) fastest-last — the layout our lowered SpMM
    path uses (reference: `src/caffe/util/im2col.cpp`, adapted from
    channel-major CHW to channel-minor HWC).
    """
    x = jnp.asarray(x)
    n, h, wd, c = x.shape
    kh, kw = kernel
    sh, sw = stride
    ph, pw = padding
    dh, dw = dilation
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (wd + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    xp = jnp.pad(x, ((0, 0), (ph, ph), (pw, pw), (0, 0)))
    cols = []
    for i in range(kh):
        for j in range(kw):
            cols.append(
                xp[
                    :,
                    i * dh : i * dh + (ho - 1) * sh + 1 : sh,
                    j * dw : j * dw + (wo - 1) * sw + 1 : sw,
                    :,
                ]
            )
    return jnp.concatenate(cols, axis=-1).reshape(n, ho, wo, kh * kw * c)


def pool2d_reference(x, kernel, *, stride=None, padding=(0, 0), mode="max"):
    """Pooling oracle, NHWC. mode in {max, avg}. Caffe-style avg pooling
    divides by the full window size including padding (reference
    `src/caffe/layers/pooling_layer.cpp`)."""
    x = jnp.asarray(x, jnp.float32)
    kh, kw = kernel
    stride = stride or kernel
    sh, sw = stride
    ph, pw = padding
    n, h, wd, c = x.shape
    ho = (h + 2 * ph - kh) // sh + 1
    wo = (wd + 2 * pw - kw) // sw + 1
    if mode == "max":
        pad_val = -np.inf
    else:
        pad_val = 0.0
    xp = jnp.pad(x, ((0, 0), (ph, ph), (pw, pw), (0, 0)), constant_values=pad_val)
    windows = []
    for i in range(kh):
        for j in range(kw):
            windows.append(
                xp[:, i : i + (ho - 1) * sh + 1 : sh, j : j + (wo - 1) * sw + 1 : sw, :]
            )
    stack = jnp.stack(windows, axis=0)
    if mode == "max":
        return jnp.max(stack, axis=0)
    return jnp.sum(stack, axis=0) / (kh * kw)

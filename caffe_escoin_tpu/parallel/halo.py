"""Spatial (feature-map) partitioning with halo exchange.

The reference has NO multi-device model partitioning; its analogue of a halo
is the explicitly materialized zero-padded input (`copy_input_data`,
`src/caffe/util/math_functions.cu:729-766`) — padding IS a zero halo
(SURVEY.md section 5 "long-context"). Here the feature map's H dimension is
sharded over the mesh's ``model`` axis; each step exchanges (KH-1)//2
boundary rows with neighbors via `lax.ppermute` inside `shard_map`.
Edge shards receive ppermute's zero fill — which is exactly the global
zero padding, so no special-casing is needed when halo == pad.

XLA overlaps the ppermute with the conv compute where the schedule allows
(the reference only overlapped gradient reduction, never forward comms).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def halo_exchange(x_local, halo: int, axis_name: str):
    """Inside shard_map: x_local [N, Hl, W, C]. Returns [N, Hl+2*halo, W, C]
    with neighbor rows (zeros at global edges)."""
    n_dev = lax.axis_size(axis_name)
    if halo == 0 or n_dev == 1:
        return jnp.pad(x_local, ((0, 0), (halo, halo), (0, 0), (0, 0)))
    down = [(i, i + 1) for i in range(n_dev - 1)]  # my bottom rows -> next's top
    up = [(i + 1, i) for i in range(n_dev - 1)]  # my top rows -> prev's bottom
    top_halo = lax.ppermute(x_local[:, -halo:], axis_name, down)
    bot_halo = lax.ppermute(x_local[:, :halo], axis_name, up)
    return jnp.concatenate([top_halo, x_local, bot_halo], axis=1)


def spatial_conv2d(x, w, bias=None, *, mesh: Mesh, kernel: Tuple[int, int],
                   padding: Tuple[int, int], axis_name: str = "model",
                   relu: bool = False):
    """Conv with H sharded over `axis_name`. Requires stride 1 and
    padding == (k-1)//2 ("same") on H — the halo doubles as global padding.
    x: [N, H, W, C] (H divisible by mesh axis size), w: HWIO."""
    kh, kw = kernel
    ph, pw = padding
    assert ph == (kh - 1) // 2, "spatial partitioning needs 'same' H padding"

    def fn(x_l, w_l, b_l):
        ext = halo_exchange(x_l, ph, axis_name)
        out = lax.conv_general_dilated(
            ext, w_l, (1, 1),
            [(0, 0), (pw, pw)],  # H already padded by halo
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        )
        if b_l is not None:
            out = out + b_l
        if relu:
            out = jnp.maximum(out, 0.0)
        return out

    if bias is None:
        fn2 = lambda x_l, w_l: fn(x_l, w_l, None)
        return jax.shard_map(
            fn2, mesh=mesh,
            in_specs=(P(None, axis_name, None, None), P()),
            out_specs=P(None, axis_name, None, None),
        )(x, w)
    return jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(None, axis_name, None, None), P(), P()),
        out_specs=P(None, axis_name, None, None),
    )(x, w, bias)


def spatial_sconv2d(x, aligned, *, mesh: Mesh, padding, policy,
                    axis_name: str = "model", relu: bool = False,
                    stride: Tuple[int, int] = (1, 1)):
    """Spatially-partitioned DIRECT sparse conv: halo exchange + a sparse
    executor per shard (zero internal H padding — the halo provides it).

    Each shard runs the full dispatcher (ops/conv.conv2d_sconv → the XBSP
    arms) on the halo-extended slab with padding=(0, pw), so its
    formulation is untouched.

    Hard edges handled (SURVEY §7 flagged these): stride>1 needs each
    shard's row count divisible by the stride so the downsample phase is
    shard-invariant — the local output start j'*s - ph lands at extended
    row j'*s regardless of the shard's global offset. Grouped conv is
    block-diagonal in the GEMM view (weight_align expands it), with no
    spatial interaction, so the halo math is unchanged.
    """
    kh, kw = aligned.kernel_shape
    ph, pw = padding
    sh, sw = stride
    assert ph == (kh - 1) // 2, "spatial partitioning needs 'same' H padding"
    n_shards = mesh.shape[axis_name]
    h_local = x.shape[1] // n_shards
    if h_local % sh:
        raise ValueError(
            f"stride {sh} needs per-shard rows ({h_local}) divisible by it")

    from caffe_escoin_tpu.ops import conv as conv_ops

    def fn(x_l):
        ext = halo_exchange(x_l, ph, axis_name)
        out = conv_ops.conv2d_sconv(
            ext, aligned, stride=stride, padding=(0, pw),
            dilation=(1, 1), relu=relu, policy=policy,
            batch_parallel=True)
        # the extended slab can admit a trailing partial window the global
        # conv doesn't have; keep exactly the shard's output rows
        return out[:, : x_l.shape[1] // sh]

    # check_vma off: a traced pattern's Pallas kernel output carries no
    # varying-axis metadata
    return jax.shard_map(
        fn, mesh=mesh,
        in_specs=P(None, axis_name, None, None),
        out_specs=P(None, axis_name, None, None),
        check_vma=False,
    )(x)


def spatial_sconv_tower(x, aligneds, *, mesh: Mesh, policy,
                        axis_name: str = "model", relu: bool = True):
    """DEEP-HALO chain: a sequence of stride-1 'same'-pad sparse convs
    under ONE shard_map entry and ONE halo exchange.

    The per-call fixed cost of shard_map + ppermute weighs most on small
    (14x14/7x7) layers. Instead of exchanging (kh-1)/2 rows per layer,
    exchange the SUM of the chain's halos once, then let each conv consume
    its margin: layer i computes on a slab extended by sum_{j>=i} ph_j
    rows, so its edge rows are exactly the values the global net computes
    there (zero ppermute fill == global zero padding, layer by layer).
    Per-layer fixed cost drops to 1/L of a call; the price is duplicated
    compute on the shrinking margin (tiny exactly where the fixed cost
    hurt — small maps). 1x1 layers chain through with zero halo (margin
    rows ride along). Reference analogue: `copy_input_data` padded once
    per layer (`math_functions.cu:729-766`); it had no multi-device halo
    at all."""
    from caffe_escoin_tpu.ops import conv as conv_ops

    phs = []
    for a in aligneds:
        kh, kw = a.kernel_shape
        phs.append(((kh - 1) // 2, (kw - 1) // 2))
    total = sum(ph for ph, _ in phs)
    n_shards = mesh.shape[axis_name]
    if x.shape[1] // n_shards < total:
        raise ValueError(
            f"deep halo {total} exceeds per-shard rows "
            f"{x.shape[1] // n_shards}; split the chain")

    def fn(x_l):
        idx = lax.axis_index(axis_name)
        n_dev = lax.axis_size(axis_name)
        ext = halo_exchange(x_l, total, axis_name)
        m = total
        for a, (ph, pw) in zip(aligneds, phs):
            # full dispatcher in SCONV_PAR mode (below-threshold layers
            # fall back to their dense arm); zero H padding — each conv
            # consumes 2*ph margin rows
            from caffe_escoin_tpu.engine.context import ConvMode

            ext = conv_ops.conv2d(
                ext, a, stride=(1, 1), padding=(0, pw), dilation=(1, 1),
                relu=relu, policy=policy, mode=ConvMode.SCONV_PAR)
            m -= ph
            if m > 0:
                # GLOBAL-edge correction: the global net re-pads every
                # layer with zeros, so an edge shard's remaining margin
                # rows must be zero — not the conv-of-real-data the deep
                # margin computes there (an edge mismatch without
                # this). Interior shards keep neighbor-region
                # values. The select fuses into the epilogue.
                h_ext = ext.shape[1]
                rows = jnp.arange(h_ext)[None, :, None, None]
                bad = ((idx == 0) & (rows < m)) | (
                    (idx == n_dev - 1) & (rows >= h_ext - m))
                ext = jnp.where(bad, jnp.zeros((), ext.dtype), ext)
        return ext

    return jax.shard_map(
        fn, mesh=mesh,
        in_specs=P(None, axis_name, None, None),
        out_specs=P(None, axis_name, None, None),
        check_vma=False,
    )(x)


def spatial_sconv_chain(x, aligneds, *, mesh: Mesh, policy,
                        axis_name: str = "model", relu: bool = True):
    """Chain of stride-1 'same'-pad sparse convs under ONE shard_map
    entry with PER-LAYER halo exchanges (no margin duplication).

    The middle point between per-layer `spatial_sconv2d` calls (L
    shard_map entries, L exchanges) and `spatial_sconv_tower` (1 entry,
    1 exchange, duplicated margin compute that loses on one device): one
    entry, L exchanges, exact per-layer compute. On a single device the
    fixed shard_map dispatch amortizes over the whole chain — what small
    (7x7) maps pay most under per-layer chaining — and across devices each
    exchange is still just one ppermute of (kh-1)/2 rows. Exactness: stride-1 kh=2*ph+1
    convs return exactly the shard's rows (h + 2ph - kh + 1 == h), and
    ppermute's zero fill at global edges IS the global zero padding."""
    from caffe_escoin_tpu.engine.context import ConvMode
    from caffe_escoin_tpu.ops import conv as conv_ops

    phs = []
    for a in aligneds:
        kh, kw = a.kernel_shape
        assert kh % 2 == 1, "spatial chain needs odd kernels ('same' pad)"
        phs.append(((kh - 1) // 2, (kw - 1) // 2))

    def fn(x_l):
        out = x_l
        for a, (ph, pw) in zip(aligneds, phs):
            ext = halo_exchange(out, ph, axis_name)
            out = conv_ops.conv2d(
                ext, a, stride=(1, 1), padding=(0, pw), dilation=(1, 1),
                relu=relu, policy=policy, mode=ConvMode.SCONV_PAR)
        return out

    return jax.shard_map(
        fn, mesh=mesh,
        in_specs=P(None, axis_name, None, None),
        out_specs=P(None, axis_name, None, None),
        check_vma=False,
    )(x)

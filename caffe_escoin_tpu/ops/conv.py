"""Convolution with runtime-mode dispatch.

The counterpart of `BaseConvolutionLayer`'s forward paths
(`src/caffe/layers/base_conv_layer.cpp:532-848`) and the per-mode branch in
`ConvolutionLayer::Forward` (`src/caffe/layers/conv_layer.cpp:24-63`,
`conv_layer.cu:7-40`):

* LOWERED_GEMM   -> `lax.conv_general_dilated` (XLA's conv; the analogue
                    of im2col+cuBLAS, but fused — XLA never materializes cols).
* LOWERED_SPARSE -> im2col + SpMM on the sparse GEMM-view weight (BSC block
                    kernel, or ELL gather kernel for unstructured).
* SCONV          -> direct sparse convolution: the XBSP executors
                    (kernels/xla_block_sparse.py) when the pattern is
                    concrete, image by image; LOWERED_SPARSE when it is traced.
* SCONV_PAR      -> the same with the whole batch in every dot's M dimension.

Profitability fallback mirrors the reference's density thresholds
(`base_conv_layer.cpp:548,727,752`) but is policy-configurable: a layer whose
weight is denser than the threshold silently executes LOWERED_GEMM.

All paths are pure functions of (x, aligned_weight) and jit-compatible; mode
selection is trace-time static.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
from jax import lax

from caffe_escoin_tpu.engine.context import ConvMode, ExecutionPolicy, SparseFormat
from caffe_escoin_tpu.kernels import spmm as spmm_kernels
from caffe_escoin_tpu.sparse.weight_align import AlignedConvWeight


def _out_spatial(size, k, s, p, d):
    return (size + 2 * p - d * (k - 1) - 1) // s + 1


def im2col(x, kernel, *, stride, padding, dilation):
    """Patch extraction, (kh, kw, c) column order. jit-friendly slicing; XLA
    fuses the shifted slices (reference: `src/caffe/util/im2col.cu`)."""
    n, h, w, c = x.shape
    kh, kw = kernel
    sh, sw = stride
    ph, pw = padding
    dh, dw = dilation
    ho = _out_spatial(h, kh, sh, ph, dh)
    wo = _out_spatial(w, kw, sw, pw, dw)
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
    return jnp.concatenate(cols, axis=-1), (ho, wo)


def _epilogue(out, bias, relu, residual=None):
    if bias is not None:
        out = out + bias
    if residual is not None:
        # fused Eltwise-sum (nn/fuse.py pass B): the residual add rides the
        # conv epilogue instead of a separate whole-feature-map pass
        out = out + residual.astype(out.dtype)
    if relu:
        out = jnp.maximum(out, 0.0)
    return out


def conv2d_dense(x, w_hwio, bias=None, *, stride=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, relu=False, residual=None):
    """Dense conv: the LOWERED_GEMM mode and the training path."""
    out = lax.conv_general_dilated(
        x,
        w_hwio,
        window_strides=stride,
        padding=[(padding[0], padding[0]), (padding[1], padding[1])],
        rhs_dilation=dilation,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups,
    )
    return _epilogue(out, bias, relu, residual)


def convnd_dense(x, w, bias=None, *, stride=None, padding=None,
                 dilation=None, groups=1, relu=False):
    """Dense N-D convolution, any spatial rank (1-D/3-D/...).

    The analogue of the reference's `im2col_nd_*` dense path
    (`src/caffe/util/im2col.cpp:141+`, exercised by the 3-D cases of
    `src/caffe/test/test_convolution_layer.cpp`): XLA's conv handles N
    spatial dims natively, no materialized columns. x: [N, *S, Cin],
    w: [*K, Cin/g, Cout] -> [N, *So, Cout]. Sparse execution stays 2-D
    (as in the reference, whose sconv kernels are 2-D only)."""
    nsp = x.ndim - 2
    if w.ndim != nsp + 2:
        raise ValueError(f"weight rank {w.ndim} does not match input "
                         f"spatial rank {nsp}")
    letters = "TZDHW"[5 - nsp:]
    lhs = "N" + letters + "C"
    rhs = letters + "IO"
    stride = tuple(stride or (1,) * nsp)
    padding = [(p, p) for p in (padding or (0,) * nsp)]
    dilation = tuple(dilation or (1,) * nsp)
    out = lax.conv_general_dilated(
        x, w, stride, padding, rhs_dilation=dilation,
        dimension_numbers=(lhs, rhs, lhs), feature_group_count=groups,
    )
    return _epilogue(out, bias, relu)


def conv2d_lowered_sparse(x, aligned: AlignedConvWeight, *, stride, padding,
                          dilation, relu, policy: ExecutionPolicy,
                          residual=None):
    """im2col + SpMM over the sparse GEMM-view weight."""
    kh, kw = aligned.kernel_shape
    cols, (ho, wo) = im2col(x, (kh, kw), stride=stride, padding=padding,
                            dilation=dilation)
    n = x.shape[0]
    cols2d = cols.reshape(n * ho * wo, kh * kw, aligned.cin)
    if aligned.cin_pad != aligned.cin:
        # channel padding keeps K-blocks offset-aligned (weight_align pads the
        # GEMM-view weight the same way)
        cols2d = jnp.pad(
            cols2d, ((0, 0), (0, 0), (0, aligned.cin_pad - aligned.cin))
        )
    cols2d = cols2d.reshape(n * ho * wo, aligned.k)
    from caffe_escoin_tpu.kernels import xla_block_sparse

    if policy.sparse_format == SparseFormat.ELL and aligned.ell_t is not None:
        # reference CSR orientation: rows = output channels
        out_t = spmm_kernels.ell_spmm(aligned.ell_t, cols2d.T)
        out2d = out_t.T
    elif xla_block_sparse.spmm_supported(aligned.bsc, policy):
        # concrete pattern: same static block unroll the FC fast path uses
        out2d = xla_block_sparse.spmm(cols2d, aligned.bsc)
    else:
        out2d = spmm_kernels.bsc_spmm_traced(cols2d, aligned.bsc, policy)
    out = out2d.reshape(n, ho, wo, aligned.cout)
    return _epilogue(out, aligned.bias, relu, residual)


def conv2d_sconv(x, aligned: AlignedConvWeight, *, stride, padding, dilation,
                 relu, policy: ExecutionPolicy, batch_parallel: bool,
                 residual=None):
    """Direct sparse convolution.

    A concrete pattern runs on the XBSP executors (any stride, dilation and
    groups); a traced one falls back to the lowered sparse path, as the
    reference falls back from its tuned kernels
    (`math_functions.cu:613-668`) to `sconv_dilation`/gemm.
    """
    from caffe_escoin_tpu.kernels import xla_block_sparse

    # Non-unit stride: strided XBSP operands make every dot re-read the
    # ifmap through a strided access pattern. For 1x1 the stride commutes
    # with the conv: subsample ONCE (a single
    # strided relayout) and run the stride-1 sparse path on the quarter-size
    # ifmap. For k>1 fall back to dense conv, which handles striding in its
    # native tiling — the reference's tuned kernels were unit-stride too
    # (`sconv_unit_stride`, sconv.hpp:57) with a generic fallback.
    if stride != (1, 1):
        if aligned.kernel_shape == (1, 1) and dilation == (1, 1):
            xs = x[:, ::stride[0], ::stride[1], :]
            if padding != (0, 0):
                xs = jnp.pad(x, ((0, 0), (padding[0], padding[0]),
                                 (padding[1], padding[1]), (0, 0)))[
                    :, ::stride[0], ::stride[1], :]
            return conv2d_sconv(
                xs, aligned, stride=(1, 1), padding=(0, 0),
                dilation=(1, 1), relu=relu, policy=policy,
                batch_parallel=batch_parallel, residual=residual)
        if getattr(policy, "use_xla_sparse", True):
            return conv2d_dense(
                x, aligned.dense.astype(x.dtype), aligned.bias, stride=stride,
                padding=padding, dilation=dilation, groups=aligned.groups,
                relu=relu, residual=residual).astype(x.dtype)
        # use_xla_sparse=False (the forced lowered arm): keep the sparse
        # path alive for strided k>1 via im2col+SpMM
        return conv2d_lowered_sparse(
            x, aligned, stride=stride, padding=padding, dilation=dilation,
            relu=relu, policy=policy, residual=residual)

    # Native host path (csrc/sconv.cc): on the CPU backend, with the policy
    # opted in and the BSC concrete, run the threaded C++ blocked direct
    # sconv through pure_callback — the reference's CPU product path
    # (`caffe_cpu_blocked_sconv`, sconv.hpp:83-678). Dilation falls through
    # to the jnp executors.
    if (getattr(policy, "native_cpu", False) and dilation == (1, 1)
            and aligned.bsc is not None
            and xla_block_sparse.supported(aligned, policy)):
        import jax

        if jax.default_backend() == "cpu":
            from caffe_escoin_tpu.data import native as _native

            lib = _native.load_library()
            if lib is not None and hasattr(lib, "bsc_sconv"):
                import numpy as _np

                n, h, w, _ = x.shape
                kh_, kw_ = aligned.kernel_shape
                ho = (h + 2 * padding[0] - kh_) // stride[0] + 1
                wo = (w + 2 * padding[1] - kw_) // stride[1] + 1

                # the residual add happens BEFORE the ReLU, so with a
                # residual the kernel runs pre-activation and the
                # add + ReLU epilogue applies outside
                kernel_relu = relu and residual is None

                def _cb(xx):
                    out = _native.native_bsc_sconv(
                        _np.asarray(xx, _np.float32), aligned,
                        padding=padding, stride=stride, relu=kernel_relu)
                    return _np.asarray(out, _np.float32)

                out = jax.pure_callback(
                    _cb,
                    jax.ShapeDtypeStruct((n, ho, wo, aligned.cout),
                                         jnp.float32),
                    x.astype(jnp.float32))
                if residual is not None:
                    out = out + residual.astype(out.dtype)
                    if relu:
                        out = jnp.maximum(out, 0.0)
                return out.astype(x.dtype)

    # Primary arm: the XLA-native static block unroll (XBSP). XLA fuses
    # the pad/shift/slice into each dot's operand read, and the arm handles
    # stride/dilation/groups uniformly. Needs the sparsity pattern concrete
    # at trace time (aligned weights closed over — the standard inference
    # deployment).
    if xla_block_sparse.supported(aligned, policy):
        arm = xla_block_sparse.best_arm(
            aligned, policy, x_shape=x.shape, stride=stride,
            padding=padding, dilation=dilation,
            batch_parallel=batch_parallel)
        if arm == "dense":
            # write-bound full-union expand-1x1: XLA's dense conv IS the
            # ceiling (see xla_block_sparse.best_arm)
            return conv2d_dense(
                x, aligned.dense.astype(x.dtype), aligned.bias,
                stride=stride, padding=padding, dilation=dilation,
                groups=aligned.groups, relu=relu,
                residual=residual).astype(x.dtype)
        conv_fn = {"gathered": xla_block_sparse.conv_gathered,
                   "gathered_cols": xla_block_sparse.conv_gathered_cols,
                   }.get(arm, xla_block_sparse.conv)

        def _xbsp(y, res=residual):
            return conv_fn(
                y, aligned, stride=stride, padding=padding,
                dilation=dilation, relu=relu, residual=res)

        # SCONV vs SCONV_PAR keep the reference's distinction
        # (`conv_layer.cu:16-35`): SCONV processes the batch image-by-image
        # (one padded slab live at a time, `forward_gpu_sconv`'s per-image
        # loop — bounded activation memory); SCONV_PAR folds the whole batch
        # into every dot's M dimension (`forward_gpu_sconv_par`'s ×num_
        # padded buffer — weights fetched once per block for all images,
        # the throughput deployment shape).
        if batch_parallel or x.shape[0] == 1:
            return _xbsp(x)
        import jax

        if residual is not None:
            return jax.lax.map(
                lambda pair: _xbsp(pair[0][None], pair[1][None])[0],
                (x, residual))
        return jax.lax.map(lambda img: _xbsp(img[None], None)[0], x)

    # Traced pattern (weights passed as jit arguments): im2col + the
    # run-time SpMM executor.
    return conv2d_lowered_sparse(
        x, aligned, stride=stride, padding=padding, dilation=dilation,
        relu=relu, policy=policy, residual=residual)


def conv2d(
    x,
    aligned: AlignedConvWeight,
    *,
    stride: Tuple[int, int] = (1, 1),
    padding: Tuple[int, int] = (0, 0),
    dilation: Tuple[int, int] = (1, 1),
    relu: bool = False,
    mode: Optional[ConvMode] = None,
    policy: Optional[ExecutionPolicy] = None,
    residual=None,
):
    """Mode-dispatched convolution over an aligned weight."""
    policy = policy or ExecutionPolicy()
    mode = policy.conv_mode if mode is None else mode
    sparse_ready = aligned.bsc is not None or aligned.ell_t is not None

    if mode == ConvMode.LOWERED_SPARSE:
        profitable = aligned.sparsity >= policy.sparse_threshold
    elif mode in (ConvMode.SCONV, ConvMode.SCONV_PAR):
        profitable = aligned.sparsity >= policy.sconv_threshold
    else:
        profitable = False

    if mode == ConvMode.LOWERED_GEMM or not sparse_ready or not profitable:
        # match the activation dtype: the sparse arms cast their payloads
        # to x.dtype internally, and XLA's conv requires equal dtypes —
        # a bf16 policy caller (e.g. a halo-tower shard fn) must not
        # crash on a layer the dispatcher routes dense
        wd = aligned.dense
        if hasattr(x, "dtype") and wd.dtype != x.dtype:
            wd = wd.astype(x.dtype)
        return conv2d_dense(
            x, wd, aligned.bias, stride=stride, padding=padding,
            dilation=dilation, groups=aligned.groups, relu=relu,
            residual=residual,
        )
    if mode == ConvMode.LOWERED_SPARSE:
        return conv2d_lowered_sparse(
            x, aligned, stride=stride, padding=padding, dilation=dilation,
            relu=relu, policy=policy, residual=residual,
        )
    return conv2d_sconv(
        x, aligned, stride=stride, padding=padding, dilation=dilation,
        relu=relu, policy=policy,
        batch_parallel=(mode == ConvMode.SCONV_PAR), residual=residual,
    )

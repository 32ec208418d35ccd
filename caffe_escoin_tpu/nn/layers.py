"""The layer catalog.

Each class maps one reference layer type (`src/caffe/layers/*`) onto the pure
ops in `caffe_escoin_tpu.ops`. Conv and InnerProduct carry the sparse-execution
machinery (WeightAlign -> AlignedConvWeight -> mode dispatch); everything else
is thin. Layer params are plain dicts of arrays so the whole net's params form
one pytree for jit/grad/pjit.
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from caffe_escoin_tpu.engine.context import ConvMode
from caffe_escoin_tpu.nn.fillers import fill
from caffe_escoin_tpu.nn.net import Layer, register_layer
from caffe_escoin_tpu.ops import activations as act
from caffe_escoin_tpu.ops import conv as conv_ops
from caffe_escoin_tpu.ops import linear as linear_ops
from caffe_escoin_tpu.ops import losses as loss_ops
from caffe_escoin_tpu.ops import norm as norm_ops
from caffe_escoin_tpu.ops import pool as pool_ops
from caffe_escoin_tpu.ops import structural as struct_ops
from caffe_escoin_tpu.sparse.weight_align import AlignedConvWeight, weight_align


def _pair(v):
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v, v)


def _ntuple(v, n):
    """Caffe repeated-field semantics: scalar broadcasts to all spatial
    dims; a length-1 list too; otherwise one entry per dim."""
    if isinstance(v, (tuple, list)):
        t = tuple(v)
        if len(t) == 1:
            return t * n
        if len(t) != n:
            raise ValueError(f"expected {n} spatial values, got {t}")
        return t
    return (v,) * n


@register_layer("Input")
class InputLayer(Layer):
    """Declares an externally-fed blob (input_layer.cpp)."""

    category = "data"

    def apply(self, params, inputs, *, train, rng):
        return list(inputs)

    def out_shapes(self, params, in_shapes):
        return list(in_shapes)


@register_layer("Convolution")
class ConvolutionLayer(Layer):
    """Mode-dispatched conv (conv_layer.cpp / base_conv_layer.cpp).

    params keys: num_output, kernel (int or per-dim list), stride, pad,
    dilation, group, bias_term, weight_filler, bias_filler, fuse_relu.

    N-D: a rank-(2+n) input [N, *spatial, C] runs an n-spatial-dim dense
    convolution (the reference's `im2col_nd_*` path,
    `src/caffe/util/im2col.cpp:141+`; 3-D cases in
    `test_convolution_layer.cpp`). Sparse execution is 2-D only, exactly
    like the reference's sconv kernels.
    """

    category = "conv"

    def _conf(self, in_shape):
        p = self.p
        nsp = len(in_shape) - 2
        r_in = p.get("pack_in", 1)
        return dict(
            nsp=nsp,
            kernel=_ntuple(p.get("kernel", 3), nsp),
            stride=_ntuple(p.get("stride", 1), nsp),
            pad=_ntuple(p.get("pad", 0), nsp),
            dilation=_ntuple(p.get("dilation", 1), nsp),
            groups=p.get("group", 1),
            cout=p["num_output"],
            bias=p.get("bias_term", True),
            cin=in_shape[-1] // r_in,  # logical channels (W-pack aware)
        )

    def _pack(self):
        """(r_in, r_out) W-pack factors set by nn/fuse.pack_narrow_chains
        (ops/wpack.py layout; (1, 1) = ordinary unpacked execution)."""
        return self.p.get("pack_in", 1), self.p.get("pack_out", 1)

    def init_params(self, rng, in_shapes):
        c = self._conf(in_shapes[0])
        cin_g = c["cin"] // c["groups"]
        r1, r2 = jax.random.split(rng)
        fan_in = int(np.prod(c["kernel"])) * cin_g
        w = fill(r1, tuple(c["kernel"]) + (cin_g, c["cout"]),
                 self.p.get("weight_filler", {"type": "xavier"}), fan_in=fan_in)
        params = {"w": w}
        if c["bias"]:
            params["b"] = fill(r2, (c["cout"],),
                               self.p.get("bias_filler", {"type": "constant"}))
        return params

    def align(self, params):
        if isinstance(params, AlignedConvWeight):
            return params
        if params["w"].ndim != 4:
            return params  # N-D conv: dense path only (as in the reference)
        r_in, r_out = self._pack()
        if r_in > 1 or r_out > 1:
            # sparse-compile the W-PACKED reparametrization (ops/wpack.py):
            # the aligned BSC pattern is the packed weight's own zero
            # structure, so the XBSP executors run the full-lane problem
            # natively
            from caffe_escoin_tpu.ops import wpack as _wpack

            p = self.p
            kw = _ntuple(p.get("kernel", 3), 2)[1]
            sw = _ntuple(p.get("stride", 1), 2)[1]
            pw = _ntuple(p.get("pad", 0), 2)[1]
            w = np.asarray(jax.device_get(params["w"]))
            wp, _, _ = _wpack.repack_weight(
                w, r_in, r_out, sw, pw, int(p["pack_w"]))
            b = params.get("b")
            if b is not None:
                b = np.tile(np.asarray(jax.device_get(b)), r_out)
            return weight_align(wp, b, groups=1, policy=self.policy)
        return weight_align(
            params["w"], params.get("b"), groups=self.p.get("group", 1),
            policy=self.policy,
        )

    def apply(self, params, inputs, *, train, rng):
        x = inputs[0]
        # fused Eltwise-sum residual (nn/fuse.py pass B): second bottom is
        # added in the conv epilogue before the fused ReLU
        residual = (inputs[1] if len(inputs) > 1 and self.p.get("fuse_add")
                    else None)
        c = self._conf(x.shape)
        fuse_relu = self.p.get("fuse_relu", False) and self.policy.fuse_relu
        cd = self.policy.compute_dtype
        in_dtype = x.dtype
        if cd is not None:
            # mixed precision: bf16 operands, f32 accumulation inside the
            # kernels (preferred_element_type), output cast back
            x = x.astype(cd)
            params = jax.tree_util.tree_map(
                lambda l: l.astype(cd)
                if hasattr(l, "dtype") and jnp.issubdtype(l.dtype, jnp.floating)
                else l,
                params,
            )
        sd = self.p.get("s2d_r")
        if sd:
            # space-to-depth stem reformulation (ops/s2d.py; set by
            # nn/fuse.fold_stem_s2d): the strided small-cin conv runs as a
            # stride-1 conv over the [N, H/r, W/r, r*r*C] layout. The spec's
            # kernel/stride/pad already describe the REMAPPED kernel; only
            # the input needs the layout transform here.
            from caffe_escoin_tpu.ops import s2d as s2d_ops

            x = s2d_ops.s2d_input(x, sd, tuple(self.p["s2d_kernel"]),
                                  tuple(self.p["s2d_pad"]))
            c = self._conf(x.shape)
        r_in, r_out = self._pack()
        if c["nsp"] != 2:
            out = conv_ops.convnd_dense(
                x, params["w"], params.get("b"), stride=c["stride"],
                padding=c["pad"], dilation=c["dilation"], groups=c["groups"],
                relu=fuse_relu,
            )
            if residual is not None:
                raise ValueError("fuse_add is 2-D only")
        elif r_in > 1 or r_out > 1:
            # W-packed execution (ops/wpack.py): x is [N, H, W/r_in,
            # r_in*Cin]; the conv runs in the packed domain with the
            # repacked kernel geometry; output is [N, Ho, Wo/r_out,
            # r_out*Cout]. Residual (fuse_add) arrives in the SAME packed
            # layout by pass construction.
            from caffe_escoin_tpu.ops import wpack as _wpack

            (kh, kw), (sh, sw) = c["kernel"], c["stride"]
            (ph, pw) = c["pad"]
            w_in = x.shape[2] * r_in
            kw_p, (pl, _), s_p, _, _ = _wpack.repack_geometry(
                kw, r_in, r_out, sw, pw, w_in)
            if isinstance(params, AlignedConvWeight):
                out = conv_ops.conv2d(
                    x, params, stride=(sh, s_p), padding=(ph, pl),
                    dilation=(1, 1), relu=fuse_relu, policy=self.policy,
                    residual=residual,
                )
            else:
                wp, _, _ = _wpack.repack_weight(
                    params["w"], r_in, r_out, sw, pw, w_in)
                b = params.get("b")
                if b is not None:
                    b = jnp.tile(b, r_out)
                out = conv_ops.conv2d_dense(
                    x, wp, b, stride=(sh, s_p), padding=(ph, pl),
                    dilation=(1, 1), groups=1, relu=fuse_relu,
                    residual=residual,
                )
        elif isinstance(params, AlignedConvWeight):
            out = conv_ops.conv2d(
                x, params, stride=c["stride"], padding=c["pad"],
                dilation=c["dilation"], relu=fuse_relu, policy=self.policy,
                residual=residual,
            )
        else:
            out = conv_ops.conv2d_dense(
                x, params["w"], params.get("b"), stride=c["stride"],
                padding=c["pad"], dilation=c["dilation"], groups=c["groups"],
                relu=fuse_relu, residual=residual,
            )
        if cd is not None and self.policy.cast_back:
            out = out.astype(in_dtype)
        return [out]


@register_layer("ConvolutionReLU")
class ConvolutionReLULayer(ConvolutionLayer):
    """Conv with ReLU fused into the sparse kernel epilogue
    (conv_relu_layer.cpp; `sconv_relu_*` kernels)."""

    def __init__(self, spec, policy):
        super().__init__(spec, policy)
        self.p["fuse_relu"] = True


@register_layer("EscConvolution")
class EscConvolutionLayer(ConvolutionLayer):
    """The reference's dense-baseline conv (esc_conv_layer.cu pins cuDNN
    IMPLICIT_GEMM). Here the pinned dense baseline is XLA's conv; this
    subclass forces LOWERED_GEMM regardless of net policy."""

    def __init__(self, spec, policy):
        super().__init__(spec, policy.replace(conv_mode=ConvMode.LOWERED_GEMM))


@register_layer("InnerProduct")
class InnerProductLayer(Layer):
    """FC layer (inner_product_layer.cpp). Sparse execution reuses the conv
    SpMM machinery via a 1x1 GEMM-view AlignedConvWeight."""

    category = "fc"

    def init_params(self, rng, in_shapes):
        k = int(np.prod(in_shapes[0][1:]))
        m = self.p["num_output"]
        r1, r2 = jax.random.split(rng)
        params = {"w": fill(r1, (k, m), self.p.get("weight_filler", {"type": "xavier"}),
                            fan_in=k)}
        if self.p.get("bias_term", True):
            params["b"] = fill(r2, (m,), self.p.get("bias_filler", {"type": "constant"}))
        return params

    def align(self, params):
        if isinstance(params, AlignedConvWeight):
            return params
        w = np.asarray(jax.device_get(params["w"]))  # (K, M)
        return weight_align(
            w[None, None], params.get("b"), policy=self.policy
        )

    def apply(self, params, inputs, *, train, rng):
        (x,) = inputs
        x2 = x.reshape(x.shape[0], -1)
        fuse_relu = self.p.get("fuse_relu", False) and self.policy.fuse_relu
        cd = self.policy.compute_dtype
        in_dtype = x.dtype
        if cd is not None:
            x2 = x2.astype(cd)
            params = jax.tree_util.tree_map(
                lambda l: l.astype(cd)
                if hasattr(l, "dtype")
                and jnp.issubdtype(l.dtype, jnp.floating) else l,
                params,
            )
        if isinstance(params, AlignedConvWeight):
            aligned = params
            # forced executor arm (diagnostics) is honored BEFORE the
            # block-density gate, mirroring best_arm's ordering in the conv
            # dispatcher: --xbsp-arm dense forces the dense matmul, any
            # forced sparse arm exercises the sparse path even on
            # block-dense weights (so conv and fc forced-arm semantics
            # agree)
            forced = getattr(self.policy, "xbsp_arm", "auto")
            if forced != "auto":
                use_sparse = (forced != "dense"
                              and aligned.bsc is not None
                              and self.policy.conv_mode
                              != ConvMode.LOWERED_GEMM)
            else:
                use_sparse = (
                    aligned.bsc is not None
                    and aligned.sparsity >= self.policy.sparse_threshold
                    # block-density profitability, same gate as the conv
                    # dispatcher (xla_block_sparse.best_arm): an
                    # element-sparse but block-dense pattern (unstructured
                    # pruning) does ~dense FLOPs through the block unroll —
                    # run the one dense matmul instead
                    and aligned.block_density <= 0.5
                    and self.policy.conv_mode != ConvMode.LOWERED_GEMM
                )
            if use_sparse:
                if aligned.cin_pad != aligned.cin:
                    x2 = jnp.pad(x2, ((0, 0), (0, aligned.cin_pad - aligned.cin)))
                out = linear_ops.linear_sparse(x2, aligned.bsc, aligned.bias,
                                               policy=self.policy,
                                               relu=fuse_relu)
            else:
                w = aligned.dense.reshape(-1, aligned.cout)
                out = linear_ops.linear(x2, w, aligned.bias, relu=fuse_relu)
        else:
            out = linear_ops.linear(x2, params["w"], params.get("b"),
                                    relu=fuse_relu)
        if cd is not None and self.policy.cast_back:
            out = out.astype(in_dtype)
        return [out]


@register_layer("Pooling")
class PoolingLayer(Layer):
    def apply(self, params, inputs, *, train, rng):
        (x,) = inputs
        p = self.p
        if p.get("global_pooling", False):
            return [pool_ops.pool2d(x, (1, 1), mode=p.get("mode", "avg"),
                                    global_pool=True)]
        if p.get("pack_out", 1) > 1 or p.get("pack_in", 1) > 1:
            # W-pair packed layout in/out (ops/wpack.py; set by
            # nn/fuse.pack_narrow_chains): packed chains flow THROUGH the
            # pool instead of dying at it
            return [pool_ops.pool2d_packed(
                x, _pair(p.get("kernel", 2)),
                stride=_pair(p.get("stride", p.get("kernel", 2))),
                padding=_pair(p.get("pad", 0)), mode=p.get("mode", "max"),
                ceil_mode=p.get("ceil_mode", True),
                r_in=p.get("pack_in", 1), r_out=p.get("pack_out", 1))]
        return [
            pool_ops.pool2d(
                x,
                _pair(p.get("kernel", 2)),
                stride=_pair(p.get("stride", p.get("kernel", 2))),
                padding=_pair(p.get("pad", 0)),
                mode=p.get("mode", "max"),
                ceil_mode=p.get("ceil_mode", True),
                train=train,
                rng=rng,
            )
        ]


@register_layer("ReLU")
class ReLULayer(Layer):
    def apply(self, params, inputs, *, train, rng):
        return [act.relu(inputs[0], self.p.get("negative_slope", 0.0))]


@register_layer("PReLU")
class PReLULayer(Layer):
    def init_params(self, rng, in_shapes):
        c = in_shapes[0][-1]
        n = 1 if self.p.get("channel_shared", False) else c
        return {"alpha": jnp.full((n,), self.p.get("alpha_init", 0.25), jnp.float32)}

    def apply(self, params, inputs, *, train, rng):
        return [act.prelu(inputs[0], params["alpha"])]


@register_layer("ELU")
class ELULayer(Layer):
    def apply(self, params, inputs, *, train, rng):
        return [act.elu(inputs[0], self.p.get("alpha", 1.0))]


@register_layer("Sigmoid")
class SigmoidLayer(Layer):
    def apply(self, params, inputs, *, train, rng):
        return [act.sigmoid(inputs[0])]


@register_layer("TanH")
class TanHLayer(Layer):
    def apply(self, params, inputs, *, train, rng):
        return [act.tanh(inputs[0])]


@register_layer("BNLL")
class BNLLLayer(Layer):
    def apply(self, params, inputs, *, train, rng):
        return [act.bnll(inputs[0])]


@register_layer("AbsVal")
class AbsValLayer(Layer):
    def apply(self, params, inputs, *, train, rng):
        return [act.absval(inputs[0])]


@register_layer("Power")
class PowerLayer(Layer):
    def apply(self, params, inputs, *, train, rng):
        return [act.power(inputs[0], self.p.get("power", 1.0),
                          self.p.get("scale", 1.0), self.p.get("shift", 0.0))]


@register_layer("Exp")
class ExpLayer(Layer):
    def apply(self, params, inputs, *, train, rng):
        return [act.exp(inputs[0], self.p.get("base", -1.0),
                        self.p.get("scale", 1.0), self.p.get("shift", 0.0))]


@register_layer("Log")
class LogLayer(Layer):
    def apply(self, params, inputs, *, train, rng):
        return [act.log(inputs[0], self.p.get("base", -1.0),
                        self.p.get("scale", 1.0), self.p.get("shift", 0.0))]


@register_layer("Threshold")
class ThresholdLayer(Layer):
    def apply(self, params, inputs, *, train, rng):
        return [act.threshold(inputs[0], self.p.get("threshold", 0.0))]


@register_layer("Dropout")
class DropoutLayer(Layer):
    def apply(self, params, inputs, *, train, rng):
        return [act.dropout(inputs[0], self.p.get("ratio", 0.5), rng=rng, train=train)]


@register_layer("Softmax")
class SoftmaxLayer(Layer):
    def apply(self, params, inputs, *, train, rng):
        return [act.softmax(inputs[0], self.p.get("axis", -1))]


@register_layer("SoftmaxWithLoss")
class SoftmaxWithLossLayer(Layer):
    def __init__(self, spec, policy):
        super().__init__(spec, policy)
        if spec.loss_weight == 0.0:
            object.__setattr__(spec, "loss_weight", 1.0)

    def apply(self, params, inputs, *, train, rng):
        logits, labels = inputs
        return [loss_ops.softmax_cross_entropy(
            logits, labels, ignore_label=self.p.get("ignore_label"))]


@register_layer("SigmoidCrossEntropyLoss")
class SigmoidCELossLayer(Layer):
    def __init__(self, spec, policy):
        super().__init__(spec, policy)
        if spec.loss_weight == 0.0:
            object.__setattr__(spec, "loss_weight", 1.0)

    def apply(self, params, inputs, *, train, rng):
        return [loss_ops.sigmoid_cross_entropy(inputs[0], inputs[1])]


@register_layer("EuclideanLoss")
class EuclideanLossLayer(Layer):
    def __init__(self, spec, policy):
        super().__init__(spec, policy)
        if spec.loss_weight == 0.0:
            object.__setattr__(spec, "loss_weight", 1.0)

    def apply(self, params, inputs, *, train, rng):
        return [loss_ops.euclidean_loss(inputs[0], inputs[1])]


@register_layer("HingeLoss")
class HingeLossLayer(Layer):
    def __init__(self, spec, policy):
        super().__init__(spec, policy)
        if spec.loss_weight == 0.0:
            object.__setattr__(spec, "loss_weight", 1.0)

    def apply(self, params, inputs, *, train, rng):
        return [loss_ops.hinge_loss(inputs[0], inputs[1],
                                    norm=self.p.get("norm", "L1"))]


@register_layer("Accuracy")
class AccuracyLayer(Layer):
    def apply(self, params, inputs, *, train, rng):
        return [loss_ops.accuracy(inputs[0], inputs[1],
                                  top_k=self.p.get("top_k", 1),
                                  ignore_label=self.p.get("ignore_label"))]


@register_layer("LRN")
class LRNLayer(Layer):
    def apply(self, params, inputs, *, train, rng):
        return [norm_ops.lrn_across_channels(
            inputs[0],
            local_size=self.p.get("local_size", 5),
            alpha=self.p.get("alpha", 1e-4),
            beta=self.p.get("beta", 0.75),
            k=self.p.get("k", 1.0),
            # W-pair packed layout: normalize each pixel-phase's logical
            # channel block independently (nn/fuse.pack_narrow_chains)
            groups=self.p.get("pack_in", 1),
        )]


@register_layer("BatchNorm")
class BatchNormLayer(Layer):
    """Caffe BatchNorm (batch_norm_layer.cpp). All three blobs are
    NON-trainable buffers (the reference pins them with lr_mult 0,
    `batch_norm_layer.cpp:30-46`), kept in the Net state collection:

      mean_acc / var_acc : decayed SUMS of batch statistics (blobs[0..1])
      count              : decayed normalization factor (blobs[2])

    Train forward normalizes by batch stats and accumulates
    ``acc = moving_average_fraction * acc + batch_stat`` with the variance
    bias-corrected by m/(m-1) (`batch_norm_layer.cpp:125-145`); test forward
    divides the sums by ``count`` (`:13-16,96-106`). The update is returned
    through the functional state channel (Net.apply return_state)."""

    has_state = True

    def init_state(self, in_shapes):
        c = in_shapes[0][-1]
        return {
            "mean_acc": jnp.zeros((c,), jnp.float32),
            "var_acc": jnp.zeros((c,), jnp.float32),
            "count": jnp.zeros((), jnp.float32),
        }

    def _moving(self, state):
        # blobs[2]==0 -> scale 0 -> stats (0, 1-ish): normalize-by-nothing,
        # matching the reference's scale_factor = 0 case
        inv_n = jnp.where(state["count"] > 0, 1.0 / jnp.maximum(state["count"], 1e-30), 0.0)
        mean = state["mean_acc"] * inv_n
        var = jnp.where(state["count"] > 0, state["var_acc"] * inv_n, 1.0)
        return mean, var

    def apply_stateful(self, params, state, inputs, *, train, rng):
        (x,) = inputs
        eps = self.p.get("eps", 1e-5)
        use_global = self.p.get("use_global_stats")
        if use_global is None:
            use_global = not train
        if use_global:
            mean, var = self._moving(state)
            return [norm_ops.batch_norm_inference(x, mean, var, eps=eps)], state
        # normalize over all non-channel dims (rank-2 fc inputs, rank-3 1-D
        # conv, rank-4 NHWC all work; channel is last)
        axes = tuple(range(x.ndim - 1))
        out, bmean, bvar = norm_ops.batch_norm_train(x, axis=axes, eps=eps)
        lam = self.p.get("moving_average_fraction", 0.999)
        m = float(np.prod([x.shape[i] for i in axes]))
        bias_corr = m / (m - 1.0) if m > 1 else 1.0
        new_state = {
            "mean_acc": lam * state["mean_acc"] + bmean,
            "var_acc": lam * state["var_acc"] + bias_corr * bvar,
            "count": lam * state["count"] + 1.0,
        }
        return [out], new_state

    def apply(self, params, inputs, *, train, rng):
        outs, _ = self.apply_stateful(params, self.init_state(
            [inputs[0].shape]), inputs, train=train, rng=rng)
        return outs

    def out_shapes(self, params, in_shapes):
        return list(in_shapes)


@register_layer("Scale")
class ScaleLayer(Layer):
    def init_params(self, rng, in_shapes):
        c = in_shapes[0][-1]
        params = {"gamma": jnp.ones((c,), jnp.float32)}
        if self.p.get("bias_term", True):
            params["beta"] = jnp.zeros((c,), jnp.float32)
        return params

    def apply(self, params, inputs, *, train, rng):
        return [norm_ops.scale_bias(inputs[0], params["gamma"], params.get("beta"))]


@register_layer("MVN")
class MVNLayer(Layer):
    def apply(self, params, inputs, *, train, rng):
        return [norm_ops.mvn(inputs[0],
                             normalize_variance=self.p.get("normalize_variance", True))]


@register_layer("Concat")
class ConcatLayer(Layer):
    def apply(self, params, inputs, *, train, rng):
        return [struct_ops.concat(inputs, axis=self.p.get("axis", -1))]


@register_layer("Eltwise")
class EltwiseLayer(Layer):
    def apply(self, params, inputs, *, train, rng):
        return [struct_ops.eltwise(inputs, op=self.p.get("operation", "sum"),
                                   coeffs=self.p.get("coeffs"))]


@register_layer("Flatten")
class FlattenLayer(Layer):
    def apply(self, params, inputs, *, train, rng):
        return [struct_ops.flatten(inputs[0], self.p.get("axis", 1))]


@register_layer("Reshape")
class ReshapeLayer(Layer):
    def apply(self, params, inputs, *, train, rng):
        return [struct_ops.reshape(inputs[0], self.p["shape"])]


@register_layer("Slice")
class SliceLayer(Layer):
    def apply(self, params, inputs, *, train, rng):
        return list(struct_ops.slice_points(
            inputs[0], self.p["slice_points"], axis=self.p.get("axis", -1)))


@register_layer("Split")
class SplitLayer(Layer):
    def apply(self, params, inputs, *, train, rng):
        return list(struct_ops.split(inputs[0], len(self.spec.tops)))


@register_layer("Crop")
class CropLayer(Layer):
    def apply(self, params, inputs, *, train, rng):
        x, ref = inputs
        return [struct_ops.crop(x, ref.shape,
                                offsets=self.p.get("offsets", (0, 0)),
                                axes=self.p.get("axes", (1, 2)))]


@register_layer("Tile")
class TileLayer(Layer):
    def apply(self, params, inputs, *, train, rng):
        return [struct_ops.tile(inputs[0], self.p["tiles"], self.p.get("axis", -1))]


@register_layer("Reduction")
class ReductionLayer(Layer):
    def apply(self, params, inputs, *, train, rng):
        return [struct_ops.reduction(inputs[0], op=self.p.get("operation", "sum"),
                                     axis=self.p.get("axis"),
                                     coeff=self.p.get("coeff", 1.0))]


@register_layer("ArgMax")
class ArgMaxLayer(Layer):
    def apply(self, params, inputs, *, train, rng):
        return [struct_ops.argmax(inputs[0], self.p.get("axis", -1))]


@register_layer("Silence")
class SilenceLayer(Layer):
    """Consumes bottoms, produces NO tops (silence_layer.cpp) — prevents
    unconsumed blobs from appearing in Net.apply's final-tops dict."""

    def apply(self, params, inputs, *, train, rng):
        return []

    def out_shapes(self, params, in_shapes):
        return []


@register_layer("Deconvolution")
class DeconvolutionLayer(Layer):
    """Transposed conv (deconv_layer.cpp)."""

    category = "conv"

    def init_params(self, rng, in_shapes):
        p = self.p
        kh, kw = _pair(p.get("kernel", 3))
        cin = in_shapes[0][-1]
        r1, r2 = jax.random.split(rng)
        params = {"w": fill(r1, (kh, kw, cin, p["num_output"]),
                            p.get("weight_filler", {"type": "xavier"}),
                            fan_in=kh * kw * cin)}
        if p.get("bias_term", True):
            params["b"] = fill(r2, (p["num_output"],),
                               p.get("bias_filler", {"type": "constant"}))
        return params

    def apply(self, params, inputs, *, train, rng):
        from caffe_escoin_tpu.ops.deconv import deconv2d

        p = self.p
        return [deconv2d(inputs[0], params["w"], params.get("b"),
                         stride=_pair(p.get("stride", 1)),
                         padding=_pair(p.get("pad", 0)),
                         dilation=_pair(p.get("dilation", 1)))]


@register_layer("SPP")
class SPPLayer(Layer):
    def apply(self, params, inputs, *, train, rng):
        from caffe_escoin_tpu.ops.pool import spp

        return [spp(inputs[0], self.p.get("pyramid_height", 3),
                    mode=self.p.get("mode", "max"))]


@register_layer("Im2col")
class Im2colLayer(Layer):
    """Exposes the lowering as a layer (im2col_layer.cpp)."""

    def apply(self, params, inputs, *, train, rng):
        from caffe_escoin_tpu.ops.conv import im2col

        p = self.p
        cols, _ = im2col(inputs[0], _pair(p.get("kernel", 3)),
                         stride=_pair(p.get("stride", 1)),
                         padding=_pair(p.get("pad", 0)),
                         dilation=_pair(p.get("dilation", 1)))
        return [cols]


@register_layer("RNN")
class RNNLayer(Layer):
    """Caffe RNN over time-major [T,N,D] + cont [T,N] (rnn_layer.cpp)."""

    def init_params(self, rng, in_shapes):
        d = in_shapes[0][-1]
        h = self.p["num_output"]
        r1, r2, r3 = jax.random.split(rng, 3)
        wf = self.p.get("weight_filler", {"type": "xavier"})
        return {"wx": fill(r1, (d, h), wf, fan_in=d),
                "wh": fill(r2, (h, h), wf, fan_in=h),
                "b": fill(r3, (h,), self.p.get("bias_filler",
                                               {"type": "constant"}))}

    def apply(self, params, inputs, *, train, rng):
        from caffe_escoin_tpu.ops.recurrent import rnn_forward

        x, cont = inputs
        return [rnn_forward(x, cont, params["wx"], params["wh"], params["b"])]


@register_layer("LSTM")
class LSTMLayer(Layer):
    """Caffe LSTM (lstm_layer.cpp), gate order i,f,o,g."""

    def init_params(self, rng, in_shapes):
        d = in_shapes[0][-1]
        h = self.p["num_output"]
        r1, r2, r3 = jax.random.split(rng, 3)
        wf = self.p.get("weight_filler", {"type": "xavier"})
        return {"wx": fill(r1, (d, 4 * h), wf, fan_in=d),
                "wh": fill(r2, (h, 4 * h), wf, fan_in=h),
                "b": fill(r3, (4 * h,), self.p.get("bias_filler",
                                                   {"type": "constant"}))}

    def apply(self, params, inputs, *, train, rng):
        from caffe_escoin_tpu.ops.recurrent import lstm_forward

        x, cont = inputs
        hs, _ = lstm_forward(x, cont, params["wx"], params["wh"], params["b"])
        return [hs]


@register_layer("ContrastiveLoss")
class ContrastiveLossLayer(Layer):
    def __init__(self, spec, policy):
        super().__init__(spec, policy)
        if spec.loss_weight == 0.0:
            object.__setattr__(spec, "loss_weight", 1.0)

    def apply(self, params, inputs, *, train, rng):
        return [loss_ops.contrastive_loss(
            inputs[0], inputs[1], inputs[2],
            margin=self.p.get("margin", 1.0),
            legacy_version=self.p.get("legacy_version", False))]


@register_layer("MultinomialLogisticLoss")
class MultinomialLogisticLossLayer(Layer):
    def __init__(self, spec, policy):
        super().__init__(spec, policy)
        if spec.loss_weight == 0.0:
            object.__setattr__(spec, "loss_weight", 1.0)

    def apply(self, params, inputs, *, train, rng):
        return [loss_ops.multinomial_logistic_loss(inputs[0], inputs[1])]


@register_layer("InfogainLoss")
class InfogainLossLayer(Layer):
    def __init__(self, spec, policy):
        super().__init__(spec, policy)
        if spec.loss_weight == 0.0:
            object.__setattr__(spec, "loss_weight", 1.0)

    def apply(self, params, inputs, *, train, rng):
        import numpy as np

        h = self.p.get("infogain")
        if h is None:
            c = inputs[0].shape[-1]
            h = jnp.eye(c, dtype=inputs[0].dtype)
        return [loss_ops.infogain_loss(inputs[0], inputs[1], jnp.asarray(h))]


@register_layer("BatchReindex")
class BatchReindexLayer(Layer):
    """Gather batch items by an index blob (batch_reindex_layer.cpp)."""

    def apply(self, params, inputs, *, train, rng):
        x, idx = inputs
        return [jnp.take(x, idx.astype(jnp.int32), axis=0)]


@register_layer("Filter")
class FilterLayer(Layer):
    """Caffe Filter selects batch items where selector != 0. Data-dependent
    output shapes don't exist under XLA; we return the selector-masked batch
    (zeros elsewhere) plus the mask — callers reduce with the mask. This is
    the jit-compatible contract (documented deviation from
    filter_layer.cpp)."""

    def apply(self, params, inputs, *, train, rng):
        x, selector = inputs
        mask = (selector != 0).astype(x.dtype)
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        return [x * mask.reshape(shape), mask]


@register_layer("Parameter")
class ParameterLayer(Layer):
    """Emits a learnable blob (parameter_layer.cpp)."""

    def init_params(self, rng, in_shapes):
        return {"w": fill(rng, tuple(self.p["shape"]),
                          self.p.get("filler", {"type": "constant"}))}

    def apply(self, params, inputs, *, train, rng):
        return [params["w"]]

    def out_shapes(self, params, in_shapes):
        return [tuple(self.p["shape"])]


@register_layer("DummyData")
class DummyDataLayer(Layer):
    """Constant/filled blobs (dummy_data_layer.cpp)."""

    category = "data"

    def apply(self, params, inputs, *, train, rng):
        return [jnp.full(tuple(self.p["shape"]),
                         self.p.get("value", 0.0), jnp.float32)]

    def out_shapes(self, params, in_shapes):
        return [tuple(self.p["shape"])]


@register_layer("Bias")
class BiasLayer(Layer):
    """Adds a bias along an axis span (bias_layer.cpp). The bias is either a
    second bottom or a learnable param of shape = bottom.shape[axis:axis+num_axes].
    Axis semantics follow the reference's NCHW convention mapped to NHWC:
    axis counts over the canonical (N, C, H, W) ordering, so axis=1 (the
    default, per-channel) addresses our trailing channel dim."""

    def _canon_axes(self, ndim):
        # canonical (N,C,H,W) position -> NHWC position, for 4-d blobs;
        # lower-rank blobs are taken as-is (axis indexes real dims).
        p = self.p
        axis = p.get("axis", 1)
        num_axes = p.get("num_axes", 1)
        if ndim == 4:
            order = [0, 3, 1, 2]  # canonical i lives at NHWC dim order[i]
            return sorted(order[axis + k] for k in range(num_axes))
        return list(range(axis, axis + num_axes))

    def init_params(self, rng, in_shapes):
        if len(in_shapes) > 1:
            return {}
        dims = self._canon_axes(len(in_shapes[0]))
        shape = tuple(in_shapes[0][d] for d in dims)
        return {"b": fill(rng, shape,
                          self.p.get("filler", {"type": "constant"}))}

    def apply(self, params, inputs, *, train, rng):
        x = inputs[0]
        b = inputs[1] if len(inputs) > 1 else params["b"]
        dims = self._canon_axes(x.ndim)
        shape = [1] * x.ndim
        for d, s in zip(dims, b.shape):
            shape[d] = s
        return [x + b.reshape(shape)]

    def out_shapes(self, params, in_shapes):
        return [in_shapes[0]]


@register_layer("LSTMUnit")
class LSTMUnitLayer(Layer):
    """Single-timestep LSTM cell (lstm_unit_layer.cpp): bottoms are
    c_prev [N,H], gate pre-activations X [N,4H] (order i,f,o,g), and the
    sequence-continuation flag cont [N]; tops are (c, h)."""

    def apply(self, params, inputs, *, train, rng):
        c_prev, gates, cont = inputs
        mask = cont.reshape(-1, 1).astype(gates.dtype)
        c_prev = c_prev * mask
        i, f, o, g = jnp.split(gates, 4, axis=-1)
        i = jax.nn.sigmoid(i)
        f = jax.nn.sigmoid(f)
        o = jax.nn.sigmoid(o)
        g = jnp.tanh(g)
        c = f * c_prev + i * g
        h = o * jnp.tanh(c)
        return [c, h]

    def out_shapes(self, params, in_shapes):
        n, four_h = in_shapes[1]
        return [(n, four_h // 4), (n, four_h // 4)]


@register_layer("Embed")
class EmbedLayer(Layer):
    def init_params(self, rng, in_shapes):
        return {"w": fill(rng, (self.p["input_dim"], self.p["num_output"]),
                          self.p.get("weight_filler", {"type": "xavier"}),
                          fan_in=self.p["input_dim"])}

    def apply(self, params, inputs, *, train, rng):
        return [jnp.take(params["w"], inputs[0].astype(jnp.int32), axis=0)]


@register_layer("Python")
class PythonLayer(Layer):
    """User-defined layer resolved at Net build time — the analogue of the
    reference's boost::python PythonLayer (`include/caffe/layers/
    python_layer.hpp`, prototxt `python_param {module, layer, param_str}`).

    The target class (``<module>.<layer>``) must subclass
    ``caffe_escoin_tpu.nn.Layer`` — in this framework every layer already
    IS Python, so the "Python layer" contract is simply the ordinary Layer
    contract, with the class located by name instead of by registry. The
    instance replaces PythonLayer entirely (``__new__`` returns it), so
    init/apply/align/state all run on the user's class. ``param_str`` (an
    arbitrary user string, JSON by convention) reaches the class as
    ``spec.params["param_str"]``: the prototxt parser (tools/prototxt.py)
    puts it there during ingestion; programmatically-built LayerSpecs set
    ``params={"module": ..., "layer": ..., "param_str": ...}`` directly.

    Note the jit contract still applies: ``apply`` must be traceable
    (no data-dependent Python control flow)."""

    def __new__(cls, spec, policy):
        import importlib

        module = spec.params.get("module")
        lname = spec.params.get("layer")
        if not module or not lname:
            raise ValueError(
                f"Python layer {spec.name!r} needs python_param "
                f"module/layer (got module={module!r}, layer={lname!r})")
        target = getattr(importlib.import_module(module), lname)
        if not (isinstance(target, type) and issubclass(target, Layer)):
            raise TypeError(
                f"{module}.{lname} must subclass caffe_escoin_tpu.nn.Layer")
        return target(spec, policy)

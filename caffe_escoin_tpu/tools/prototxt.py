"""NetParameter / SolverParameter prototxt ingestion.

The reference's entire config language is protobuf TEXT format
(`src/caffe/proto/caffe.proto`; loaded by
`ReadNetParamsFromTextFileOrDie` + the legacy migrations of
`src/caffe/util/upgrade_proto.cpp`). This module parses that text format
with a hand-rolled tokenizer (no protobuf runtime, same policy as
tools/caffemodel.py) and converts it into this framework's LayerSpecs /
SolverConfig — so a reference user can load the exact prototxts shipped in
`/root/reference/models/` (ResNet-50 `test_sconv.prototxt`, the
AlexNet/GoogLeNet deploys, the VGG train_vals, ...).

Layout and convention conversions applied:

* NCHW shape declarations -> NHWC (input dims, Reshape shapes).
* channel-axis params (Concat/Softmax/Slice axis 1) -> -1 (trailing
  channel).
* in-place tops (Caffe's `bottom: "conv1" top: "conv1"` chains) are
  SSA-renamed — this framework's Net is functional and the fusion pass
  (nn/fuse.py) needs unique blob names for its producer/consumer analysis.
* `type: "EscConvolution"` (the reference's pinned-algo dense baseline,
  `esc_conv_layer.cu:27`) maps to the registered EscConvolutionLayer,
  which pins LOWERED_GEMM here — the same per-layer swap semantics as
  `models/resnet/test_sconv.prototxt:53`.
* Data/ImageData/WindowData layers (LMDB-backed, unavailable offline) are
  synthesized into Input declarations from batch_size + crop_size
  (``synthesize_data=True``); pass False to keep them as framework data
  layers.
* V1 `layers {}` blocks with enum types (upgrade_proto.cpp's
  UpgradeV1Net) are accepted via the enum-name table.

`param { lr_mult decay_mult name }` entries are preserved on
``spec.params["param_specs"]`` (consumed by the solver's per-param
multipliers) and same-name param sharing maps to LayerSpec.share_params.

EMISSION (net_to_prototxt / solver_to_prototxt) is the inverse — the
counterpart of the reference's Python->prototxt path
(`python/caffe/net_spec.py:1-230`, its NetSpec DSL's to_proto): LayerSpecs
-> NetParameter text, NHWC shape declarations written back as NCHW, so
fused/surgered nets can be exported, diffed against their originals, and
reloaded (`load_net(emit(specs)) == specs`). Params the caffe.proto schema
cannot express (fuse_relu/fuse_add epilogues, python extras) are carried
in a ``cescoin_param { json: "..." }`` extension field the parser reads
back; ``compat="caffe"`` drops them for strict reference-consumable
output. The emitter self-checks: each layer's standard fields are
reparsed internally and any param the reparse does not reproduce is moved
to the extension field, so round-tripping is exact by construction.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

from caffe_escoin_tpu.nn.net import LayerSpec

# ------------------------------------------------------------------
# protobuf text-format parser
# ------------------------------------------------------------------

_TOKEN = re.compile(r"""
    \s+ | \#[^\n]* |                      # whitespace / comments
    (?P<str>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*') |
    (?P<num>[-+]?(?:\.\d+|\d+\.?\d*)(?:[eE][-+]?\d+)?) |
    (?P<ident>[A-Za-z_][A-Za-z0-9_]*) |
    (?P<punct>[{}:;,])
""", re.VERBOSE)


def _tokenize(text: str):
    pos = 0
    n = len(text)
    while pos < n:
        m = _TOKEN.match(text, pos)
        if m is None:
            raise ValueError(f"prototxt: bad token at {text[pos:pos+30]!r}")
        pos = m.end()
        for kind in ("str", "num", "ident", "punct"):
            v = m.group(kind)
            if v is not None:
                yield kind, v
                break


class _Parser:
    def __init__(self, text: str):
        self.toks = list(_tokenize(text))
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def message(self, *, top=False) -> Dict[str, List[Any]]:
        """Parse fields until '}' (or EOF at top level). Repeated fields
        accumulate in lists."""
        out: Dict[str, List[Any]] = {}
        while True:
            kind, v = self.peek()
            if kind is None:
                if not top:
                    raise ValueError("prototxt: unexpected EOF")
                return out
            if kind == "punct" and v == "}":
                self.next()
                return out
            if kind != "ident":
                raise ValueError(f"prototxt: expected field name, got {v!r}")
            self.next()
            key = v
            kind, v = self.peek()
            if kind == "punct" and v == ":":
                self.next()
                kind, v = self.peek()
                if kind == "punct" and v == "{":  # `key: { ... }`
                    self.next()
                    val = self.message()
                else:
                    val = self._scalar()
            elif kind == "punct" and v == "{":
                self.next()
                val = self.message()
            else:
                raise ValueError(f"prototxt: expected ':' or '{{' after "
                                 f"{key!r}, got {v!r}")
            out.setdefault(key, []).append(val)
            kind, v = self.peek()
            if kind == "punct" and v in (";", ","):
                self.next()

    def _scalar(self):
        kind, v = self.next()
        if kind == "str":
            body = v[1:-1]
            return body.encode().decode("unicode_escape")
        if kind == "num":
            f = float(v)
            if f.is_integer() and ("." not in v and "e" not in v.lower()):
                return int(v)
            return f
        if kind == "ident":
            if v == "true":
                return True
            if v == "false":
                return False
            return v  # enum identifier
        raise ValueError(f"prototxt: bad scalar {v!r}")


def parse_text(text: str) -> Dict[str, List[Any]]:
    """Generic protobuf text-format -> nested dict of repeated fields."""
    return _Parser(text).message(top=True)


# ------------------------------------------------------------------
# NetParameter -> LayerSpec conversion
# ------------------------------------------------------------------

def _to_jsonable(v):
    """Params -> JSON with tuples preserved (JSON lists decode back to
    tuples ambiguously; spec params use tuples for shapes/points)."""
    if isinstance(v, tuple):
        return {"__tuple__": [_to_jsonable(x) for x in v]}
    if isinstance(v, list):
        return [_to_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: _to_jsonable(x) for k, x in v.items()}
    return v


def _from_jsonable(v):
    if isinstance(v, dict):
        if set(v) == {"__tuple__"}:
            return tuple(_from_jsonable(x) for x in v["__tuple__"])
        return {k: _from_jsonable(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_from_jsonable(x) for x in v]
    return v


def _one(msg, key, default=None):
    v = msg.get(key)
    return v[0] if v else default


def _spatial(msg, key, h_key, w_key, default):
    """Caffe repeated spatial field (+_h/_w variants) -> int or (h, w)."""
    if h_key in msg or w_key in msg:
        return (_one(msg, h_key, default), _one(msg, w_key, default))
    vals = msg.get(key)
    if not vals:
        return default
    if len(vals) == 1:
        return vals[0]
    return tuple(vals)


def _filler(msg, key):
    f = _one(msg, key)
    if f is None:
        return None
    out = {"type": _one(f, "type", "constant")}
    for k in ("value", "std", "mean", "min", "max"):
        if k in f:
            out[k] = _one(f, k)
    return out


def _phase_of(msg) -> Optional[str]:
    for inc in msg.get("include", []):
        ph = _one(inc, "phase")
        if ph:
            return str(ph).lower()
    for exc in msg.get("exclude", []):
        ph = _one(exc, "phase")
        if ph:
            return "test" if str(ph).lower() == "train" else "train"
    return None


# V1LayerParameter.LayerType enum NAMES (text format spells enums by name;
# numeric table lives in tools/caffemodel.py for the wire format)
V1_TYPE_NAMES = {
    "ACCURACY": "Accuracy", "BNLL": "BNLL", "CONCAT": "Concat",
    "CONVOLUTION": "Convolution", "DATA": "Data", "DROPOUT": "Dropout",
    "EUCLIDEAN_LOSS": "EuclideanLoss", "FLATTEN": "Flatten",
    "HDF5_DATA": "HDF5Data", "HDF5_OUTPUT": "HDF5Output",
    "IM2COL": "Im2col", "IMAGE_DATA": "ImageData",
    "INFOGAIN_LOSS": "InfogainLoss", "INNER_PRODUCT": "InnerProduct",
    "LRN": "LRN", "MULTINOMIAL_LOGISTIC_LOSS": "MultinomialLogisticLoss",
    "POOLING": "Pooling", "RELU": "ReLU", "SIGMOID": "Sigmoid",
    "SOFTMAX": "Softmax", "SOFTMAX_LOSS": "SoftmaxWithLoss",
    "SPLIT": "Split", "TANH": "TanH", "WINDOW_DATA": "WindowData",
    "ELTWISE": "Eltwise", "POWER": "Power",
    "SIGMOID_CROSS_ENTROPY_LOSS": "SigmoidCrossEntropyLoss",
    "HINGE_LOSS": "HingeLoss", "MEMORY_DATA": "MemoryData",
    "ARGMAX": "ArgMax", "THRESHOLD": "Threshold",
    "DUMMY_DATA": "DummyData", "SLICE": "Slice", "MVN": "MVN",
    "ABSVAL": "AbsVal", "SILENCE": "Silence",
    "CONTRASTIVE_LOSS": "ContrastiveLoss", "EXP": "Exp",
    "DECONVOLUTION": "Deconvolution",
}

_DATA_TYPES = ("Data", "ImageData", "WindowData")

# V0LayerParameter type STRINGS -> modern names (upgrade_proto.cpp
# UpgradeV0LayerType, `src/caffe/util/upgrade_proto.cpp:550-620`)
V0_TYPE_NAMES = {
    "accuracy": "Accuracy", "bnll": "BNLL", "concat": "Concat",
    "conv": "Convolution", "data": "Data", "dropout": "Dropout",
    "euclidean_loss": "EuclideanLoss", "flatten": "Flatten",
    "hdf5_data": "HDF5Data", "hdf5_output": "HDF5Output",
    "im2col": "Im2col", "images": "ImageData",
    "infogain_loss": "InfogainLoss", "innerproduct": "InnerProduct",
    "lrn": "LRN", "multinomial_logistic_loss": "MultinomialLogisticLoss",
    "pool": "Pooling", "relu": "ReLU", "sigmoid": "Sigmoid",
    "softmax": "Softmax", "softmax_loss": "SoftmaxWithLoss",
    "split": "Split", "tanh": "TanH", "window_data": "WindowData",
}


def _upgrade_v0_layer(conn) -> Tuple[str, Dict[str, List[Any]]]:
    """V0 `layers { layer { ... } bottom top }` connection -> (modern type,
    V1-shaped message). The field migrations of UpgradeV0LayerParameter
    (`src/caffe/util/upgrade_proto.cpp:199-540`): layer-level pad/
    kernelsize/stride/num_output/biasterm/group route into the type's
    param submessage; data-layer batchsize/cropsize/mirror route into
    data_param/transform_param; blobs_lr/weight_decay stay layer-level
    (picked up as param_specs downstream)."""
    v0 = _one(conn, "layer", {})
    t = str(_one(v0, "type", "?"))
    modern = V0_TYPE_NAMES.get(t, t)
    msg: Dict[str, List[Any]] = {k: list(v) for k, v in conn.items()
                                 if k != "layer"}
    if "name" in v0:
        msg["name"] = [str(_one(v0, "name"))]
    for k in ("blobs_lr", "weight_decay"):
        if k in v0:
            msg[k] = list(v0[k])

    def sub(pname):
        return msg.setdefault(pname, [{}])[0]

    def move(dst_msg, pairs):
        for src, dst in pairs:
            if src in v0:
                dst_msg[dst] = list(v0[src])

    if t == "conv":
        move(sub("convolution_param"),
             [("num_output", "num_output"), ("biasterm", "bias_term"),
              ("pad", "pad"), ("kernelsize", "kernel_size"),
              ("group", "group"), ("stride", "stride"),
              ("weight_filler", "weight_filler"),
              ("bias_filler", "bias_filler")])
    elif t == "innerproduct":
        move(sub("inner_product_param"),
             [("num_output", "num_output"), ("biasterm", "bias_term"),
              ("weight_filler", "weight_filler"),
              ("bias_filler", "bias_filler")])
    elif t == "pool":
        move(sub("pooling_param"),
             [("pad", "pad"), ("kernelsize", "kernel_size"),
              ("stride", "stride"), ("pool", "pool")])
    elif t == "dropout":
        move(sub("dropout_param"), [("dropout_ratio", "dropout_ratio")])
    elif t == "lrn":
        move(sub("lrn_param"), [("local_size", "local_size"),
                                ("alpha", "alpha"), ("beta", "beta"),
                                ("k", "k")])
    elif t == "padding":
        if "pad" in v0:
            msg["pad"] = list(v0["pad"])
    elif t in ("data", "images", "window_data", "hdf5_data"):
        pname = {"data": "data_param", "images": "image_data_param",
                 "window_data": "window_data_param",
                 "hdf5_data": "hdf5_data_param"}[t]
        move(sub(pname), [("source", "source"),
                          ("batchsize", "batch_size")])
        move(sub("transform_param"), [("cropsize", "crop_size"),
                                      ("mirror", "mirror"),
                                      ("scale", "scale"),
                                      ("meanfile", "mean_file")])
    return modern, msg


def _channel_axis(ax: int, default_ok=True) -> int:
    """Caffe canonical (N,C,...) axis -> this framework's trailing channel."""
    if ax == 1:
        return -1
    if ax == 0:
        return 0
    raise ValueError(f"prototxt: cannot map Caffe axis {ax} to NHWC")


def _layer_params(type_: str, msg) -> Dict[str, Any]:
    p: Dict[str, Any] = {}
    if type_ in ("Convolution", "ConvolutionReLU", "EscConvolution",
                 "Deconvolution"):
        cp = _one(msg, "convolution_param", {})
        p["num_output"] = _one(cp, "num_output")
        p["kernel"] = _spatial(cp, "kernel_size", "kernel_h", "kernel_w", 3)
        p["stride"] = _spatial(cp, "stride", "stride_h", "stride_w", 1)
        p["pad"] = _spatial(cp, "pad", "pad_h", "pad_w", 0)
        dil = _spatial(cp, "dilation", None, None, 1)
        if dil != 1:
            p["dilation"] = dil
        g = _one(cp, "group", 1)
        if g != 1:
            p["group"] = g
        p["bias_term"] = _one(cp, "bias_term", True)
        for fk, pk in (("weight_filler", "weight_filler"),
                       ("bias_filler", "bias_filler")):
            f = _filler(cp, fk)
            if f:
                p[pk] = f
    elif type_ == "InnerProduct":
        ip = _one(msg, "inner_product_param", {})
        p["num_output"] = _one(ip, "num_output")
        p["bias_term"] = _one(ip, "bias_term", True)
        f = _filler(ip, "weight_filler")
        if f:
            p["weight_filler"] = f
        f = _filler(ip, "bias_filler")
        if f:
            p["bias_filler"] = f
    elif type_ == "Pooling":
        pp = _one(msg, "pooling_param", {})
        pool = str(_one(pp, "pool", "MAX")).upper()
        p["mode"] = {"MAX": "max", "AVE": "avg",
                     "STOCHASTIC": "stochastic"}[pool]
        if _one(pp, "global_pooling", False):
            p["global_pooling"] = True
        else:
            p["kernel"] = _spatial(pp, "kernel_size", "kernel_h",
                                   "kernel_w", 2)
            p["stride"] = _spatial(pp, "stride", "stride_h", "stride_w", 1)
            pad = _spatial(pp, "pad", "pad_h", "pad_w", 0)
            if pad != 0:
                p["pad"] = pad
    elif type_ == "ReLU":
        rp = _one(msg, "relu_param", {})
        ns = _one(rp, "negative_slope", 0.0)
        if ns:
            p["negative_slope"] = ns
    elif type_ == "LRN":
        lp = _one(msg, "lrn_param", {})
        p["local_size"] = _one(lp, "local_size", 5)
        p["alpha"] = _one(lp, "alpha", 1e-4)
        p["beta"] = _one(lp, "beta", 0.75)
        if "k" in lp:
            p["k"] = _one(lp, "k")
    elif type_ == "Dropout":
        dp = _one(msg, "dropout_param", {})
        p["ratio"] = _one(dp, "dropout_ratio", 0.5)
    elif type_ == "Softmax":
        sp = _one(msg, "softmax_param", {})
        p["axis"] = _channel_axis(_one(sp, "axis", 1))
    elif type_ == "Accuracy":
        ap = _one(msg, "accuracy_param", {})
        tk = _one(ap, "top_k", 1)
        if tk != 1:
            p["top_k"] = tk
    elif type_ == "Concat":
        cp = _one(msg, "concat_param", {})
        ax = _one(cp, "axis", _one(cp, "concat_dim", 1))
        p["axis"] = _channel_axis(ax)
    elif type_ == "Slice":
        sp = _one(msg, "slice_param", {})
        p["axis"] = _channel_axis(_one(sp, "axis", 1))
        p["slice_points"] = tuple(sp.get("slice_point", []))
    elif type_ == "Eltwise":
        ep = _one(msg, "eltwise_param", {})
        p["operation"] = str(_one(ep, "operation", "SUM")).lower()
        if "coeff" in ep:
            p["coeffs"] = tuple(ep["coeff"])
    elif type_ == "BatchNorm":
        bp = _one(msg, "batch_norm_param", {})
        if "use_global_stats" in bp:
            p["use_global_stats"] = _one(bp, "use_global_stats")
        if "eps" in bp:
            p["eps"] = _one(bp, "eps")
        if "moving_average_fraction" in bp:
            p["moving_average_fraction"] = _one(bp,
                                                "moving_average_fraction")
    elif type_ == "Scale":
        sp = _one(msg, "scale_param", {})
        # ScaleParameter.bias_term defaults to FALSE in caffe.proto (the
        # framework ScaleLayer defaults True) — always set explicitly
        p["bias_term"] = _one(sp, "bias_term", False)
    elif type_ == "Power":
        pp = _one(msg, "power_param", {})
        p["power"] = _one(pp, "power", 1.0)
        p["scale"] = _one(pp, "scale", 1.0)
        p["shift"] = _one(pp, "shift", 0.0)
    elif type_ == "Flatten":
        fp = _one(msg, "flatten_param", {})
        p["axis"] = _one(fp, "axis", 1)
    elif type_ == "Python":
        # PythonParameter (`caffe.proto` python_param): the user's layer
        # class, resolved at Net build time by nn.layers.PythonLayer
        pp = _one(msg, "python_param", {})
        p["module"] = str(_one(pp, "module", ""))
        p["layer"] = str(_one(pp, "layer", ""))
        ps = _one(pp, "param_str", "")
        if ps:
            p["param_str"] = str(ps)
    elif type_ == "Reshape":
        rp = _one(msg, "reshape_param", {})
        shape = _one(rp, "shape", {})
        dims = list(shape.get("dim", []))
        if len(dims) == 4:  # NCHW -> NHWC
            dims = [dims[0], dims[2], dims[3], dims[1]]
        p["shape"] = tuple(dims)
    return p


def net_from_prototxt(
    text: str,
    *,
    phase: str = "test",
    batch: Optional[int] = None,
    synthesize_data: bool = True,
    default_image_channels: int = 3,
) -> Tuple[List[LayerSpec], Dict[str, Tuple[int, ...]], str]:
    """Parse a NetParameter prototxt.

    Returns (specs, input_shapes, net_name): the LayerSpecs for the
    requested phase (de-aliased, NHWC), the declared/synthesized input
    blob shapes, and the net's name. ``batch`` overrides the declared
    batch size.
    """
    net = parse_text(text)
    name = _one(net, "name", "net")
    input_shapes: Dict[str, Tuple[int, ...]] = {}

    def nchw_to_nhwc(dims):
        dims = [int(d) for d in dims]
        if len(dims) == 4:
            dims = [dims[0], dims[2], dims[3], dims[1]]
        if batch is not None and dims:
            dims[0] = batch
        return tuple(dims)

    # top-level legacy input declarations (deploy.prototxt V1 style)
    tl_inputs = [str(v) for v in net.get("input", [])]
    if tl_inputs:
        if "input_shape" in net:
            for blob, shp in zip(tl_inputs, net["input_shape"]):
                input_shapes[blob] = nchw_to_nhwc(shp.get("dim", []))
        elif "input_dim" in net:
            dims = net["input_dim"]
            for i, blob in enumerate(tl_inputs):
                input_shapes[blob] = nchw_to_nhwc(dims[i * 4:(i + 1) * 4])

    raw_layers = []
    for msg in net.get("layer", []):
        raw_layers.append((str(_one(msg, "type", "?")), msg))
    for msg in net.get("layers", []):  # V1 / V0 (upgrade_proto.cpp role)
        if "layer" in msg:  # V0 connection: `layers { layer { ... } }`
            raw_layers.append(_upgrade_v0_layer(msg))
            continue
        t = _one(msg, "type", "?")
        raw_layers.append((V1_TYPE_NAMES.get(str(t), str(t)), msg))

    # V0 "padding" layers: fold the pad into the consuming conv and drop
    # the layer (upgrade_proto.cpp:168-190 does exactly this)
    pad_of: Dict[str, Tuple[Any, str]] = {}  # padded blob -> (pad, source)
    if any(t == "padding" for t, _ in raw_layers):
        folded = []
        for t, m in raw_layers:
            if t == "padding":
                pad = _one(m, "pad", 0)
                top = str(_one(m, "top", _one(m, "name", "")))
                bot = str(_one(m, "bottom", top))
                pad_of[top] = (pad, bot)
                continue
            if pad_of and any(str(b) in pad_of for b in m.get("bottom", [])):
                m = dict(m)
                newb = []
                for b in m.get("bottom", []):
                    if str(b) in pad_of:
                        pad, src = pad_of[str(b)]
                        cp = dict((m.get("convolution_param") or [{}])[0])
                        cp["pad"] = [pad]
                        m["convolution_param"] = [cp]
                        newb.append(src)
                    else:
                        newb.append(b)
                m["bottom"] = newb
            folded.append((t, m))
        raw_layers = folded

    # phase filter first (TRAIN/TEST twins share blob names)
    kept = [(t, m) for t, m in raw_layers
            if _phase_of(m) in (None, phase)]

    specs: List[LayerSpec] = []
    alias: Dict[str, str] = {}  # blob name -> current SSA name
    param_owner: Dict[str, str] = {}  # shared param name -> owner layer
    for type_, msg in kept:
        lname = str(_one(msg, "name", f"layer{len(specs)}"))
        bottoms = [alias.get(str(b), str(b)) for b in msg.get("bottom", [])]
        tops_raw = [str(t) for t in msg.get("top", [])] or [lname]

        if type_ == "Input":
            ip = _one(msg, "input_param", {})
            for blob, shp in zip(tops_raw, ip.get("shape", [])):
                input_shapes[blob] = nchw_to_nhwc(shp.get("dim", []))
            for t in tops_raw:
                alias[t] = t
            continue
        if synthesize_data and type_ in _DATA_TYPES:
            dp = (_one(msg, "data_param", {}) or
                  _one(msg, "image_data_param", {}))
            tp = _one(msg, "transform_param", {})
            bsz = batch or _one(dp, "batch_size", 1)
            crop = _one(tp, "crop_size", 224)
            shapes = [(bsz, crop, crop, default_image_channels), (bsz,)]
            for blob, shp in zip(tops_raw, shapes):
                input_shapes[blob] = shp
                alias[blob] = blob
            continue

        tops = []
        for t in tops_raw:
            if t in alias or t in bottoms:  # in-place / rewrite: SSA-rename
                new = f"{t}__{lname}"
                alias[t] = new
                tops.append(new)
            else:
                alias[t] = t
                tops.append(t)

        p = _layer_params(type_, msg)
        # ParamSpec entries: lr_mult/decay_mult multipliers + name sharing
        share = None
        pspecs = []
        for pr in msg.get("param", []):
            if isinstance(pr, str):  # V1 `param: "name"` sharing
                pr = {"name": [pr]}
            entry = {}
            for k in ("lr_mult", "decay_mult", "name"):
                if k in pr:
                    entry[k] = _one(pr, k)
            pspecs.append(entry)
            pn = entry.get("name")
            if pn:
                if pn in param_owner:
                    share = param_owner[pn]
                else:
                    param_owner[pn] = lname
        if not pspecs and ("blobs_lr" in msg or "weight_decay" in msg):
            # V0/V1 layer-level per-blob multipliers -> ParamSpec entries
            # (upgrade_proto.cpp:735-744 UpgradeV1LayerParameter)
            lrs = msg.get("blobs_lr", [])
            wds = msg.get("weight_decay", [])
            for i in range(max(len(lrs), len(wds))):
                entry = {}
                if i < len(lrs):
                    entry["lr_mult"] = lrs[i]
                if i < len(wds):
                    entry["decay_mult"] = wds[i]
                pspecs.append(entry)
        if pspecs:
            p["param_specs"] = pspecs
        # framework extension fields (written by net_to_prototxt in
        # cescoin-compat mode; absent from reference-authored files):
        # cescoin_param.json carries params caffe.proto cannot express,
        # share_params carries weight sharing declared without named
        # ParamSpecs
        ext = _one(msg, "cescoin_param")
        if ext is not None and "json" in ext:
            import json as _json

            extra = _json.loads(str(_one(ext, "json")))
            for k, v in extra.items():
                p[k] = _from_jsonable(v)
        if "share_params" in msg:
            share = str(_one(msg, "share_params"))

        specs.append(LayerSpec(
            lname, type_, tuple(bottoms), tops=tuple(tops), params=p,
            phase=_phase_of(msg),
            loss_weight=float(_one(msg, "loss_weight", 0.0)),
            share_params=share,
        ))
    return specs, input_shapes, name


def load_net(path: str, **kw):
    with open(path) as fh:
        return net_from_prototxt(fh.read(), **kw)


# ------------------------------------------------------------------
# LayerSpec -> NetParameter emission (inverse of net_from_prototxt;
# the `python/caffe/net_spec.py` to_proto counterpart)
# ------------------------------------------------------------------

def _fmt_scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        body = (v.encode("unicode_escape").decode("ascii")
                .replace('"', '\\"'))
        return f'"{body}"'
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return repr(v)
    if hasattr(v, "item"):  # numpy scalar
        return _fmt_scalar(v.item())
    raise TypeError(f"prototxt: cannot emit scalar {v!r}")


def _emit_spatial(fields: List[Tuple[str, Any]], key: str,
                  h_key: Optional[str], w_key: Optional[str], val) -> None:
    """Inverse of _spatial: int -> `key: v`; 2-tuple -> `_h`/`_w` fields
    (when the schema has them) else repeated; longer tuples repeated."""
    if isinstance(val, (tuple, list)):
        if len(val) == 2 and h_key:
            fields.append((h_key, val[0]))
            fields.append((w_key, val[1]))
        else:
            for v in val:
                fields.append((key, v))
    else:
        fields.append((key, val))


def _emit_filler(sub: List[str], name: str, f: Optional[Dict]) -> None:
    if not f:
        return
    items = [f'type: {_fmt_scalar(f.get("type", "constant"))}']
    for k in ("value", "std", "mean", "min", "max"):
        if k in f:
            items.append(f"{k}: {_fmt_scalar(f[k])}")
    sub.append(f'{name} {{ {" ".join(items)} }}')


def _axis_to_caffe(ax: int) -> int:
    """Inverse of _channel_axis: trailing channel -> Caffe's axis 1."""
    return 1 if ax == -1 else ax


def _param_fields(type_: str, p: Dict[str, Any]) -> List[str]:
    """Type-specific *_param submessage lines for the caffe.proto schema
    (inverse of _layer_params). Keys without a schema mapping are handled
    by the caller's self-check + cescoin_param extension."""
    sub: List[str] = []
    fields: List[Tuple[str, Any]] = []
    if type_ in ("Convolution", "ConvolutionReLU", "EscConvolution",
                 "Deconvolution"):
        if "num_output" in p:
            fields.append(("num_output", p["num_output"]))
        if "kernel" in p:
            _emit_spatial(fields, "kernel_size", "kernel_h", "kernel_w",
                          p["kernel"])
        if "stride" in p:
            _emit_spatial(fields, "stride", "stride_h", "stride_w",
                          p["stride"])
        if "pad" in p:
            _emit_spatial(fields, "pad", "pad_h", "pad_w", p["pad"])
        if "dilation" in p:
            _emit_spatial(fields, "dilation", None, None, p["dilation"])
        if "group" in p:
            fields.append(("group", p["group"]))
        if "bias_term" in p:
            fields.append(("bias_term", p["bias_term"]))
        _emit_filler(sub, "weight_filler", p.get("weight_filler"))
        _emit_filler(sub, "bias_filler", p.get("bias_filler"))
        wrap = "convolution_param"
    elif type_ == "InnerProduct":
        if "num_output" in p:
            fields.append(("num_output", p["num_output"]))
        if "bias_term" in p:
            fields.append(("bias_term", p["bias_term"]))
        _emit_filler(sub, "weight_filler", p.get("weight_filler"))
        _emit_filler(sub, "bias_filler", p.get("bias_filler"))
        wrap = "inner_product_param"
    elif type_ == "Pooling":
        # when the builder spec omits mode, pin the FRAMEWORK default
        # explicitly (global pooling defaults avg here; Caffe's parser
        # default is MAX) so reparse preserves semantics
        default_mode = "avg" if p.get("global_pooling") else "max"
        mode = {"max": "MAX", "avg": "AVE",
                "stochastic": "STOCHASTIC"}[p.get("mode", default_mode)]
        fields.append(("pool", mode))
        if p.get("global_pooling"):
            fields.append(("global_pooling", True))
        else:
            if "kernel" in p:
                _emit_spatial(fields, "kernel_size", "kernel_h",
                              "kernel_w", p["kernel"])
            if "stride" in p:
                _emit_spatial(fields, "stride", "stride_h", "stride_w",
                              p["stride"])
            if "pad" in p:
                _emit_spatial(fields, "pad", "pad_h", "pad_w", p["pad"])
        wrap = "pooling_param"
    elif type_ == "ReLU":
        if p.get("negative_slope"):
            fields.append(("negative_slope", p["negative_slope"]))
        wrap = "relu_param"
    elif type_ == "LRN":
        for k in ("local_size", "alpha", "beta", "k"):
            if k in p:
                fields.append((k, p[k]))
        wrap = "lrn_param"
    elif type_ == "Dropout":
        if "ratio" in p:
            fields.append(("dropout_ratio", p["ratio"]))
        wrap = "dropout_param"
    elif type_ == "Softmax":
        if "axis" in p:
            fields.append(("axis", _axis_to_caffe(p["axis"])))
        wrap = "softmax_param"
    elif type_ == "Accuracy":
        if "top_k" in p and p["top_k"] != 1:
            fields.append(("top_k", p["top_k"]))
        wrap = "accuracy_param"
    elif type_ == "Concat":
        if "axis" in p:
            fields.append(("axis", _axis_to_caffe(p["axis"])))
        wrap = "concat_param"
    elif type_ == "Slice":
        if "axis" in p:
            fields.append(("axis", _axis_to_caffe(p["axis"])))
        for sp in p.get("slice_points", ()):
            fields.append(("slice_point", sp))
        wrap = "slice_param"
    elif type_ == "Eltwise":
        if "operation" in p:
            fields.append(("operation", str(p["operation"]).upper()))
        for c in p.get("coeffs", ()):
            fields.append(("coeff", c))
        wrap = "eltwise_param"
    elif type_ == "BatchNorm":
        for k in ("use_global_stats", "eps", "moving_average_fraction"):
            if k in p:
                fields.append((k, p[k]))
        wrap = "batch_norm_param"
    elif type_ == "Scale":
        # ScaleParameter.bias_term defaults FALSE in caffe.proto but TRUE
        # in the framework ScaleLayer — always emit explicitly so a spec
        # that omitted it keeps its framework semantics on reparse
        fields.append(("bias_term", p.get("bias_term", True)))
        wrap = "scale_param"
    elif type_ == "Power":
        for k in ("power", "scale", "shift"):
            if k in p:
                fields.append((k, p[k]))
        wrap = "power_param"
    elif type_ == "Flatten":
        if "axis" in p:
            fields.append(("axis", p["axis"]))
        wrap = "flatten_param"
    elif type_ == "Python":
        for src, dst in (("module", "module"), ("layer", "layer"),
                         ("param_str", "param_str")):
            if p.get(src):
                fields.append((dst, p[src]))
        wrap = "python_param"
    elif type_ == "Reshape":
        dims = list(p.get("shape", ()))
        if len(dims) == 4:  # NHWC -> NCHW declaration
            dims = [dims[0], dims[3], dims[1], dims[2]]
        inner = " ".join(f"dim: {_fmt_scalar(d)}" for d in dims)
        sub.append(f"shape {{ {inner} }}")
        wrap = "reshape_param"
    else:
        return []
    body = [f"{k}: {_fmt_scalar(v)}" for k, v in fields] + sub
    if not body:
        return []
    return ([f"{wrap} {{"] + [f"  {ln}" for ln in body] + ["}"])


def _reconstruct_params(type_: str, msg) -> Dict[str, Any]:
    """What net_from_prototxt would reconstruct for this layer message —
    used by the emitter's self-check (everything not reproduced goes to
    the cescoin_param extension so round-trips are exact)."""
    p = _layer_params(type_, msg)
    pspecs = []
    for pr in msg.get("param", []):
        entry = {}
        for k in ("lr_mult", "decay_mult", "name"):
            if k in pr:
                entry[k] = _one(pr, k)
        pspecs.append(entry)
    if pspecs:
        p["param_specs"] = pspecs
    return p


def layer_to_prototxt(spec: LayerSpec, *, compat: str = "cescoin") -> str:
    """One LayerSpec -> a `layer { ... }` text block."""
    import json as _json

    lines = [f"layer {{", f"  name: {_fmt_scalar(spec.name)}",
             f"  type: {_fmt_scalar(spec.type)}"]
    for b in spec.bottoms:
        lines.append(f"  bottom: {_fmt_scalar(b)}")
    for t in spec.tops:
        lines.append(f"  top: {_fmt_scalar(t)}")
    if spec.phase:
        lines.append(f"  include {{ phase: {spec.phase.upper()} }}")
    if spec.loss_weight:
        lines.append(f"  loss_weight: {_fmt_scalar(spec.loss_weight)}")
    for entry in spec.params.get("param_specs", []):
        items = [f"{k}: {_fmt_scalar(entry[k])}"
                 for k in ("name", "lr_mult", "decay_mult") if k in entry]
        lines.append(f'  param {{ {" ".join(items)} }}')
    for ln in _param_fields(spec.type, spec.params):
        lines.append(f"  {ln}")
    if spec.share_params and compat == "cescoin":
        lines.append(f"  share_params: {_fmt_scalar(spec.share_params)}")

    if compat == "cescoin":
        # self-check: reparse the standard fields; any param they do not
        # reproduce exactly rides the extension field
        probe = parse_text("\n".join(lines[1:]))
        rec = _reconstruct_params(spec.type, probe)
        leftover = {k: v for k, v in spec.params.items()
                    if k not in rec or rec[k] != v}
        if leftover:
            blob = _json.dumps(_to_jsonable(leftover), sort_keys=True)
            lines.append(
                f"  cescoin_param {{ json: {_fmt_scalar(blob)} }}")
    lines.append("}")
    return "\n".join(lines)


def net_to_prototxt(specs: List[LayerSpec],
                    input_shapes: Optional[Dict[str, Tuple[int, ...]]] = None,
                    *, name: str = "net",
                    compat: str = "cescoin") -> str:
    """LayerSpecs (+ NHWC input shapes) -> NetParameter prototxt text.

    ``compat="cescoin"`` (default) guarantees
    ``net_from_prototxt(net_to_prototxt(specs)) == specs`` *up to
    default-field normalization* via the extension field: the self-check
    moves any spec param the schema reparse does not reproduce into
    ``cescoin_param``, but the reparse may ADD keys a builder-authored
    spec omitted (conv kernel/stride/pad/bias_term defaults, Pooling
    mode, Scale bias_term) — those come back with their schema-default
    values, so the round trip is exact for parser-originated specs and
    default-normalizing for hand-authored ones (exactness on
    the reference's own files is what tests/test_prototxt.py asserts).
    ``compat="caffe"`` emits only schema-expressible fields (strictly
    consumable by reference tooling — framework-only params like fused
    epilogues are dropped)."""
    if compat not in ("cescoin", "caffe"):
        raise ValueError(f"compat must be 'cescoin'|'caffe', got {compat!r}")
    out = [f"name: {_fmt_scalar(name)}"]
    for blob, shp in (input_shapes or {}).items():
        dims = [int(d) for d in shp]
        if len(dims) == 4:  # NHWC -> NCHW declaration
            dims = [dims[0], dims[3], dims[1], dims[2]]
        inner = " ".join(f"dim: {d}" for d in dims)
        out.append(f"layer {{\n  name: {_fmt_scalar(blob)}\n"
                   f'  type: "Input"\n  top: {_fmt_scalar(blob)}\n'
                   f"  input_param {{ shape {{ {inner} }} }}\n}}")
    for spec in specs:
        out.append(layer_to_prototxt(spec, compat=compat))
    return "\n".join(out) + "\n"


def save_net(path: str, specs, input_shapes=None, **kw) -> None:
    with open(path, "w") as fh:
        fh.write(net_to_prototxt(specs, input_shapes, **kw))


# ------------------------------------------------------------------
# SolverParameter -> SolverConfig (+ run settings)
# ------------------------------------------------------------------

# SolverParameter.SolverType enum / `type` string -> framework solver_type
_SOLVER_TYPES = {
    "SGD": "sgd", "NESTEROV": "nesterov", "ADAGRAD": "adagrad",
    "RMSPROP": "rmsprop", "ADADELTA": "adadelta", "ADAM": "adam",
}


def solver_from_prototxt(text: str):
    """Parse a solver prototxt -> (SolverConfig, run dict).

    The run dict carries the fields outside SolverConfig's scope:
    net path, test_iter/test_interval, display, snapshot prefix/cadence
    (consumed by engine.solver.Solver / tools.cli train)."""
    from caffe_escoin_tpu.engine.solvers import SolverConfig

    msg = parse_text(text)
    t = str(_one(msg, "type", _one(msg, "solver_type", "SGD")))
    cfg = SolverConfig(
        solver_type=_SOLVER_TYPES.get(t.upper(), t.lower()),
        base_lr=_one(msg, "base_lr", 0.01),
        momentum=_one(msg, "momentum", 0.9),
        weight_decay=_one(msg, "weight_decay", 0.0),
        regularization_type=str(_one(msg, "regularization_type", "L2")),
        delta=_one(msg, "delta", 1e-8),
        rms_decay=_one(msg, "rms_decay", 0.99),
        adam_beta1=_one(msg, "momentum", 0.9),
        adam_beta2=_one(msg, "momentum2", 0.999),
        clip_gradients=_one(msg, "clip_gradients", -1.0),
        iter_size=_one(msg, "iter_size", 1),
        lr_policy=str(_one(msg, "lr_policy", "fixed")),
        gamma=_one(msg, "gamma", 0.1),
        step_size=_one(msg, "stepsize", 100000),
        stepvalues=tuple(msg.get("stepvalue", [])),
        power=_one(msg, "power", 1.0),
        max_iter=_one(msg, "max_iter", 100000),
    )
    run = {
        "net": _one(msg, "net"),
        "train_net": _one(msg, "train_net"),
        "test_net": _one(msg, "test_net"),
        "test_iter": _one(msg, "test_iter", 0),
        "test_interval": _one(msg, "test_interval", 0),
        "display": _one(msg, "display", 0),
        "snapshot": _one(msg, "snapshot", 0),
        "snapshot_prefix": _one(msg, "snapshot_prefix", ""),
        "random_seed": _one(msg, "random_seed"),
    }
    return cfg, run


def load_solver(path: str):
    with open(path) as fh:
        return solver_from_prototxt(fh.read())


def solver_to_prototxt(cfg, run: Optional[Dict[str, Any]] = None) -> str:
    """SolverConfig (+ run dict) -> SolverParameter text; the inverse of
    solver_from_prototxt (round-trip exact on SolverConfig fields)."""
    inv_types = {v: k for k, v in _SOLVER_TYPES.items()}
    lines = [
        f'type: {_fmt_scalar(inv_types.get(cfg.solver_type, cfg.solver_type.upper()))}',
        f"base_lr: {_fmt_scalar(float(cfg.base_lr))}",
        f"momentum: {_fmt_scalar(float(cfg.momentum))}",
        f"momentum2: {_fmt_scalar(float(cfg.adam_beta2))}",
        f"weight_decay: {_fmt_scalar(float(cfg.weight_decay))}",
        f"regularization_type: {_fmt_scalar(cfg.regularization_type)}",
        f"delta: {_fmt_scalar(float(cfg.delta))}",
        f"rms_decay: {_fmt_scalar(float(cfg.rms_decay))}",
        f"clip_gradients: {_fmt_scalar(float(cfg.clip_gradients))}",
        f"iter_size: {_fmt_scalar(int(cfg.iter_size))}",
        f"lr_policy: {_fmt_scalar(cfg.lr_policy)}",
        f"gamma: {_fmt_scalar(float(cfg.gamma))}",
        f"stepsize: {_fmt_scalar(int(cfg.step_size))}",
        f"power: {_fmt_scalar(float(cfg.power))}",
        f"max_iter: {_fmt_scalar(int(cfg.max_iter))}",
    ]
    for sv in cfg.stepvalues:
        lines.append(f"stepvalue: {_fmt_scalar(int(sv))}")
    for k in ("net", "train_net", "test_net", "test_iter", "test_interval",
              "display", "snapshot", "snapshot_prefix", "random_seed"):
        v = (run or {}).get(k)
        if v not in (None, "", 0):
            lines.append(f"{k}: {_fmt_scalar(v)}")
    return "\n".join(lines) + "\n"

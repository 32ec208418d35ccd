"""Prototxt (NetParameter text) ingestion round-trips against the
reference's own model files.

The reference's config language is protobuf text
(`ReadNetParamsFromTextFileOrDie`; the zoo files in
`/root/reference/models/`). These tests load those exact files offline,
build Nets, run forwards, and check structural agreement with the
hand-ported model builders."""

import os

import jax
import numpy as np
import pytest

from caffe_escoin_tpu.nn import LayerSpec, Net
from caffe_escoin_tpu.tools.prototxt import (load_net, load_solver,
                                             net_from_prototxt,
                                             parse_text,
                                             solver_from_prototxt)

REF = "/root/reference/models"
pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference models not available")


def _conv_layers(net):
    return [l for l in net.layers
            if l.spec.type in ("Convolution", "EscConvolution",
                               "ConvolutionReLU")]


def _forward_shapes(path, batch=1, **kw):
    specs, shapes, name = load_net(path, batch=batch, **kw)
    net = Net(specs, phase="test")
    params = net.init(jax.random.PRNGKey(0), shapes)
    inputs = {k: np.zeros(v, np.float32) for k, v in shapes.items()}
    out = net.apply(params, inputs)
    return net, out


def test_parse_text_basics():
    msg = parse_text("""
      name: "x"  # comment
      layer { name: "a" type: "ReLU" bottom: "d" top: "a"
              relu_param { negative_slope: 0.1 } }
      input_dim: 1 input_dim: 3 input_dim: 8 input_dim: 8
      flag: true  enum_f: TRAIN  neg: -4  sci: 1e-5
    """)
    assert msg["name"] == ["x"]
    assert msg["layer"][0]["relu_param"][0]["negative_slope"] == [0.1]
    assert msg["input_dim"] == [1, 3, 8, 8]
    assert msg["flag"] == [True]
    assert msg["enum_f"] == ["TRAIN"]
    assert msg["neg"] == [-4]
    assert msg["sci"] == [1e-5]


def test_alexnet_deploy_matches_builder():
    """Reference bvlc_alexnet/deploy.prototxt vs models/alexnet.py."""
    from caffe_escoin_tpu.models import alexnet

    net, out = _forward_shapes(f"{REF}/bvlc_alexnet/deploy.prototxt")
    assert out["prob"].shape == (1, 1000)
    ours = Net(alexnet.alexnet(), phase="test")
    ours.init(jax.random.PRNGKey(0), {"data": (1, 227, 227, 3)})
    ref_convs = [(l.spec.params["num_output"], l.spec.params["kernel"],
                  l.spec.params.get("group", 1)) for l in _conv_layers(net)]
    our_convs = [(l.spec.params["num_output"], l.spec.params["kernel"],
                  l.spec.params.get("group", 1)) for l in _conv_layers(ours)]
    assert ref_convs == our_convs


def test_googlenet_deploy_matches_builder():
    from caffe_escoin_tpu.models import googlenet

    net, out = _forward_shapes(f"{REF}/bvlc_googlenet/deploy.prototxt")
    assert out["prob"].shape == (1, 1000)
    ours = Net(googlenet.googlenet(), phase="test")
    ref_convs = sorted((l.spec.params["num_output"],
                        l.spec.params["kernel"])
                       for l in _conv_layers(net))
    our_convs = sorted((l.spec.params["num_output"],
                        l.spec.params["kernel"])
                       for l in _conv_layers(ours))
    assert ref_convs == our_convs


def test_resnet50_test_sconv_matches_builder():
    """The headline workload file, with its per-layer EscConvolution swap
    (`models/resnet/test_sconv.prototxt:53`)."""
    from caffe_escoin_tpu.models import resnet

    specs, shapes, name = load_net(f"{REF}/resnet/test_sconv.prototxt",
                                   batch=1)
    net = Net(specs, phase="test")
    params = net.init(jax.random.PRNGKey(0), shapes)
    inputs = {k: np.zeros(v, np.float32) for k, v in shapes.items()}
    out = net.apply(params, inputs)
    assert set(out) >= {"top-1", "loss"}
    # the test_sconv file swaps SOME layers to EscConvolution (the dense
    # baseline pin) and leaves others Convolution — both must exist
    types = {l.spec.type for l in _conv_layers(net)}
    assert "EscConvolution" in types
    ours = Net(resnet.resnet50(), phase="test")
    ours.init(jax.random.PRNGKey(0), {"data": (1, 224, 224, 3)})
    ref_convs = sorted((l.spec.params["num_output"],
                        l.spec.params["kernel"],
                        l.spec.params.get("stride", 1))
                       for l in _conv_layers(net))
    our_convs = sorted((l.spec.params["num_output"],
                        l.spec.params["kernel"],
                        l.spec.params.get("stride", 1))
                       for l in _conv_layers(ours))
    assert ref_convs == our_convs
    # pool5 output must be 1x1x2048 in both
    assert net.blob_shapes[
        [l for l in net.layers if l.spec.type == "Pooling"][-1].spec.tops[0]
    ][-1] == 2048


def test_vgg16_train_val_matches_builder():
    from caffe_escoin_tpu.models import vgg

    specs, shapes, name = load_net(f"{REF}/vgg/train_val.prototxt", batch=1)
    net = Net(specs, phase="test")
    net.init(jax.random.PRNGKey(0), shapes)
    ours = Net(vgg.vgg16(), phase="test")
    ours.init(jax.random.PRNGKey(0), {"data": (1, 224, 224, 3)})
    ref_convs = [l.spec.params["num_output"] for l in _conv_layers(net)]
    our_convs = [l.spec.params["num_output"] for l in _conv_layers(ours)]
    assert ref_convs == our_convs
    # fc6 shape agreement (25088 -> 4096)
    ref_fc = [l for l in net.layers if l.spec.type == "InnerProduct"]
    assert [l.spec.params["num_output"] for l in ref_fc] == [4096, 4096, 1000]


def test_lenet_train_test_runs_train_phase():
    specs, shapes, name = load_net(f"{REF}/lenet5/train_test.prototxt",
                                   batch=2, default_image_channels=1)
    net = Net(specs, phase="train")
    params = net.init(jax.random.PRNGKey(0), shapes)
    inputs = {k: np.zeros(v, np.float32) for k, v in shapes.items()}
    loss = net.loss(params, inputs, rng=jax.random.PRNGKey(1))
    assert np.isfinite(float(loss))


def test_in_place_tops_ssa_renamed():
    specs, shapes, _ = load_net(f"{REF}/resnet/test_sconv.prototxt", batch=1)
    tops = [t for s in specs for t in s.tops]
    assert len(tops) == len(set(tops)), "in-place tops must be de-aliased"


def test_param_specs_and_lr_mult_parsed():
    specs, _, _ = load_net(f"{REF}/bvlc_alexnet/deploy.prototxt", batch=1)
    conv1 = next(s for s in specs if s.name == "conv1")
    ps = conv1.params["param_specs"]
    assert ps[0]["lr_mult"] == 1 and ps[0]["decay_mult"] == 1
    assert ps[1]["lr_mult"] == 2 and ps[1]["decay_mult"] == 0


def test_solver_prototxt():
    cfg, run = load_solver(f"{REF}/bvlc_alexnet/solver.prototxt")
    assert cfg.solver_type == "sgd"
    assert cfg.base_lr == 0.01
    assert cfg.lr_policy == "step"
    assert cfg.gamma == 0.1
    assert cfg.step_size == 100000
    assert cfg.momentum == 0.9
    assert cfg.weight_decay == 0.0005
    assert run["test_interval"] == 1000
    assert run["snapshot_prefix"].endswith("caffe_alexnet_train")


def test_solver_prototxt_l1_regularization():
    """The fork's one proto addition: ParamSpec/solver regularization_type
    (caffe.proto:307-308; vgg_16_l1l2_solver uses it)."""
    cfg, _ = load_solver(f"{REF}/vgg/vgg_16_l1l2_solver.prototxt")
    assert cfg.base_lr > 0


def test_fused_prototxt_resnet_sparse_exec():
    """Full switching path: reference prototxt -> fuse -> prune -> align ->
    sparse forward, vs the unfused dense forward of the same params."""
    from caffe_escoin_tpu.engine.context import ConvMode, ExecutionPolicy
    from caffe_escoin_tpu.nn.fuse import fuse_inference
    from caffe_escoin_tpu.utils.pruning import prune_conv_weight

    pol = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=(8, 8))
    specs, shapes, _ = load_net(f"{REF}/resnet/test_sconv.prototxt", batch=1)
    # truncate after stage 2 (res2a..res2c) — small spatial input would
    # underflow pool5's 7x7 kernel, and full 224^2 is CPU-slow
    keep = []
    for s in specs:
        if s.name.startswith(("res3", "bn3", "scale3")):
            break
        keep.append(s)
    net = Net(keep, policy=pol, phase="test")
    shapes = {"data": (1, 64, 64, 3)}  # small spatial for CPU speed
    params = net.init(jax.random.PRNGKey(0), shapes)
    rng = np.random.default_rng(0)
    for l in net.layers:
        n = l.spec.name
        if l.spec.type in ("Convolution", "EscConvolution") and \
                n in params and params[n]["w"].shape[2] > 3:
            q = dict(params[n])
            q["w"] = np.asarray(prune_conv_weight(
                np.asarray(q["w"]), 0.8, (1, 8)))
            params[n] = q
    x = {"data": np.asarray(rng.standard_normal(shapes["data"]), np.float32)}
    ref_blobs = net.apply(params, x)
    (ref_top, ref_val), = [(k, v) for k, v in ref_blobs.items()]
    fnet, fparams = fuse_inference(net, params, state=net.state0)
    assert not any(l.spec.type in ("BatchNorm", "Scale", "Eltwise")
                   for l in fnet.layers)
    aligned = fnet.weight_align(fparams)
    out = jax.jit(lambda q: fnet.apply(q, x))(aligned)[ref_top]
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref_val),
                               rtol=2e-3, atol=2e-4)


# ------------------------------------------------------------------
# Emission (net_to_prototxt): the net_spec.py to_proto counterpart
# ------------------------------------------------------------------

from caffe_escoin_tpu.tools.prototxt import (  # noqa: E402
    layer_to_prototxt,
    net_to_prototxt,
)

# keys net_from_prototxt ALWAYS sets (with caffe.proto defaults) and keys
# it OMITS at their default — canonicalizing both sides makes builder
# specs (which may rely on framework defaults) comparable to reparsed ones
_ALWAYS = {
    "Convolution": {"kernel": 3, "stride": 1, "pad": 0, "bias_term": True},
    "ConvolutionReLU": {"kernel": 3, "stride": 1, "pad": 0,
                        "bias_term": True},
    "EscConvolution": {"kernel": 3, "stride": 1, "pad": 0,
                       "bias_term": True},
    "Deconvolution": {"kernel": 3, "stride": 1, "pad": 0,
                      "bias_term": True},
    "InnerProduct": {"bias_term": True},
    "LRN": {"local_size": 5, "alpha": 1e-4, "beta": 0.75},
    "Dropout": {"ratio": 0.5},
    "Softmax": {"axis": -1},
    "Concat": {"axis": -1},
    "Slice": {"axis": -1, "slice_points": ()},
    "Eltwise": {"operation": "sum"},
    "Scale": {"bias_term": True},
    "Power": {"power": 1.0, "scale": 1.0, "shift": 0.0},
    "Flatten": {"axis": 1},
}
_OMIT = {
    "Convolution": {"dilation": 1, "group": 1},
    "ConvolutionReLU": {"dilation": 1, "group": 1},
    "EscConvolution": {"dilation": 1, "group": 1},
    "Deconvolution": {"dilation": 1, "group": 1},
    "Pooling": {"pad": 0},
    "ReLU": {"negative_slope": 0.0},
    "Accuracy": {"top_k": 1},
}


def _canon_params(type_, p):
    out = dict(p)
    for k, d in _OMIT.get(type_, {}).items():
        if k in out and out[k] == d:
            del out[k]
    for k, d in _ALWAYS.get(type_, {}).items():
        out.setdefault(k, d)
    if type_ == "Pooling":
        out.setdefault("mode", "avg" if out.get("global_pooling") else "max")
        if not out.get("global_pooling"):
            out.setdefault("kernel", 2)
            out.setdefault("stride", 1)
    # spatial pairs: (3, 3) and 3 declare the same geometry
    for k in ("kernel", "stride", "pad", "dilation"):
        v = out.get(k)
        if isinstance(v, (tuple, list)) and len(v) == 2 and v[0] == v[1]:
            out[k] = v[0]
    return out


def _assert_specs_equivalent(s1, s2):
    assert len(s1) == len(s2)
    for a, b in zip(s1, s2):
        assert (a.name, a.type, a.bottoms, a.tops) == \
               (b.name, b.type, b.bottoms, b.tops)
        assert a.phase == b.phase and a.share_params == b.share_params
        assert a.loss_weight == pytest.approx(b.loss_weight)
        ca, cb = (_canon_params(a.type, a.params),
                  _canon_params(b.type, b.params))
        assert ca == cb, f"{a.name}: {ca} != {cb}"


@pytest.mark.parametrize("model", ["lenet", "cifar10_bn", "alexnet",
                                   "vgg16", "googlenet", "resnet50"])
def test_emit_roundtrip_zoo_builder(model):
    """net_from_prototxt(net_to_prototxt(builder())) reproduces the
    builder's specs and input shapes (semantically canonical)."""
    from caffe_escoin_tpu.models import ZOO

    builder, shapes = ZOO[model]
    specs = builder()
    text = net_to_prototxt(specs, shapes, name=model)
    specs2, shapes2, name2 = net_from_prototxt(text)
    assert name2 == model
    assert {k: tuple(v) for k, v in shapes.items()} == shapes2
    _assert_specs_equivalent(specs, specs2)


def test_emit_roundtrip_forward_equality():
    """The round-tripped net computes the identical function: same init
    (same PRNG), same outputs."""
    from caffe_escoin_tpu.models import ZOO

    builder, shapes = ZOO["cifar10_bn"]
    specs = builder()
    specs2, shapes2, _ = net_from_prototxt(net_to_prototxt(specs, shapes))
    net1, net2 = Net(specs, phase="test"), Net(specs2, phase="test")
    sh = {"data": (2, 32, 32, 3)}
    p1 = net1.init(jax.random.PRNGKey(5), sh)
    p2 = net2.init(jax.random.PRNGKey(5), sh)
    x = np.random.default_rng(0).standard_normal(sh["data"]).astype(
        np.float32)
    y1, y2 = net1.apply(p1, {"data": x}), net2.apply(p2, {"data": x})
    k = next(iter(y1))
    np.testing.assert_allclose(np.asarray(y1[k]), np.asarray(y2[k]),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("relpath", [
    "bvlc_googlenet/deploy.prototxt",
    "resnet/test_sconv.prototxt",
    "bvlc_alexnet/train_val.prototxt",
])
def test_emit_reference_idempotence(relpath):
    """load -> emit -> load is the identity on the reference's own model
    files: the emitted text preserves every spec field exactly (a
    bidirectional config loop)."""
    path = os.path.join(REF, relpath)
    specs1, shapes1, name1 = load_net(path)
    text = net_to_prototxt(specs1, shapes1, name=name1)
    specs2, shapes2, name2 = net_from_prototxt(text)
    assert (name2, shapes2) == (name1, shapes1)
    assert specs1 == specs2


def test_emit_fused_net_extension_fields():
    """Fused nets (fuse_relu/fuse_add epilogue params, inexpressible in
    caffe.proto) round-trip through the cescoin_param extension; strict
    caffe compat drops them."""
    from caffe_escoin_tpu.nn import Net
    from caffe_escoin_tpu.nn.fuse import fuse_inference

    shapes = {"data": (1, 8, 8, 3)}
    specs = [
        LayerSpec(name="conv1", type="Convolution", bottoms=["data"],
                  tops=["c1"], params={"num_output": 8, "kernel": 3,
                                       "pad": 1}),
        LayerSpec(name="relu1", type="ReLU", bottoms=["c1"], tops=["r1"]),
        LayerSpec(name="fc1", type="InnerProduct", bottoms=["r1"],
                  tops=["out"], params={"num_output": 4}),
    ]
    net = Net(specs, phase="test")
    params = net.init(jax.random.PRNGKey(0), shapes)
    fnet, _ = fuse_inference(net, params, state=net.state0)
    fspecs = [l.spec for l in fnet.layers]
    assert any(l.params.get("fuse_relu") for l in fspecs)

    text = net_to_prototxt(fspecs, shapes)
    specs2, _, _ = net_from_prototxt(text)
    _assert_specs_equivalent(fspecs, list(specs2))
    assert specs2[0].params.get("fuse_relu") is True

    strict = net_to_prototxt(fspecs, shapes, compat="caffe")
    assert "cescoin_param" not in strict
    specs3, _, _ = net_from_prototxt(strict)
    assert not any(l.params.get("fuse_relu") for l in specs3)


def test_emit_share_params_extension():
    spec = LayerSpec(name="ip2", type="InnerProduct", bottoms=["x"],
                      tops=["y"], params={"num_output": 8},
                      share_params="ip1")
    text = layer_to_prototxt(spec)
    assert 'share_params: "ip1"' in text
    specs2, _, _ = net_from_prototxt(text)
    assert specs2[0].share_params == "ip1"
    _assert_specs_equivalent([spec], list(specs2))


def test_solver_emit_roundtrip():
    """solver_to_prototxt inverts solver_from_prototxt on SolverConfig
    fields + run settings — including the reference's own solver file."""
    from caffe_escoin_tpu.tools.prototxt import solver_to_prototxt

    cfg1, run1 = load_solver(f"{REF}/bvlc_alexnet/solver.prototxt")
    cfg2, run2 = solver_from_prototxt(solver_to_prototxt(cfg1, run1))
    assert cfg1 == cfg2
    for k, v in run1.items():
        if v not in (None, "", 0):
            assert run2[k] == v, k


def test_cli_export_prototxt_roundtrips(tmp_path):
    """CLI export_prototxt: the emitted file reloads into an equivalent
    net; --fuse exports the fused graph with fewer layers."""
    from caffe_escoin_tpu.tools import cli

    out = str(tmp_path / "lenet.prototxt")
    assert cli.main(["export_prototxt", "--model", "lenet",
                     "--output", out]) in (0, None)
    specs, shapes, name = load_net(out)
    assert name == "lenet" and "data" in shapes
    net = Net(specs, phase="test")
    net.init(jax.random.PRNGKey(0), shapes)

    fused = str(tmp_path / "lenet_fused.prototxt")
    assert cli.main(["export_prototxt", "--model", "lenet", "--fuse",
                     "--output", fused]) in (0, None)
    fspecs, _, _ = load_net(fused)
    assert len(fspecs) <= len(specs)


def test_v0_prototxt_upgrade():
    """Synthesized V0 NetParameter (`layers { layer { ... } }`, layer-level
    kernelsize/pad/stride/blobs_lr, a `padding` layer) loads through the
    UpgradeV0LayerParameter migrations (upgrade_proto.cpp:199-540)."""
    text = """
    name: "v0net"
    input: "data"
    input_dim: 1 input_dim: 3 input_dim: 16 input_dim: 16
    layers {
      layer {
        name: "pad1" type: "padding" pad: 2
      }
      bottom: "data" top: "pad1"
    }
    layers {
      layer {
        name: "conv1" type: "conv"
        num_output: 8 kernelsize: 5 stride: 1 group: 1
        blobs_lr: 1.0 blobs_lr: 2.0
        weight_decay: 1.0 weight_decay: 0.0
        weight_filler { type: "gaussian" std: 0.01 }
      }
      bottom: "pad1" top: "conv1"
    }
    layers {
      layer { name: "relu1" type: "relu" }
      bottom: "conv1" top: "conv1"
    }
    layers {
      layer { name: "pool1" type: "pool" kernelsize: 2 stride: 2 pool: MAX }
      bottom: "conv1" top: "pool1"
    }
    layers {
      layer { name: "drop1" type: "dropout" dropout_ratio: 0.3 }
      bottom: "pool1" top: "pool1"
    }
    layers {
      layer { name: "fc1" type: "innerproduct" num_output: 4 }
      bottom: "pool1" top: "fc1"
    }
    layers {
      layer { name: "prob" type: "softmax" }
      bottom: "fc1" top: "prob"
    }
    """
    specs, shapes, name = net_from_prototxt(text)
    assert name == "v0net"
    assert shapes["data"] == (1, 16, 16, 3)
    by_name = {s.name: s for s in specs}
    # padding layer folded into conv1 (dropped, pad transferred, rewired)
    assert "pad1" not in by_name
    c1 = by_name["conv1"]
    assert c1.type == "Convolution" and c1.bottoms == ("data",)
    assert c1.params["num_output"] == 8
    assert c1.params["kernel"] == 5
    assert c1.params["pad"] == 2
    assert c1.params["weight_filler"] == {"type": "gaussian", "std": 0.01}
    assert c1.params["param_specs"] == [
        {"lr_mult": 1.0, "decay_mult": 1.0},
        {"lr_mult": 2.0, "decay_mult": 0.0}]
    assert by_name["pool1"].params["mode"] == "max"
    assert by_name["pool1"].params["kernel"] == 2
    assert by_name["drop1"].params["ratio"] == 0.3
    assert by_name["fc1"].type == "InnerProduct"
    assert by_name["prob"].type == "Softmax"
    # the upgraded net must actually run
    net = Net(specs, phase="test")
    params = net.init(jax.random.PRNGKey(0), shapes)
    out = net.apply(params, {"data": np.zeros(shapes["data"], np.float32)})
    assert out["prob"].shape == (1, 4)

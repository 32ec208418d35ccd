"""Inference-time graph fusion: fold BN/Scale/ReLU/residual into convs.

Without it a per-layer sparse-conv win evaporates end-to-end: Caffe-style
nets run Conv -> BatchNorm -> Scale -> ReLU as FOUR layers (the reference
executes them as four kernel launches too,
`models/resnet/test_sconv.prototxt`), so the conv epilogue never fuses,
every activation makes three extra device-memory round trips, and the
"other" bucket dwarfs conv once sparsity makes the convs fast.

This pass rewrites the graph for inference (the analogue of the
weight-folding every production deployment of a Caffe model performs, and
of what `Net::CopyTrainedLayersFrom` + WeightAlign would be extended to do):

* **Affine fold**: Conv -> [BatchNorm] -> [Scale] -> [ReLU] chains collapse
  into one conv whose weights/bias absorb the affine (w' = w * a,
  b' = b * a + c with a = gamma/sqrt(var+eps), c = beta - mean*a) and whose
  epilogue applies the ReLU (`fuse_relu`, the reference's
  ConvolutionReLULayer / `sconv_relu_*` kernels). Zero weights stay zero, so
  the sparsity pattern — and the aligned BSC structure — is unchanged.
* **Residual fold**: Eltwise(sum)(shortcut, conv_out) -> ReLU collapses into
  the producing conv (`fuse_add`): the conv takes the shortcut as a second
  bottom and adds it inside the sparse epilogue (per block-column, in f32,
  before the bf16 cast), removing a separate whole-feature-map read+write
  pass per bottleneck block.
* **FC ReLU fold**: InnerProduct -> ReLU sets `fuse_relu` on the fc (the
  XBSP SpMM epilogue applies it per block-column).

Folding uses the net's BatchNorm moving statistics (the state collection;
`batchnorm_state` from tools/caffemodel.py for imported models), so it is
an inference-only transform — phase "test" / use_global_stats BN only.

Run BEFORE weight_align: the fold needs dense `w` arrays. Typical flow::

    net = Net(specs, policy=pol, phase="test")
    params = net.init(rng, shapes)            # or imported weights
    fnet, fparams = fuse_inference(net, params, state=net.state0)
    fwd = fnet.inference_fn(fnet.weight_align(fparams))
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from caffe_escoin_tpu.nn.net import LayerSpec, Net

CONV_TYPES = ("Convolution", "ConvolutionReLU", "EscConvolution")
FOLDABLE_TYPES = CONV_TYPES + ("InnerProduct",)


def _moving_stats(st: Optional[Dict[str, Any]], cout: int,
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Decayed-sum blobs -> (mean, var), matching BatchNormLayer._moving
    (count==0 -> (0, 1), the reference's scale_factor=0 case)."""
    if st is None:
        return np.zeros(cout, np.float32), np.ones(cout, np.float32)
    mean_acc = np.asarray(jax.device_get(st["mean_acc"]), np.float32)
    var_acc = np.asarray(jax.device_get(st["var_acc"]), np.float32)
    count = float(jax.device_get(st["count"]))
    if count > 0:
        return mean_acc / count, var_acc / count
    return np.zeros_like(mean_acc), np.ones_like(var_acc)


def _final_tops(specs) -> set:
    consumed = {b for s in specs for b in s.bottoms}
    return {t for s in specs for t in s.tops if t not in consumed}


def fuse_inference(net: Net, params: Dict[str, Any],
                   state: Optional[Dict[str, Any]] = None,
                   *, fuse_residual: bool = True,
                   ) -> Tuple[Net, Dict[str, Any]]:
    """Returns (fused_net, fused_params). ``state`` supplies BN moving
    stats (defaults to ``net.state0`` when the net was init()-ed)."""
    if state is None:
        state = getattr(net, "state0", {})
    specs = list(net.specs)
    new_params: Dict[str, Any] = dict(params)
    finals = _final_tops(specs)

    # ---------------- pass A: affine/ReLU folding ----------------------
    consumers: Dict[str, list] = {}
    for i, s in enumerate(specs):
        for b in s.bottoms:
            consumers.setdefault(b, []).append(i)
    removed: set = set()
    replaced: Dict[int, LayerSpec] = {}

    for i, s in enumerate(specs):
        if s.type not in FOLDABLE_TYPES or i in removed:
            continue
        p = new_params.get(s.name)
        if not isinstance(p, dict) or "w" not in p:
            continue  # already aligned / shared params: leave alone
        if s.share_params is not None:
            continue  # folding would desync the shared owner
        w = np.asarray(jax.device_get(p["w"]))
        cout = w.shape[-1]
        a = np.ones(cout, np.float32)
        c = np.zeros(cout, np.float32)
        affine = False
        fuse_relu = bool(s.type == "ConvolutionReLU"
                         or s.params.get("fuse_relu"))
        top = s.tops[0]
        chain = []
        while True:
            cons = consumers.get(top, [])
            if len(cons) != 1 or top in finals:
                break
            j = cons[0]
            nxt = specs[j]
            if j in removed or fuse_relu:
                break
            if nxt.type == "BatchNorm":
                use_global = nxt.params.get("use_global_stats")
                if use_global is None:
                    use_global = net.phase == "test"
                if not use_global:
                    break
                eps = nxt.params.get("eps", 1e-5)
                mean, var = _moving_stats(state.get(nxt.name), cout)
                inv = 1.0 / np.sqrt(var + eps)
                a = a * inv
                c = (c - mean) * inv
                affine = True
            elif nxt.type == "Scale":
                sp = new_params.get(nxt.name, {})
                gamma = np.asarray(jax.device_get(sp["gamma"]), np.float32) \
                    if "gamma" in sp else np.ones(cout, np.float32)
                a = a * gamma
                c = c * gamma
                if "beta" in sp:
                    c = c + np.asarray(jax.device_get(sp["beta"]), np.float32)
                affine = True
                new_params.pop(nxt.name, None)
            elif (nxt.type == "ReLU"
                  and nxt.params.get("negative_slope", 0.0) == 0.0):
                fuse_relu = True
            else:
                break
            chain.append(j)
            top = nxt.tops[0]
            if fuse_relu:
                break
        if not chain:
            continue
        q = dict(p)
        if affine:
            q["w"] = np.asarray(jax.device_get(p["w"]), np.float32) * a
            b0 = (np.asarray(jax.device_get(p["b"]), np.float32)
                  if "b" in p else 0.0)
            q["b"] = b0 * a + c
        new_params[s.name] = q
        sp_params = dict(s.params)
        if affine:
            sp_params["bias_term"] = True
        if fuse_relu:
            sp_params["fuse_relu"] = True
        replaced[i] = dataclasses.replace(s, tops=(top,), params=sp_params)
        removed.update(chain)

    specs = [replaced.get(i, s) for i, s in enumerate(specs)
             if i not in removed]

    # ---------------- pass B: residual (Eltwise-sum + ReLU) folding ----
    if fuse_residual:
        producer: Dict[str, int] = {}
        consumers = {}
        for i, s in enumerate(specs):
            for b in s.bottoms:
                consumers.setdefault(b, []).append(i)
            for t in s.tops:
                producer[t] = i
        removed = set()
        replaced = {}
        for i, s in enumerate(specs):
            if (s.type != "Eltwise" or i in removed
                    or s.params.get("operation", "sum") != "sum"
                    or len(s.bottoms) != 2):
                continue
            coeffs = s.params.get("coeffs")
            if coeffs is not None and any(cf != 1.0 for cf in coeffs):
                continue
            # pick the LATER conv producer among the two bottoms (the
            # residual branch tail, e.g. branch2c) whose top feeds only
            # this Eltwise; the other bottom becomes the fused add input
            best = None
            for pos, b in enumerate(s.bottoms):
                ci = producer.get(b)
                if ci is None or ci in removed or ci in replaced:
                    continue
                pc = specs[ci]
                if (pc.type not in CONV_TYPES or len(pc.bottoms) != 1
                        or pc.params.get("fuse_relu")
                        or pc.params.get("fuse_add")):
                    continue
                if consumers.get(b, []) != [i] or b in finals:
                    continue
                other = s.bottoms[1 - pos]
                oi = producer.get(other, -1)
                if oi >= ci:
                    continue  # shortcut must exist before the conv runs
                if best is None or ci > best[0]:
                    best = (ci, other)
            if best is None:
                continue
            ci, other = best
            pc = specs[ci]
            # optional trailing ReLU
            top = s.tops[0]
            relu = False
            cons = consumers.get(top, [])
            if len(cons) == 1 and top not in finals:
                nxt = specs[cons[0]]
                if (nxt.type == "ReLU"
                        and nxt.params.get("negative_slope", 0.0) == 0.0):
                    relu = True
                    removed.add(cons[0])
                    top = nxt.tops[0]
            sp_params = dict(pc.params)
            sp_params["fuse_add"] = True
            if relu:
                sp_params["fuse_relu"] = True
            replaced[ci] = dataclasses.replace(
                pc, bottoms=(pc.bottoms[0], other), tops=(top,),
                params=sp_params)
            removed.add(i)
        specs = [replaced.get(i, s) for i, s in enumerate(specs)
                 if i not in removed]

    fused = Net(specs, policy=net.policy, phase=net.phase)
    # carry surviving layers' state through (BN layers that didn't fold)
    fused.state0 = {k: v for k, v in state.items()
                    if any(l.spec.name == k for l in fused.layers)}
    if hasattr(net, "blob_shapes"):
        fused.blob_shapes = dict(net.blob_shapes)
    return fused, new_params


def _pool_geom(s: LayerSpec):
    """(kernel_w, stride_w) of a Pooling spec (Caffe defaults)."""
    def wdim(v, d):
        v = s.params.get(v, d)
        if isinstance(v, (tuple, list)):
            return int(v[-1])
        return int(v)
    k = wdim("kernel", 2)
    return k, wdim("stride", k)


def _conv_geom(s: LayerSpec):
    """(kernel_w, stride_w, dilation_w, groups) of a 2-D conv spec."""
    def wdim(v, d):
        v = s.params.get(v, d)
        if isinstance(v, (tuple, list)):
            return int(v[-1])
        return int(v)
    return (wdim("kernel", 3), wdim("stride", 1), wdim("dilation", 1),
            int(s.params.get("group", 1)))


def pack_narrow_chains(net: Net, *, lanes: int = 128) -> Net:
    """W-pair packed-layout pass (ops/wpack.py): route narrow-channel
    towers through full-lane packed execution.

    Built for an accelerator whose tiled layouts pad the channel (lane)
    dimension to 128, where every device-memory byte of a C<128
    activation costs 128/C real bytes; whether it pays on the GPU is an
    open measurement (ROADMAP design item 2). This pass finds maximal
    subgraphs where r adjacent W-pixels can ride the unused lanes, with pack/unpack folded into the boundary layers as
    pure conv/pool reparametrizations so no retile pass ever materializes:

    * seeds: interior 4-D blobs with pack_factor(C, W) > 1;
    * producers: convs emit packed via `repack_weight` (any stride), MAX/
      AVE pools via phase-split windows (`pool2d_packed_out`);
    * consumers: convs consume packed when the packed stride
      sw*r_out/r_in is integral — strided stage-boundary convs terminate
      chains naturally (e.g. a 1x1/s2 consumer of an r=2 blob);
    * residual (fuse_add) second-bottoms must match the conv's output
      layout, which grows the packed set across whole residual stages;
    * blobs whose layout cannot be closed (pooling/concat/loss consumers,
      final tops) are dropped, and the constraint set re-solved to a
      fixpoint.

    Runs AFTER `fuse_inference` (it keys on fuse_add residual bottoms).
    Params are untouched — layers repack their logical weights at
    align/apply time — so checkpoints and exports stay in the public
    layout.

    No reference counterpart: GPU gathers are per-lane, so the reference
    never needed a layout pass; the closest analogue is its model-load
    weight reorganization (`base_conv_layer.cpp:46-273`)."""
    from caffe_escoin_tpu.ops import wpack as _wpack

    specs = list(net.specs)
    shapes: Dict[str, Tuple[int, ...]] = dict(
        getattr(net, "blob_shapes", None) or {})
    if not shapes:
        return net  # no shape information: nothing to do
    finals = _final_tops(specs)
    producer: Dict[str, int] = {}
    consumers: Dict[str, list] = {}
    for i, s in enumerate(specs):
        for b in s.bottoms:
            consumers.setdefault(b, []).append(i)
        for t in s.tops:
            producer[t] = i
    # params shared ACROSS layers cannot repack: align() is per-layer and
    # the sharing twin may run unpacked geometry on the same weights
    share_targets = {s.share_params for s in specs if s.share_params}

    import math

    def markable(b, r):
        shp = shapes.get(b)
        return (b in producer and b not in finals and shp is not None
                and len(shp) == 4 and shp[2] % r == 0
                and shp[3] * r <= 512)  # keep packed lanes a sane width

    packed: Dict[str, int] = {}
    for b, shp in shapes.items():
        if b in producer and b not in finals and len(shp) == 4:
            r = _wpack.pack_factor(shp[3], shp[2], lanes=lanes)
            if r > 1:
                packed[b] = r

    dead: set = set()

    def check(b, r):
        """(ok, [(blob, required_r), ...]) for blob b packed at r."""
        needs = []
        if not markable(b, r):
            return False, needs
        pi = producer[b]
        ps = specs[pi]
        if ps.type in CONV_TYPES:
            if ps.params.get("s2d_r"):
                return False, needs  # s2d stem convs keep their own layout
            if len(shapes.get(ps.bottoms[0], ())) != 4:
                return False, needs
            if ps.share_params is not None or ps.name in share_targets:
                # a sharing twin may execute unpacked geometry on the
                # same logical weights; align() repacks per-layer, so
                # packing a shared conv would desync the pair
                return False, needs
            kw, sw, dil, g = _conv_geom(ps)
            if dil != 1 or g != 1:
                return False, needs
            r_in = packed.get(ps.bottoms[0], 1)
            if (sw * r) % r_in != 0:
                return False, needs
            if len(ps.bottoms) > 1:  # fuse_add residual rides output layout
                if not ps.params.get("fuse_add"):
                    return False, needs
                needs.append((ps.bottoms[1], r))
        elif ps.type == "Pooling":
            p = ps.params
            if (p.get("global_pooling") or p.get("mode", "max")
                    not in ("max", "avg")):
                return False, needs
            _, sw = _pool_geom(ps)
            r_in = packed.get(ps.bottoms[0], 1)
            if (sw * r) % r_in != 0:
                return False, needs
        elif ps.type == "LRN":
            # layout-transparent per (pixel, channel-window): packed
            # execution via lane-masked windows (ops/norm.py groups=r)
            needs.append((ps.bottoms[0], r))
        else:
            return False, needs
        for ci in consumers.get(b, []):
            cs = specs[ci]
            if cs.type in CONV_TYPES:
                if cs.params.get("s2d_r"):
                    return False, needs
                if len(shapes.get(cs.bottoms[0], ())) != 4:
                    return False, needs
                if cs.share_params is not None or cs.name in share_targets:
                    return False, needs
                kw, sw, dil, g = _conv_geom(cs)
                if dil != 1 or g != 1:
                    return False, needs
                if cs.bottoms[0] == b:
                    r_out = packed.get(cs.tops[0], 1)
                    if (sw * r_out) % r != 0:
                        need_r = r // math.gcd(sw, r)
                        needs.append((cs.tops[0], need_r))
                if len(cs.bottoms) > 1 and cs.bottoms[1] == b:
                    if not cs.params.get("fuse_add"):
                        return False, needs
                    needs.append((cs.tops[0], r))
            elif cs.type == "Pooling":
                p = cs.params
                if (p.get("global_pooling") or p.get("mode", "max")
                        not in ("max", "avg")):
                    return False, needs
                _, sw = _pool_geom(cs)
                r_out = packed.get(cs.tops[0], 1)
                if (sw * r_out) % r != 0:
                    # a packed-output pool needs its own top markable
                    need_r = r // math.gcd(sw, r)
                    needs.append((cs.tops[0], need_r))
            elif cs.type == "LRN":
                needs.append((cs.tops[0], r))
            else:
                return False, needs
        return True, needs

    stable = False
    while not stable:
        stable = True
        for b in sorted(packed):
            r = packed[b]
            ok, needs = check(b, r)
            if ok:
                for nb, nr in needs:
                    cur = packed.get(nb)
                    if cur == nr:
                        continue
                    if nb in dead or cur is not None or not markable(nb, nr):
                        ok = False
                        break
                    packed[nb] = nr
                    stable = False
            if not ok:
                del packed[b]
                dead.add(b)
                stable = False

    if not packed:
        return net

    new_specs = []
    for s in specs:
        if s.type in CONV_TYPES:
            r_in = packed.get(s.bottoms[0], 1)
            r_out = packed.get(s.tops[0], 1)
            if r_in > 1 or r_out > 1:
                p = dict(s.params)
                p["pack_in"], p["pack_out"] = r_in, r_out
                p["pack_w"] = int(shapes[s.bottoms[0]][2])
                s = dataclasses.replace(s, params=p)
        elif s.type == "Pooling":
            r_in = packed.get(s.bottoms[0], 1)
            r_out = packed.get(s.tops[0], 1)
            if r_in > 1 or r_out > 1:
                s = dataclasses.replace(
                    s, params=dict(s.params, pack_in=r_in,
                                   pack_out=r_out))
        elif s.type == "LRN":
            r_in = packed.get(s.bottoms[0], 1)
            if r_in > 1:
                s = dataclasses.replace(
                    s, params=dict(s.params, pack_in=r_in))
        new_specs.append(s)

    out = Net(new_specs, policy=net.policy, phase=net.phase)
    out.state0 = getattr(net, "state0", {})
    out.blob_shapes = {
        b: ((shp[0], shp[1], shp[2] // packed[b], shp[3] * packed[b])
            if b in packed and len(shp) == 4 else shp)
        for b, shp in shapes.items()}
    out.packed_blobs = dict(packed)
    return out


def fold_stem_s2d(net: Net, params: Dict[str, Any],
                  *, max_lanes: int = 128) -> Tuple[Net, Dict[str, Any]]:
    """Space-to-depth reformulation of the stem conv (ops/s2d.py).

    Finds 2-D convs whose bottom is a NET INPUT (an image) with
    cin*stride^2 <= max_lanes, square stride r >= 2, dilation 1, group 1,
    and rewrites them to run stride-1 over the [N, H/r, W/r, r*r*C]
    space-to-depth layout: the weight is remapped tap-by-tap
    (`s2d_weight`, zero structure preserved) and the spec's geometry
    becomes the packed kernel; `ConvolutionLayer.apply` inserts the input
    transform. Exact by construction (tests/test_s2d.py).

    Why: a cin=3 conv uses 3 of a matrix unit's 128-wide contraction per
    tap. The s2d form quadruples the per-tap contraction depth and
    quarters the window iteration count; it is applied per-model where
    the COMPOSED measurement wins (bench.py --s2d / --no-s2d), the same
    measured-acceptance rule as every other executor choice here.

    Runs after `fuse_inference` (needs folded dense weights), before
    `pack_narrow_chains` (which skips s2d convs). Returns (net, params)
    with remapped stem weights; non-stem layers share the input mapping.
    """
    from caffe_escoin_tpu.ops import s2d as _s2d

    specs = list(net.specs)
    produced = {t for s in specs for t in s.tops}
    new_params = dict(params)
    out_specs: list = []
    n_folded = 0
    for s in specs:
        if (s.type not in CONV_TYPES or not s.bottoms
                or s.bottoms[0] in produced or s.share_params is not None
                or s.params.get("s2d_r") or s.params.get("pack_in")
                or s.params.get("pack_out") or s.params.get("fuse_add")):
            out_specs.append(s)
            continue
        p = new_params.get(s.name)
        if not isinstance(p, dict) or "w" not in p or p["w"].ndim != 4:
            out_specs.append(s)
            continue
        kh, kw, cin, cout = p["w"].shape
        prm = s.params

        def dim(v, d, i):
            v = prm.get(v, d)
            return int(v[i]) if isinstance(v, (tuple, list)) else int(v)

        sh, sw = dim("stride", 1, 0), dim("stride", 1, 1)
        ph, pw = dim("pad", 0, 0), dim("pad", 0, 1)
        if (sh != sw or sh < 2 or dim("dilation", 1, 0) != 1
                or dim("dilation", 1, 1) != 1
                or int(prm.get("group", 1)) != 1
                or cin * sh * sh > max_lanes):
            out_specs.append(s)
            continue
        r = sh
        w = np.asarray(jax.device_get(p["w"]))
        wp = _s2d.s2d_weight(w, r, (ph, pw))
        new_params[s.name] = dict(p, w=jnp.asarray(wp))
        out_specs.append(dataclasses.replace(s, params=dict(
            prm, kernel=[wp.shape[0], wp.shape[1]], stride=1, pad=0,
            s2d_r=r, s2d_kernel=[kh, kw], s2d_pad=[ph, pw])))
        n_folded += 1
    if not n_folded:
        return net, params
    out = Net(out_specs, policy=net.policy, phase=net.phase)
    out.state0 = getattr(net, "state0", {})
    if hasattr(net, "blob_shapes"):
        out.blob_shapes = dict(net.blob_shapes)
    return out, new_params


def deploy_sparse(net: Net, pruned: Dict[str, Any], *, pack: bool = True):
    """The sparse inference deployment of an init()-ed net and its pruned
    params: fold BN/Scale and fuse epilogues (`fuse_inference`), optionally
    route narrow towers through the W-pair layout (`pack_narrow_chains`),
    then sparse-compile the weights. Returns (fused_net, aligned_params)."""
    fnet, fparams = fuse_inference(net, pruned, state=net.state0)
    if pack:
        fnet = pack_narrow_chains(fnet)
    return fnet, fnet.weight_align(fparams)

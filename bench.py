"""Benchmark: sparse-conv speedup vs dense XLA conv on one accelerator.

Per-layer mode (default): enumerate the model's conv layers (from the model
spec itself, with shapes from Net shape inference), group into unique (H, W,
Cin, Cout, K, stride) configs with occurrence counts, and for EVERY
sparse-eligible config (stride 1 — the SCONV kernel's domain; stride-2 layers
run dense in both frameworks, exactly like the reference's fallback at
base_conv_layer.cpp:752) measure THREE arms:

  * t_dense_f32 : XLA `lax.conv_general_dilated`, f32 in/out (what a stock
                  f32 model gets — the reference methodology's baseline,
                  cuDNN IMPLICIT_GEMM f32, `esc_conv_layer.cu:27`)
  * t_dense_bf16: the same conv with bf16 activations+weights — the
                  byte-honest baseline (bf16 halves HBM traffic; several
                  ResNet shapes are bandwidth-bound)
  * t_sparse    : the framework's sparse executor (dispatcher-selected XBSP
                  arm, bf16 activations), weights closed over

with device-timeline timing (utils/benchmark.py) from the XLA profiler
(the host-clock slope on the CPU backend; every result names its timer and
device).

Reported metric: FLOP-weighted total conv-time speedup over all measured
layers (weighted by per-layer occurrence count), i.e. the conv-bucket speedup
the reference's instrumentation reports (`tools/caffe.cpp:338-367`). The
HEADLINE value is the speedup vs the bf16 dense baseline (the strict
comparison); vs_f32 is also reported. vs_baseline normalizes against the
2.0x BASELINE target.

Whole-net mode (--e2e): times the full jitted `Net.inference_fn` —
dense-f32 vs dense-bf16 vs sparse (conv AND fc weights pruned + aligned,
SCONV_PAR policy) — and a per-layer conv/fc/data/other bucket split.

--granularity unstructured prunes element-wise (the reference's pruned-model
workload, `run.sh:3-5`) instead of 128x128 blocks; measured honestly (at 90%
random element sparsity virtually no 128x128 block is empty, so the block
executors cannot skip work).

Prints ONE JSON line on stdout; human-readable detail goes to stderr.
--jsonl FILE appends one JSON row per measured layer for the record.
"""

import argparse
import json
import os
import sys


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def device_info():
    """The device every result line names: platform, kind, count, and the
    timer that produced the numbers."""
    import jax

    from caffe_escoin_tpu.utils.benchmark import timer_name

    d = jax.devices()[0]
    return {"device": {"platform": d.platform, "kind": d.device_kind,
                       "count": len(jax.devices())},
            "timer": timer_name()}


def emit(result, jsonl=""):
    """Print one result line (and append it to ``jsonl``), tagged with the
    device and timer."""
    result = {**result, **device_info()}
    if jsonl:
        with open(jsonl, "a") as f:
            f.write(json.dumps(result) + "\n")
    print(json.dumps(result))


_STREAM_RATE = None


def stream_rate():
    """Measured achievable device-memory stream rate (bytes/s, read+write)
    — the denominator of the per-row roofline bound. A plain elementwise
    copy is the speed-of-light for any bandwidth-bound op."""
    global _STREAM_RATE
    if _STREAM_RATE is None:
        import jax.numpy as jnp

        from caffe_escoin_tpu.utils.benchmark import device_time

        x = jnp.zeros((64, 1024, 1024), jnp.float32)  # 256 MB
        t = device_time(lambda y: y * 1.0001, x, iters=10)
        _STREAM_RATE = 2 * x.size * 4 / t
        log(f"measured device-memory stream rate: "
            f"{_STREAM_RATE/1e12:.2f} TB/s")
    return _STREAM_RATE


def roofline_us(n, h, w, cin, ho, wo, cout, live_blocks, bk, bn,
                dtype_bytes=2):
    """Ideal-traffic bound for one sparse conv: read the ifmap once, read
    the live weight blocks once, write the ofmap once. An executor at this
    bound is at speed-of-light; time above it is headroom (or re-reads the
    formulation pays, e.g. the unroll's per-offset slab reads)."""
    read = n * h * w * cin * dtype_bytes + live_blocks * bk * bn * dtype_bytes
    write = n * ho * wo * cout * dtype_bytes
    return (read + write) / stream_rate() * 1e6


def conv_configs(model, batch):
    """Unique conv configs (h, w, cin, cout, k, stride, pad, group) -> count,
    derived from the model spec + shape inference."""
    import jax

    from caffe_escoin_tpu.models import ZOO
    from caffe_escoin_tpu.nn import Net

    builder, input_shapes = ZOO[model]
    net = Net(builder())
    shape = (batch,) + tuple(input_shapes["data"][1:])
    net.init(jax.random.PRNGKey(0), {"data": shape})
    configs = {}
    for layer in net.layers:
        if layer.spec.type not in ("Convolution", "ConvolutionReLU"):
            continue
        in_shape = net.blob_shapes[layer.spec.bottoms[0]]
        p = layer.p
        k = p.get("kernel", 3)
        key = (in_shape[1], in_shape[2], in_shape[3], p["num_output"],
               k, p.get("stride", 1), p.get("pad", 0), p.get("group", 1))
        configs[key] = configs.get(key, 0) + 1
    return configs


def run_per_layer(args):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax import lax

    from caffe_escoin_tpu.engine.context import ExecutionPolicy
    from caffe_escoin_tpu.ops import conv as conv_ops
    from caffe_escoin_tpu.sparse.weight_align import weight_align
    from caffe_escoin_tpu.utils.benchmark import device_time
    from caffe_escoin_tpu.utils.pruning import prune_conv_weight

    configs = conv_configs(args.model, args.batch)
    # sparse-eligible: stride 1, cin >= 64 (conv1's 3-channel input is dense
    # in both frameworks)
    eligible = {k: c for k, c in configs.items()
                if k[5] == 1 and k[2] >= 64}
    skipped = {k: c for k, c in configs.items() if k not in eligible}
    log(f"conv configs: {len(configs)} unique; eligible {len(eligible)}, "
        f"dense-in-both {len(skipped)}")

    def flops_of(key, count):
        h, w, cin, cout, k, s_, p_, g_ = key
        return count * 2 * h * w * cin * cout * k * k / (s_ * s_) / g_

    items = sorted(eligible.items(), key=lambda kv: -flops_of(*kv))
    if args.smoke:
        items = items[:2]
    elif args.layers:
        items = items[: args.layers]
    cover = sum(flops_of(*kv) for kv in items) / max(
        1, sum(flops_of(*kv) for kv in eligible.items()))
    log(f"measuring {len(items)} configs covering {cover:.0%} of eligible "
        f"conv FLOPs ({args.granularity} pruning @ "
        f"{args.sparsity:.0%})")

    rng = np.random.default_rng(0)
    policy = ExecutionPolicy(block_shape=(128, 128),
                             autotune=args.autotune,
                             compute_dtype=jnp.bfloat16, cast_back=False,
                             xbsp_arm=args.xbsp_arm)
    block = (128, 128) if args.granularity == "block" else None
    rows = []
    tot = {"f32": 0.0, "bf16": 0.0, "sp": 0.0}
    total_nnz_work = 0.0
    for (h, w, cin, cout, k, s, p, g), count in items:
        # 4 distinct input buffers, cycled across timing iterations:
        # repeating one module on one buffer set leaves operands resident in
        # L2 across executions, under-reporting memory-bound layers (see
        # utils/benchmark.device_time). A layer inside a real net reads its
        # input cold — the rest of the network evicts it between uses.
        xvars = [jnp.asarray(
            rng.standard_normal((args.batch, h, w, cin)).astype(np.float32)
            * 0.1) for _ in range(4)]
        x = xvars[0]
        wt = rng.standard_normal((k, k, cin // g, cout)).astype(
            np.float32) * 0.05
        wp = prune_conv_weight(wt, args.sparsity, block)
        aligned = weight_align(wp, None, groups=g, policy=policy)
        wj = jnp.asarray(wp)
        wb = wj.astype(jnp.bfloat16)
        xb = x.astype(jnp.bfloat16)
        xbvars = [(xv.astype(jnp.bfloat16),) for xv in xvars]
        xfvars = [(xv,) for xv in xvars]
        pad = (p, p)

        def dense_f32(y):
            return lax.conv_general_dilated(
                y, wj, (s, s), [pad, pad],
                dimension_numbers=("NHWC", "HWIO", "NHWC"),
                feature_group_count=g)

        def dense_bf16(y):
            return lax.conv_general_dilated(
                y, wb, (s, s), [pad, pad],
                dimension_numbers=("NHWC", "HWIO", "NHWC"),
                feature_group_count=g)

        def sparse(y):
            return conv_ops.conv2d_sconv(y, aligned, stride=(s, s),
                                         padding=pad, dilation=(1, 1),
                                         relu=False, policy=policy,
                                         batch_parallel=True)

        if aligned.bsc is None:
            log(f"  {h}x{w} {cin}->{cout} k{k}: below sparse threshold, "
                f"dense in both — skipping")
            continue

        # correctness guard (bf16 activations vs f32 oracle -> bf16-scale
        # tolerance; XLA's own default-precision dense shows the same error
        # magnitude vs a highest-precision reference)
        err = float(jnp.max(jnp.abs(
            sparse(xb).astype(jnp.float32) - dense_f32(x))))
        reps = max(args.repeats, 8)
        tf = device_time(dense_f32, x, iters=reps, arg_sets=xfvars)
        tb = device_time(dense_bf16, xb, iters=reps, arg_sets=xbvars)
        ts = device_time(sparse, xb, iters=reps, arg_sets=xbvars)
        flops = 2 * args.batch * h * w * cin * cout * k * k / (s * s)
        nnz = aligned.stats.nnz
        out_pix = args.batch * (h // s) * (w // s)
        # roofline: ideal-traffic bound for this layer
        bound = 0.0
        if aligned.bsc is not None:
            import jax as _jax
            bcol_nnz = np.asarray(_jax.device_get(aligned.bsc.bcol_nnz))
            bk_, bn_ = aligned.bsc.block_shape
            bound = roofline_us(args.batch, h, w, cin, h // s, w // s, cout,
                                int(bcol_nnz.sum()), bk_, bn_)
        variant = ("nopad" if os.environ.get("CESCOIN_XBSP_NOPAD")
                   else None)
        rows.append(dict(h=h, w=w, cin=cin, cout=cout, k=k, count=count,
                         **({"xbsp_arm": args.xbsp_arm}
                            if args.xbsp_arm != "auto" else {}),
                         **({"variant": variant} if variant else {}),
                         t_dense_f32_us=round(tf * 1e6, 2),
                         t_dense_bf16_us=round(tb * 1e6, 2),
                         t_sparse_us=round(ts * 1e6, 2),
                         speedup_vs_f32=round(tf / ts, 3),
                         speedup_vs_bf16=round(tb / ts, 3),
                         bound_us=round(bound, 2),
                         x_of_bound=round(ts * 1e6 / bound, 2) if bound else 0,
                         err=err, sparsity=args.sparsity,
                         granularity=args.granularity, model=args.model,
                         batch=args.batch, flops=flops, nnz=nnz))
        tot["f32"] += tf * count
        tot["bf16"] += tb * count
        tot["sp"] += ts * count
        total_nnz_work += nnz * out_pix * count
        log(f"  {h:3d}x{w:3d} {cin:4d}->{cout:4d} k{k} x{count}: "
            f"f32 {tf*1e6:7.1f}us bf16 {tb*1e6:7.1f}us "
            f"sparse {ts*1e6:7.1f}us  vs_f32 {tf/ts:5.2f}x "
            f"vs_bf16 {tb/ts:5.2f}x bound {bound:6.1f}us "
            f"({ts*1e6/max(bound,1e-9):4.2f}x of SoL) err {err:.1e}")

    gran = "" if args.granularity == "block" else "_unstructured"
    metric = (f"{args.model}_sparse_conv_speedup_"
              f"{int(round(args.sparsity * 100))}{gran}")
    if not rows or tot["sp"] <= 0:
        emit({"metric": metric, "value": 0.0, "unit": "x",
              "vs_baseline": 0.0})
        return
    if args.jsonl:
        with open(args.jsonl, "a") as f:
            for r in rows:
                f.write(json.dumps({**r, **device_info()}) + "\n")

    sp_bf16 = tot["bf16"] / tot["sp"]
    sp_f32 = tot["f32"] / tot["sp"]
    gnnz_s = total_nnz_work / tot["sp"] / 1e9
    log(f"TOTAL: f32 {tot['f32']*1e3:.2f}ms bf16 {tot['bf16']*1e3:.2f}ms "
        f"sparse {tot['sp']*1e3:.2f}ms -> vs_f32 {sp_f32:.2f}x "
        f"vs_bf16 {sp_bf16:.2f}x ({gnnz_s:.1f} Gnnz/s)")
    headline = {
        "metric": metric,
        "value": round(sp_bf16, 3),
        "unit": "x_vs_dense_bf16_xla_conv",
        "batch": args.batch,
        "vs_baseline": round(sp_bf16 / 2.0, 3),
        "speedup_vs_dense_f32": round(sp_f32, 3),
        "gnnz_per_s": round(gnnz_s, 1),
        "autotune": bool(args.autotune),
    }
    emit(headline, args.jsonl)


def run_fc(args):
    """Sparse FC microbench: the model's InnerProduct shapes (e.g. VGG-16
    fc6/fc7, the fc bucket the reference reported first-class) — dense
    f32/bf16 matmul vs the XBSP SpMM on block-pruned weights."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from caffe_escoin_tpu.kernels import xla_block_sparse as xbs
    from caffe_escoin_tpu.models import ZOO
    from caffe_escoin_tpu.nn import Net
    from caffe_escoin_tpu.sparse.formats import dense_to_bsc
    from caffe_escoin_tpu.utils.benchmark import (device_time,
                                                  device_time_cycle)
    from caffe_escoin_tpu.utils.pruning import prune_blocks

    builder, input_shapes = ZOO[args.model]
    net = Net(builder())
    shape = (args.batch,) + tuple(input_shapes["data"][1:])
    net.init(jax.random.PRNGKey(0), {"data": shape})
    fcs = []
    for layer in net.layers:
        if layer.spec.type != "InnerProduct":
            continue
        k = int(np.prod(net.blob_shapes[layer.spec.bottoms[0]][1:]))
        m = layer.p["num_output"]
        if m < 128 or k < 256:
            continue  # classifier heads stay dense
        fcs.append((layer.spec.name, k, m))
    log(f"fc configs: {fcs}")
    rng = np.random.default_rng(0)
    rows = []
    tot = {"f32": 0.0, "bf16": 0.0, "sp": 0.0}
    for name, k, m in fcs:
        # 4 independent (input, weight) replicas, cycled during timing:
        # with ONE replica a weight that fits in L2 stays warm across
        # repeated identical executions and the dense baseline beats its
        # device-memory roofline (see utils/benchmark.device_time). Inside a
        # real VGG forward the fc weights are always cold: hundreds of MB of
        # activations and other layers' weights flow through device memory
        # between consecutive uses of any one matrix.
        wvars = [prune_blocks(
            rng.standard_normal((k, m)).astype(np.float32) * 0.02,
            args.sparsity, (128, 128)) for _ in range(4)]
        bscs = [dense_to_bsc(wv, (128, 128)) for wv in wvars]
        bsc = bscs[0]
        wjs = [jnp.asarray(wv) for wv in wvars]
        wbs = [w_.astype(jnp.bfloat16) for w_ in wjs]
        wj, wb = wjs[0], wbs[0]
        xvars = [jnp.asarray(
            rng.standard_normal((args.batch, k)).astype(np.float32) * 0.1)
            for _ in range(4)]
        x = xvars[0]
        xbvars = [xv.astype(jnp.bfloat16) for xv in xvars]
        xb = xbvars[0]
        # dense weights passed as ARGUMENTS (the dense deployment shape; a
        # closed-over 25088x4096 f32 matrix would be baked into the HLO as
        # a literal). The sparse arm still closes over its (10x smaller)
        # block payloads — pattern concreteness is what the XBSP unroll
        # needs — so it cycles four separately-jitted closures instead
        # (device_time_cycle).
        d32 = lambda y, w: jnp.dot(y, w)  # noqa: E731
        dbf = lambda y, w: jnp.dot(y, w)  # noqa: E731
        sp = lambda y: xbs.spmm(y, bsc)  # noqa: E731
        err = float(jnp.max(jnp.abs(sp(xb).astype(jnp.float32) - d32(x, wj))))
        reps = max(args.repeats, 8)
        tf = device_time(d32, x, wj, iters=reps,
                         arg_sets=list(zip(xvars, wjs)))
        tb = device_time(dbf, xb, wb, iters=reps,
                         arg_sets=list(zip(xbvars, wbs)))
        ts = device_time_cycle(
            [(lambda y, _b=b: xbs.spmm(y, _b), (xv,))
             for b, xv in zip(bscs, xbvars)], iters=reps)
        tot["f32"] += tf
        tot["bf16"] += tb
        tot["sp"] += ts
        rows.append(dict(layer=name, k=k, m=m, model=args.model,
                         batch=args.batch, sparsity=args.sparsity,
                         t_dense_f32_us=round(tf * 1e6, 2),
                         t_dense_bf16_us=round(tb * 1e6, 2),
                         t_sparse_us=round(ts * 1e6, 2),
                         speedup_vs_f32=round(tf / ts, 3),
                         speedup_vs_bf16=round(tb / ts, 3), err=err,
                         kind="fc"))
        log(f"  {name} {k}x{m}: f32 {tf*1e6:7.1f}us bf16 {tb*1e6:7.1f}us "
            f"sparse {ts*1e6:7.1f}us vs_f32 {tf/ts:5.2f}x "
            f"vs_bf16 {tb/ts:5.2f}x err {err:.1e}")
    if args.jsonl:
        with open(args.jsonl, "a") as f:
            for r in rows:
                f.write(json.dumps({**r, **device_info()}) + "\n")
    if not rows or tot["sp"] <= 0:
        emit({"metric": f"{args.model}_sparse_fc", "value": 0.0,
              "unit": "x", "vs_baseline": 0.0})
        return
    headline = {
        "metric": (f"{args.model}_sparse_fc_speedup_"
                   f"{int(round(args.sparsity * 100))}"),
        "value": round(tot["bf16"] / tot["sp"], 3),
        "unit": "x_vs_dense_bf16_matmul",
        "batch": args.batch,
        "vs_baseline": round(tot["bf16"] / tot["sp"] / 2.0, 3),
        "speedup_vs_dense_f32": round(tot["f32"] / tot["sp"], 3),
    }
    emit(headline, args.jsonl)


def run_e2e(args):
    import numpy as np
    import jax
    import jax.numpy as jnp

    from caffe_escoin_tpu.engine.context import ConvMode, ExecutionPolicy
    from caffe_escoin_tpu.models import ZOO
    from caffe_escoin_tpu.nn import Net
    from caffe_escoin_tpu.utils.benchmark import device_time
    from caffe_escoin_tpu.utils.pruning import prune_net_params

    from caffe_escoin_tpu.nn.fuse import fuse_inference

    builder, input_shapes = ZOO[args.model]
    block = (128, 128) if args.granularity == "block" else None

    pol_dense = ExecutionPolicy()
    pol_dense_bf16 = ExecutionPolicy(compute_dtype=jnp.bfloat16,
                                     cast_back=False)
    pol_sparse = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR,
                                 block_shape=(128, 128),
                                 compute_dtype=jnp.bfloat16,
                                 cast_back=False,
                                 autotune=args.autotune,
                                 xbsp_arm=args.xbsp_arm)
    net_d = Net(builder(), policy=pol_dense, phase="test")
    net_db = Net(builder(), policy=pol_dense_bf16, phase="test")
    net_s = Net(builder(), policy=pol_sparse, phase="test")
    shapes = {"data": (args.batch,) + tuple(input_shapes["data"][1:])}
    # one init: all three nets share the same weights (Net.apply falls back
    # to fresh per-layer buffers for the uninitialized nets' state)
    params = net_d.init(jax.random.PRNGKey(0), shapes)
    state = net_d.state0

    # prune conv AND fc weights (the fc bucket matters for AlexNet/VGG —
    # `tools/caffe.cpp:338-367` reports it first-class); the stem conv over
    # the image stays dense in every arm
    pruned = prune_net_params(net_s, params, args.sparsity, block)

    # Inference graph fusion (nn/fuse.py): fold BN/Scale into conv weights,
    # fuse ReLU + residual adds into the conv epilogue. Applied to ALL
    # THREE arms — it is a framework inference capability, so the reported
    # sparse speedup isolates sparsity, not fusion (the honest comparison;
    # the reference ran the same unfused graph in all its arms too).
    if args.fuse:
        net_d, params_d = fuse_inference(net_d, params, state=state)
        net_db, params_db = fuse_inference(net_db, params, state=state)
        net_s.blob_shapes = dict(net_d.blob_shapes)  # same graph/shapes
        net_s, pruned_s = fuse_inference(net_s, pruned, state=state)
        n_before = len(builder())
        log(f"fusion: {n_before} -> {len(net_s.layers)} layers")
        use_s2d = (args.model in ("googlenet",)
                   if args.s2d is None else args.s2d)
        if use_s2d:
            # space-to-depth stem fold (nn/fuse.fold_stem_s2d): on by
            # default for googlenet only, pending a composed A/B on this
            # device. Sparse deployment arm only; dense baselines stay
            # stock XLA convs.
            from caffe_escoin_tpu.nn.fuse import fold_stem_s2d
            net_s, pruned_s = fold_stem_s2d(net_s, pruned_s)
            log("stem s2d fold applied (sparse arm)")
        if args.pack:
            # W-pair packed layout for narrow-channel towers (nn/fuse.py
            # pack_narrow_chains; ops/wpack.py): a framework graph
            # transform applied to the SPARSE deployment arm. The dense
            # baselines stay stock XLA convs — the honest external
            # baseline is what a user gets from XLA, not this framework's
            # layout pass run densely; --no-pack captures the
            # decomposition (sparsity-only vs sparsity+layout).
            from caffe_escoin_tpu.nn.fuse import pack_narrow_chains
            net_s = pack_narrow_chains(net_s)
            if getattr(net_s, "packed_blobs", None):
                log(f"packed {len(net_s.packed_blobs)} blobs "
                    f"(W-pair layout): {sorted(net_s.packed_blobs)[:6]}...")
    else:
        params_d, params_db, pruned_s = params, params, pruned

    aligned = net_s.weight_align(pruned_s)
    # 4 distinct inputs cycled per arm (warm-cache hazard, see
    # utils/benchmark.device_time): weights legitimately stay device-warm
    # in a dedicated serving loop, but each batch's INPUT is new.
    _rng_x = np.random.default_rng(0)
    xvars = [jnp.asarray(_rng_x.standard_normal(
        shapes["data"]).astype(np.float32) * 0.1) for _ in range(4)]
    x = xvars[0]

    # dense arms take params as a jit ARGUMENT (the standard dense
    # deployment shape; also keeps VGG-scale f32 weights out of the
    # HLO). The sparse arm closes over its aligned weights: trace-time
    # pattern concreteness is what enables XBSP, and only the (pruned)
    # payloads it actually reads reach the HLO.
    # params on the device once: host arrays would be re-uploaded by every
    # timed call
    params_d, params_db = jax.device_put((params_d, params_db))
    fwd_d = jax.jit(lambda p, i: net_d.apply(p, i))
    fwd_db = jax.jit(lambda p, i: net_db.apply(p, i))
    fwd_s = net_s.inference_fn(aligned,
                               weights_as_args=args.weights_as_args)

    def first(out):
        return out[next(iter(out))]

    reps = max(args.repeats, 8)

    calib_report = None
    if args.calibrate and args.autotune:
        # graph-level validation of the per-layer autotuned picks: A/B the
        # composed whole-net over candidate arm assignments, with the
        # all-dense assignment as the graph-scope never-lose floor
        # (engine/autotune.calibrate_graph; the GoogLeNet composition fix)
        from caffe_escoin_tpu.engine import autotune as _autotune

        def _time_sparse():
            with _autotune.net_scope(args.model):
                fn = net_s.inference_fn(
                    aligned, weights_as_args=args.weights_as_args)
                return device_time(lambda y: first(fn({"data": y})), x,
                                   iters=reps,
                                   arg_sets=[(xv,) for xv in xvars])

        calib_report = _autotune.calibrate_graph(
            _time_sparse, polish=args.calibrate_polish,
            net_tag=args.model, log=log)
        fwd_s = net_s.inference_fn(aligned,
                                   weights_as_args=args.weights_as_args)
    # the f32 arm at HIGHEST precision: XLA's default would run its convs
    # and matmuls in TF32 on the GPU, which is not a float32 baseline
    with jax.default_matmul_precision("highest"):
        td = device_time(lambda p, y: first(fwd_d(p, {"data": y})),
                         params_d, x, iters=reps,
                         arg_sets=[(params_d, xv) for xv in xvars])
    tdb = device_time(lambda p, y: first(fwd_db(p, {"data": y})), params_db,
                      x, iters=reps,
                      arg_sets=[(params_db, xv) for xv in xvars])
    # the sparse trace consults the autotune cache: serve this net's
    # calibrated (net-scoped) assignment when one was persisted
    from caffe_escoin_tpu.engine import autotune as _at_scope
    with _at_scope.net_scope(args.model):
        ts = device_time(lambda y: first(fwd_s({"data": y})), x,
                         iters=reps, arg_sets=[(xv,) for xv in xvars])
    log(f"e2e {args.model} batch {args.batch}: dense-f32 {td*1e3:.2f}ms "
        f"dense-bf16 {tdb*1e3:.2f}ms sparse {ts*1e3:.2f}ms "
        f"-> vs_f32 {td/ts:.2f}x vs_bf16 {tdb/ts:.2f}x")

    # conv/fc/other bucket split (reference `net.cpp:516-565`): per-layer
    # isolated device timing over real blob shapes. Per-layer jits carry
    # per-dispatch overhead the fused whole-net jit doesn't, so the raw
    # layerwise sum exceeds the e2e total; buckets are reported as the
    # layerwise ms AND normalized shares of the e2e total (the reference's
    # buckets summed to its total because its total WAS the layer sum,
    # `net.cpp:516-565`).
    buckets = {}
    if args.buckets:
        from caffe_escoin_tpu.utils.timing import time_net_layerwise
        rep_s = time_net_layerwise(net_s, aligned, {"data": x}, iters=3)
        rep_d = time_net_layerwise(net_d, params_d, {"data": x}, iters=3)
        for name, rep, e2e_ms in (("sparse", rep_s, ts * 1e3),
                                  ("dense", rep_d, td * 1e3)):
            cats = rep["categories"]
            lsum = max(sum(cats.values()), 1e-9)
            buckets[name] = {
                "layerwise_ms": {k: round(v, 3) for k, v in cats.items()},
                "layerwise_sum_ms": round(lsum, 3),
                "e2e_ms": round(e2e_ms, 3),
                # shares of the whole-jit e2e total, attributed by the
                # layerwise proportions — these sum to the e2e total
                "of_e2e_ms": {k: round(v / lsum * e2e_ms, 3)
                              for k, v in cats.items()},
            }
            log(f"  {name} buckets: {buckets[name]}")

    gran = "" if args.granularity == "block" else "_unstructured"
    result = {
        "metric": (f"{args.model}_e2e_speedup_"
                   f"{int(round(args.sparsity * 100))}{gran}"),
        "value": round(tdb / ts, 3),
        "unit": "x_vs_dense_bf16_e2e",
        "batch": args.batch,
        "vs_baseline": round((tdb / ts) / 2.0, 3),
        "speedup_vs_dense_f32": round(td / ts, 3),
        "t_dense_f32_ms": round(td * 1e3, 3),
        "t_dense_bf16_ms": round(tdb * 1e3, 3),
        "t_sparse_ms": round(ts * 1e3, 3),
        "fused": bool(args.fuse),
        "autotune": bool(args.autotune),
        "packed": bool(args.pack and args.fuse),
        "s2d": bool(args.fuse and (args.model in ("googlenet",)
                                   if args.s2d is None else args.s2d)),
        "weights_as_args": bool(args.weights_as_args),
    }
    if args.xbsp_arm != "auto":
        # diagnostic rows (forced executor arm) must be distinguishable
        # from headline rows in the sweep record
        result["xbsp_arm"] = args.xbsp_arm
    if calib_report is not None:
        result["calibrated"] = True
        result["calibration"] = {
            k: (round(v, 6) if isinstance(v, float) else v)
            for k, v in calib_report.items() if k != "arms"}
    if buckets:
        result["buckets"] = buckets
    emit(result, args.jsonl)


def run_halo(args):
    """Single-device halo-path overhead: spatial_sconv2d on a mesh of ONE
    device vs the plain XBSP dispatcher on identical shapes. On one device
    the shard_map + halo-edge cost is isolated — the reference's analogue
    (copy_input_data padding, `math_functions.cu:729-766`) was in-kernel
    and free, so the halo must be shown near-free too."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from caffe_escoin_tpu.engine.context import ExecutionPolicy
    from caffe_escoin_tpu.ops import conv as conv_ops
    from caffe_escoin_tpu.parallel import halo, mesh as mesh_lib
    from caffe_escoin_tpu.sparse.weight_align import weight_align
    from caffe_escoin_tpu.utils.benchmark import device_time
    from caffe_escoin_tpu.utils.pruning import prune_conv_weight

    mesh = mesh_lib.make_mesh(data=1, model=1,
                              devices=jax.devices()[:1])
    pol = ExecutionPolicy(block_shape=(128, 128),
                          compute_dtype=jnp.bfloat16, cast_back=False)
    shapes = [(56, 64, 64), (28, 128, 128), (14, 256, 256), (7, 512, 512)]
    rng = np.random.default_rng(0)
    rows = []
    for hw, cin, cout in shapes:
        w = prune_conv_weight(
            rng.standard_normal((3, 3, cin, cout)).astype(np.float32),
            args.sparsity, (128, 128))
        aligned = weight_align(jnp.asarray(w), None, policy=pol)
        xs = [jnp.asarray(rng.standard_normal(
            (args.batch, hw, hw, cin)).astype(np.float32) * 0.1)
            .astype(jnp.bfloat16) for _ in range(4)]
        x = xs[0]

        plain = jax.jit(lambda y: conv_ops.conv2d_sconv(
            y, aligned, stride=(1, 1), padding=(1, 1), dilation=(1, 1),
            policy=pol, relu=False, batch_parallel=True))
        haloed = jax.jit(lambda y: halo.spatial_sconv2d(
            y, aligned, mesh=mesh, padding=(1, 1), policy=pol))
        err = float(jnp.max(jnp.abs(
            plain(x).astype(jnp.float32) - haloed(x).astype(jnp.float32))))
        reps = max(args.repeats, 8)
        tp = device_time(plain, x, iters=reps,
                         arg_sets=[(xv,) for xv in xs])
        th = device_time(haloed, x, iters=reps,
                         arg_sets=[(xv,) for xv in xs])
        over = th / tp - 1.0
        log(f"halo 1-dev {hw}x{hw} {cin}->{cout}: plain {tp*1e6:7.1f}us "
            f"halo {th*1e6:7.1f}us overhead {over*100:+.1f}% err {err:.1e}")
        rows.append({"metric": "halo_overhead_1dev", "h": hw, "w": hw,
                     "cin": cin, "cout": cout, "batch": args.batch,
                     "sparsity": args.sparsity,
                     "t_plain_us": round(tp * 1e6, 2),
                     "t_halo_us": round(th * 1e6, 2),
                     "overhead": round(over, 4), "err": err,
                     **device_info()})
    # deep-halo tower amortization: a 3x k3 chain under ONE shard_map +
    # ONE exchange (parallel/halo.spatial_sconv_tower) vs the plain chain
    # and vs per-layer halo calls: the fixed per-call edge is paid once
    # per chain.
    for hw, cin, cout in shapes:
        if cin != cout:
            continue
        ws = [prune_conv_weight(
            rng.standard_normal((3, 3, cin, cout)).astype(np.float32),
            args.sparsity, (128, 128)) for _ in range(3)]
        als = [weight_align(jnp.asarray(w), None, policy=pol) for w in ws]
        xs = [jnp.asarray(rng.standard_normal(
            (args.batch, hw, hw, cin)).astype(np.float32) * 0.1)
            .astype(jnp.bfloat16) for _ in range(4)]
        x = xs[0]

        def chain_plain(y):
            for a in als:
                y = conv_ops.conv2d_sconv(
                    y, a, stride=(1, 1), padding=(1, 1), dilation=(1, 1),
                    policy=pol, relu=True, batch_parallel=True)
            return y

        def chain_perlayer(y):
            for a in als:
                y = halo.spatial_sconv2d(y, a, mesh=mesh, padding=(1, 1),
                                         policy=pol, relu=True)
            return y

        def chain_tower(y):
            return halo.spatial_sconv_tower(y, als, mesh=mesh, policy=pol,
                                            relu=True)

        def chain_one(y):
            # ONE shard_map entry, per-layer exchanges, exact compute
            # (parallel/halo.spatial_sconv_chain)
            return halo.spatial_sconv_chain(y, als, mesh=mesh, policy=pol,
                                            relu=True)

        err = float(jnp.max(jnp.abs(
            jax.jit(chain_plain)(x).astype(jnp.float32)
            - jax.jit(chain_tower)(x).astype(jnp.float32))))
        err_c = float(jnp.max(jnp.abs(
            jax.jit(chain_plain)(x).astype(jnp.float32)
            - jax.jit(chain_one)(x).astype(jnp.float32))))
        reps = max(args.repeats, 8)
        tp = device_time(chain_plain, x, iters=reps,
                         arg_sets=[(xv,) for xv in xs])
        tl = device_time(chain_perlayer, x, iters=reps,
                         arg_sets=[(xv,) for xv in xs])
        tt = device_time(chain_tower, x, iters=reps,
                         arg_sets=[(xv,) for xv in xs])
        tc = device_time(chain_one, x, iters=reps,
                         arg_sets=[(xv,) for xv in xs])
        log(f"halo tower {hw}x{hw} {cin}: plain {tp*1e6:7.1f}us "
            f"per-layer {tl*1e6:7.1f}us ({tl/tp-1:+.1%}) tower "
            f"{tt*1e6:7.1f}us ({tt/tp-1:+.1%}) one-entry "
            f"{tc*1e6:7.1f}us ({tc/tp-1:+.1%}) err {err:.1e}/{err_c:.1e}")
        rows.append({"metric": "halo_tower_overhead_1dev", "h": hw,
                     "w": hw, "cin": cin, "layers": 3,
                     "batch": args.batch, "sparsity": args.sparsity,
                     "t_plain_us": round(tp * 1e6, 2),
                     "t_perlayer_us": round(tl * 1e6, 2),
                     "t_tower_us": round(tt * 1e6, 2),
                     "t_chain_us": round(tc * 1e6, 2),
                     "overhead_perlayer": round(tl / tp - 1.0, 4),
                     "overhead_chain": round(tc / tp - 1.0, 4),
                     "overhead": round(tt / tp - 1.0, 4), "err": err,
                     "err_chain": err_c, **device_info()})

    # headline: worst-over-shapes of the BEST available execution per map
    # size (per-layer calls, the one-entry chain or the deep-halo tower,
    # whichever a deployment would pick for that map).
    best_by_shape = {}
    for r in rows:
        key = (r["h"], r["cin"])
        ov = r.get("overhead_perlayer", r["overhead"])
        ov = min(ov, r["overhead"], r.get("overhead_chain", ov))
        cur = best_by_shape.get(key)
        best_by_shape[key] = ov if cur is None else min(cur, ov)
    worst = max(best_by_shape.values())
    headline = {"metric": "halo_overhead_1dev_worst",
                "value": round(worst, 4), "unit": "fractional_overhead",
                "vs_baseline": 1.0 if worst < 0.10 else 0.0,
                "rows": len(rows)}
    if args.jsonl:
        with open(args.jsonl, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    emit(headline, args.jsonl)


def run_batch_curve(args):
    """Single-device throughput vs batch size for the fused sparse net —
    the saturation evidence for the per-device batches the scaling
    harness uses (virtual-mesh efficiencies measure host contention, not
    scaling; this curve is the single-device half of the argument)."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from caffe_escoin_tpu.engine.context import ConvMode, ExecutionPolicy
    from caffe_escoin_tpu.models import ZOO
    from caffe_escoin_tpu.nn import Net
    from caffe_escoin_tpu.nn.fuse import deploy_sparse
    from caffe_escoin_tpu.utils.benchmark import device_time
    from caffe_escoin_tpu.utils.pruning import prune_net_params

    builder, input_shapes = ZOO[args.model]
    pol = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR,
                          block_shape=(128, 128),
                          compute_dtype=jnp.bfloat16, cast_back=False,
                          autotune=args.autotune)
    rows = []
    best = 0.0
    for batch in (1, 2, 4, 8, 16, 32, 64):
        net = Net(builder(), policy=pol, phase="test")
        shapes = {"data": (batch,) + tuple(input_shapes["data"][1:])}
        params = net.init(jax.random.PRNGKey(0), shapes)
        pruned = prune_net_params(net, params, args.sparsity, (128, 128))
        fnet, aligned = deploy_sparse(net, pruned, pack=args.pack)
        fwd = fnet.inference_fn(aligned)
        _rx = np.random.default_rng(0)
        xvars = [jnp.asarray(_rx.standard_normal(
            shapes["data"]).astype(np.float32) * 0.1) for _ in range(4)]
        x = xvars[0]
        key = next(iter(fwd({"data": x})))
        t = device_time(lambda y: fwd({"data": y})[key], x,
                        iters=max(args.repeats, 8),
                        arg_sets=[(xv,) for xv in xvars])
        ips = batch / t
        best = max(best, ips)
        rows.append(dict(kind="batch_curve", model=args.model, batch=batch,
                         t_ms=round(t * 1e3, 3),
                         images_per_s=round(ips, 1),
                         sparsity=args.sparsity))
        log(f"  batch {batch:3d}: {t*1e3:7.3f} ms  {ips:9.1f} img/s")
    if args.jsonl:
        with open(args.jsonl, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    sat = rows[-1]["images_per_s"] / best if best else 0.0
    emit({
        "metric": f"{args.model}_sparse_batch_curve_peak",
        "value": round(best, 1), "unit": "images_per_s",
        "vs_baseline": round(sat, 3),
        "rows": [[r["batch"], r["images_per_s"]] for r in rows],
    })


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="2 shapes, quick")
    ap.add_argument("--model", default="resnet50",
                    help="any ZOO model (resnet50 is the headline config; "
                         "alexnet/googlenet/vgg16 for the BASELINE sweeps)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--sparsity", type=float, default=0.9)
    ap.add_argument("--layers", type=int, default=0,
                    help="measure top-N configs by FLOP share (0 = all)")
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--granularity", choices=["block", "unstructured"],
                    default="block")
    ap.add_argument("--e2e", action="store_true",
                    help="whole-net Net.inference_fn timing instead of "
                         "per-layer conv configs")
    ap.add_argument("--fc", action="store_true",
                    help="sparse FC microbench on the model's InnerProduct "
                         "shapes")
    ap.add_argument("--batch-curve", action="store_true",
                    help="single-device sparse throughput vs batch size")
    ap.add_argument("--halo", action="store_true",
                    help="single-device halo-path overhead: spatial_sconv2d "
                         "on a 1-device mesh vs plain XBSP")
    ap.add_argument("--buckets", action="store_true",
                    help="with --e2e: also report conv/fc/other bucket split")
    ap.add_argument("--fuse", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="with --e2e: apply inference graph fusion "
                         "(BN/Scale fold + ReLU/residual epilogues) to all "
                         "arms (default on; --no-fuse for the raw graph)")
    ap.add_argument("--weights-as-args", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="sparse net payloads as jit arguments instead of "
                    "closed-over constants (pattern stays concrete; "
                    "sparse.weight_align.split_payloads)")
    ap.add_argument("--pack", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="W-pair packed layout for narrow-channel towers "
                    "(sparse arm; nn/fuse.pack_narrow_chains)")
    ap.add_argument("--s2d", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="space-to-depth stem-conv fold (sparse arm; "
                    "nn/fuse.fold_stem_s2d). Default: on for models whose "
                    "composed capture wins (googlenet), off otherwise")
    ap.add_argument("--autotune", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="measured per-shape executor selection with a "
                         "dense never-lose floor (engine/autotune.py)")
    ap.add_argument("--jsonl", default="",
                    help="append per-layer measurement rows to this file")
    ap.add_argument("--xbsp-arm", default="auto",
                    choices=["auto", "unroll", "gathered", "gathered_cols",
                             "dense"],
                    help="force one XBSP executor arm in the sparse e2e "
                         "policy (diagnostic; 'dense' isolates dispatch/"
                         "graph overhead from arm choice)")
    ap.add_argument("--calibrate-polish", type=int, default=0,
                    help="with --calibrate: bounded search over alternative "
                         "arms for the highest-traffic keys after the "
                         "composed assignment is accepted (N trials)")
    ap.add_argument("--calibrate", action="store_true",
                    help="with --e2e --autotune: graph-level arm "
                         "calibration (A/B the composed net over candidate "
                         "assignments, dense floor included) before "
                         "measuring; winners persist to the autotune cache")
    ap.add_argument("--per-layer", action="store_true",
                    help="per-layer conv-config measurement (opt-in; the "
                         "no-flag default is the whole-net --e2e headline)")
    args = ap.parse_args()

    # no-flag default = the headline measurement: fused + autotuned
    # whole-net e2e on ResNet-50 at the reference's test batch 32
    # (`models/resnet/test_sconv.prototxt:40`). The per-layer conv-bucket
    # sweep stays available via --per-layer.
    if not (args.e2e or args.fc or args.batch_curve or args.per_layer
            or args.smoke or args.halo):
        args.e2e = True
        args.buckets = True
        if args.batch == ap.get_default("batch"):
            args.batch = 32
        args.repeats = max(args.repeats, 8)
        # the default (headline) invocation calibrates WITH a bounded
        # polish: isolated per-layer picks can lose composed, and polish
        # re-times alternative arms for the highest-traffic keys inside
        # the whole net. Cached arms make it cheap when the assignment
        # stands.
        if args.autotune and not args.calibrate:
            args.calibrate = True
            args.calibrate_polish = max(args.calibrate_polish, 8)

    from caffe_escoin_tpu.utils import runtime

    # measured-arm table: one fixed path in the checkout (gitignored), keyed
    # by device kind, so reruns on the same card reuse its measurements
    os.environ.setdefault("CESCOIN_AUTOTUNE_CACHE", runtime.AUTOTUNE_TABLE)
    # a cached arm served after a kernel change would silently skip
    # re-measurement — have autotune announce every cache hit so a
    # measurement run can tell cached picks from fresh ones
    os.environ.setdefault("CESCOIN_AUTOTUNE_LOG_HITS", "1")

    import jax

    # persistent compiled-executable cache: autotuning compiles 4 arms per
    # (shape, pattern); reruns hit the disk cache instead
    log(f"compile cache: {runtime.setup_compile_cache()}")
    log(f"backend: {jax.default_backend()}, devices: {jax.devices()}")
    if args.e2e:
        run_e2e(args)
    elif args.fc:
        run_fc(args)
    elif args.halo:
        run_halo(args)
    elif args.batch_curve:
        run_batch_curve(args)
    else:
        run_per_layer(args)


if __name__ == "__main__":
    main()

"""Command-line interface: the `caffe` binary equivalent.

Reference: `tools/caffe.cpp` (493 LoC): brew commands train / test / time /
device_query with gflags `-model -weights -solver -gpu -iterations
-conv_mode` (`tools/caffe.cpp:29-60`). Here models come from the zoo registry
(the prototxt role is played by the LayerSpec model builders) and weights from
.npz checkpoints; `-conv_mode {0,1,2,3}` maps to the same four modes.

Usage:
  python -m caffe_escoin_tpu.tools.cli device_query
  python -m caffe_escoin_tpu.tools.cli time  --model lenet --iterations 10
  python -m caffe_escoin_tpu.tools.cli test  --model resnet50 --conv_mode 2 \
      --weights snap.npz --sparsity 0.9 --iterations 4
  python -m caffe_escoin_tpu.tools.cli train --model lenet --solver sgd \
      --lr 0.01 --iterations 100 --snapshot-prefix /tmp/lenet
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from caffe_escoin_tpu.utils.runtime import PLATFORMS


def cmd_device_query(args):
    import jax

    print(f"backend: {jax.default_backend()}")
    for d in jax.devices():
        print(f"  device {d.id}: {d.device_kind} (process {d.process_index})")
    return 0


def _build_net(args, include_loss, phase):
    from caffe_escoin_tpu.engine.context import ConvMode, ExecutionPolicy
    from caffe_escoin_tpu.models import ZOO
    from caffe_escoin_tpu.nn import Net

    policy = ExecutionPolicy(
        conv_mode=ConvMode(args.conv_mode),
        block_shape=tuple(args.block_shape),
        sparse_threshold=args.sparse_threshold,
        sconv_threshold=args.sparse_threshold,
    )
    if args.model.endswith(".prototxt"):
        # reference NetParameter text config (`caffe train -model x.prototxt`)
        from caffe_escoin_tpu.tools.prototxt import load_net

        specs, shapes, name = load_net(args.model, phase=phase,
                                       batch=args.batch)
        print(f"loaded prototxt net {name!r} ({len(specs)} layers)")
        return Net(specs, policy=policy, phase=phase), shapes
    if args.model not in ZOO:
        sys.exit(f"unknown model {args.model!r}; available: {sorted(ZOO)} "
                 f"or a .prototxt path")
    builder, input_shapes = ZOO[args.model]
    specs = builder(num_classes=args.num_classes, include_loss=include_loss)
    net = Net(specs, policy=policy, phase=phase)
    shapes = dict(input_shapes)
    data_shape = (args.batch,) + shapes["data"][1:]
    shapes = {"data": data_shape}
    if include_loss:
        shapes["label"] = (args.batch,)
    return net, shapes


def _load_or_init(net, shapes, args):
    import jax

    params = net.init(jax.random.PRNGKey(args.seed), shapes)
    if args.weights and args.weights.endswith(".caffemodel"):
        # pretrained reference weights (binaryproto NetParameter)
        from caffe_escoin_tpu.tools.caffemodel import (assign_to_params,
                                                       batchnorm_state,
                                                       load_caffemodel)

        loaded = load_caffemodel(args.weights)
        params = assign_to_params(net, params, loaded)
        # BatchNorm moving stats go into the net's default state so every
        # downstream forward (inference_fn state=None) uses them
        for name, st in batchnorm_state(loaded).items():
            if name in getattr(net, "state0", {}):
                import jax.numpy as jnp

                net.state0[name] = {k: jnp.asarray(v)
                                    for k, v in st.items()}
        print(f"imported caffemodel weights from {args.weights}")
    elif args.weights:
        from caffe_escoin_tpu.engine.checkpoint import load_checkpoint_full
        import jax.numpy as jnp

        loaded, _, net_state, _ = load_checkpoint_full(
            args.weights.removesuffix(".npz"))
        # CopyTrainedLayersFrom semantics: match by layer name
        for name, p in loaded.items():
            if name in params:
                params[name] = jax.tree_util.tree_map(jnp.asarray, p)
        # trained BatchNorm moving stats must reach net.state0, exactly as
        # the .caffemodel branch above does — otherwise every downstream
        # consumer (export_caffemodel, test, time) runs inference with
        # init-zero mean/var and exports blobs[2]==0, which the reference
        # maps to scale 0 (silently wrong outputs)
        for name, st in (net_state or {}).items():
            if name in getattr(net, "state0", {}):
                net.state0[name] = jax.tree_util.tree_map(jnp.asarray, st)
        print(f"loaded weights from {args.weights}")
    return params


def _maybe_prune(net, params, args):
    if args.sparsity <= 0:
        return params
    import jax.numpy as jnp
    import numpy as np

    from caffe_escoin_tpu.utils.pruning import prune_conv_weight

    out = dict(params)
    bs = tuple(args.block_shape)
    for layer in net.layers:
        n = layer.spec.name
        if n in out and layer.spec.type in ("Convolution", "ConvolutionReLU"):
            w = np.asarray(out[n]["w"])
            if w.shape[2] * w.shape[0] * w.shape[1] < 32:
                continue  # skip tiny first layers (dense in reference too)
            q = dict(out[n])
            q["w"] = jnp.asarray(prune_conv_weight(w, args.sparsity, bs))
            out[n] = q
    print(f"pruned conv weights to {args.sparsity:.0%} block sparsity")
    return out


def cmd_test(args):
    """Scoring run with per-category timing — mirrors `caffe test` including
    the `[cxh] Total CONV time` style per-iteration report
    (`tools/caffe.cpp:311-367`)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from caffe_escoin_tpu.data.datasets import synthetic_source
    from caffe_escoin_tpu.utils.timing import format_report, time_net_layerwise

    net, shapes = _build_net(args, include_loss=False, phase="test")
    params = _load_or_init(net, shapes, args)
    params = _maybe_prune(net, params, args)
    if args.conv_mode != 0 and args.sparsity > 0:
        params = net.weight_align(params)
        print("weight_align: sparse artifacts compiled")
    src = synthetic_source(shapes["data"], num_classes=args.num_classes,
                           seed=args.seed)
    # weights closed over -> XBSP executor engages (see Net.inference_fn)
    fwd = net.inference_fn(params)
    total = 0.0
    for i in range(args.iterations):
        batch = {"data": jnp.asarray(src()["data"])}
        t0 = time.perf_counter()
        out = fwd(batch)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) * 1e3
        if i > 0:  # skip compile iteration
            total += dt
        print(f"iteration {i}: forward {dt:.2f} ms")
    n = max(1, args.iterations - 1)
    print(f"average forward (excl. compile): {total / n:.2f} ms")
    if args.layerwise:
        batch = {"data": jnp.asarray(src()["data"])}
        print(format_report(time_net_layerwise(net, params, batch, iters=3)))
    return 0


def cmd_time(args):
    """`caffe time`: per-layer forward AND backward timing
    (`tools/caffe.cpp:374-461` reports both columns; --no-backward for
    forward-only, matching `caffe time`'s default of timing both)."""
    import jax.numpy as jnp

    from caffe_escoin_tpu.data.datasets import synthetic_source
    from caffe_escoin_tpu.utils.timing import format_report, time_net_layerwise

    net, shapes = _build_net(args, include_loss=False, phase="test")
    params = _load_or_init(net, shapes, args)
    params = _maybe_prune(net, params, args)
    if args.conv_mode != 0 and args.sparsity > 0:
        params = net.weight_align(params)
    src = synthetic_source(shapes["data"], seed=args.seed)
    batch = {"data": jnp.asarray(src()["data"])}
    print(format_report(time_net_layerwise(net, params, batch,
                                           iters=args.iterations,
                                           backward=args.backward)))
    return 0


def cmd_train(args):
    from caffe_escoin_tpu.data.datasets import synthetic_source
    from caffe_escoin_tpu.data.pipeline import PrefetchLoader
    from caffe_escoin_tpu.engine.solver import Solver
    from caffe_escoin_tpu.engine.solvers import SolverConfig

    snapshot_prefix = args.snapshot_prefix
    snapshot_interval = args.snapshot_interval
    display = args.display
    if args.solver.endswith(".prototxt"):
        # reference SolverParameter text config (`caffe train -solver x`)
        from caffe_escoin_tpu.tools.prototxt import load_solver

        cfg, run = load_solver(args.solver)
        if run.get("net") and args.model == "lenet":
            # model not set explicitly: follow the solver's net field,
            # resolved relative to the solver file's directory (the
            # reference resolves relative to CWD; both are tried)
            cand = run["net"]
            if not os.path.exists(cand):
                cand = os.path.join(os.path.dirname(args.solver),
                                    os.path.basename(run["net"]))
            if os.path.exists(cand):
                args.model = cand
        if args.iterations:
            import dataclasses as _dc
            cfg = _dc.replace(cfg, max_iter=args.iterations)
        snapshot_prefix = run.get("snapshot_prefix") or snapshot_prefix
        snapshot_interval = run.get("snapshot") or snapshot_interval
        display = run.get("display") or display
        net, shapes = _build_net(args, include_loss=True, phase="train")
    else:
        net, shapes = _build_net(args, include_loss=True, phase="train")
        cfg = SolverConfig(
            solver_type=args.solver, base_lr=args.lr, momentum=args.momentum,
            weight_decay=args.weight_decay, lr_policy=args.lr_policy,
            gamma=args.gamma, step_size=args.step_size,
            max_iter=args.iterations,
        )
    solver = Solver(net, cfg, snapshot_prefix=snapshot_prefix,
                    snapshot_interval=snapshot_interval,
                    display=display)
    solver.init(shapes)
    solver.install_signal_handlers()
    if args.weights:
        solver.restore(args.weights.removesuffix(".npz"))
    src = synthetic_source(shapes["data"], num_classes=args.num_classes,
                           seed=args.seed)
    with PrefetchLoader(src, device_put=False) as loader:
        solver.solve(loader, args.iterations)
    print(f"done at iteration {solver.iter}")
    return 0


def cmd_export_caffemodel(args):
    """Export current weights (framework checkpoint or re-export of an
    imported .caffemodel) as a binary NetParameter — the reverse of
    `Net::CopyTrainedLayersFrom` (`src/caffe/net.cpp:910+` `Net::ToProto`),
    so nets trained here can be consumed by reference tooling."""
    from caffe_escoin_tpu.tools.caffemodel import save_caffemodel

    net, shapes = _build_net(args, phase="test", include_loss=False)
    params = _load_or_init(net, shapes, args)
    n = save_caffemodel(net, params, args.output,
                        state=getattr(net, "state0", None),
                        net_name=args.model)
    print(f"exported {n} weighted layers -> {args.output}")


def cmd_export_prototxt(args):
    """Export a model's LayerSpecs as NetParameter prototxt text — the
    reverse of prototxt ingestion (reference counterpart:
    `python/caffe/net_spec.py` to_proto + `tools/caffe.cpp` model IO).
    With --fuse, exports the inference-fused graph (BN/Scale folds, ReLU
    epilogues), so a fused net can be diffed against its original."""
    import jax

    from caffe_escoin_tpu.tools.prototxt import net_to_prototxt

    net, shapes = _build_net(args, phase="test", include_loss=False)
    if args.fuse:
        from caffe_escoin_tpu.nn.fuse import fuse_inference

        params = _load_or_init(net, shapes, args)
        net, _ = fuse_inference(net, params, state=getattr(net, "state0",
                                                           None))
    specs = [l.spec for l in net.layers]
    text = net_to_prototxt(specs, shapes, name=args.model,
                           compat=args.compat)
    with open(args.output, "w") as fh:
        fh.write(text)
    print(f"exported {len(specs)} layers -> {args.output} "
          f"(compat={args.compat})")


def cmd_convert_imageset(args):
    """`tools/convert_imageset.cpp`: '<path> <label>' list file -> record
    database. `--backend cerec` (default, the native format) or
    `--backend lmdb` (Datum records readable by reference tooling,
    data/lmdb_io.py)."""
    import numpy as np

    from caffe_escoin_tpu.data.datasets import write_cerec
    from caffe_escoin_tpu.nn.data_layers import _load_image

    root = args.root_folder
    with open(args.listfile) as f:
        entries = [ln.split() for ln in f if ln.strip()]
    if args.shuffle:
        import random

        random.Random(args.seed).shuffle(entries)
    imgs, labels = [], []
    for path, label in entries:
        imgs.append(_load_image(
            os.path.join(root, path), color=not args.gray,
            new_height=args.resize_height, new_width=args.resize_width))
        labels.append(float(label))
    if getattr(args, "backend", "cerec") == "lmdb":
        from caffe_escoin_tpu.data.lmdb_io import datum_encode, write_lmdb

        items = [(b"%08d" % i, datum_encode(
            np.asarray(img), label=int(lb)))
            for i, (img, lb) in enumerate(zip(imgs, labels))]
        write_lmdb(args.output, items)
    else:
        write_cerec(args.output, np.stack(imgs),
                    np.asarray(labels, np.float32))
    print(f"wrote {len(imgs)} records to {args.output}")
    return 0


def cmd_compute_image_mean(args):
    """`tools/compute_image_mean.cpp`: .cerec -> per-pixel mean .npy."""
    import numpy as np

    from caffe_escoin_tpu.data.datasets import cerec_source, read_cerec_header

    header = read_cerec_header(args.source)
    n = header["num"]
    src = cerec_source(args.source, batch=min(64, n), loop=True)
    total = np.zeros(header["sample_shape"], np.float64)
    count = 0
    while count < n:
        batch = src()
        d = np.asarray(batch["data"], np.float64)[: n - count]
        total += d.sum(axis=0)
        count += len(d)
    mean = (total / max(1, count)).astype(np.float32)
    np.save(args.output, mean)
    print(f"mean over {count} images -> {args.output} "
          f"(channel means: {mean.mean(axis=(0, 1))})")
    return 0


def cmd_extract_features(args):
    """`tools/extract_features.cpp`: run the net forward and dump named
    blobs for each batch to an .npz archive."""
    import numpy as np

    import jax

    net, shapes = _build_net(args, include_loss=False, phase="test")
    params = _load_or_init(net, shapes, args)
    params = _maybe_prune(net, params, args)
    aligned = net.weight_align(params)
    blobs = args.blobs.split(",")
    feats = {b: [] for b in blobs}
    rng = np.random.default_rng(args.seed)
    fwd = jax.jit(lambda p, x: net.apply(p, {"data": x}, return_blobs=True))
    for _ in range(args.iterations):
        x = rng.standard_normal(shapes["data"]).astype(np.float32)
        outs = fwd(aligned, x)
        for b in blobs:
            feats[b].append(np.asarray(outs[b]))
    np.savez(args.output, **{b: np.concatenate(v) for b, v in feats.items()})
    print(f"extracted {blobs} x{args.iterations} batches -> {args.output}")
    return 0


def cmd_draw_net(args):
    """`python/draw_net.py`: model -> Graphviz DOT file."""
    from caffe_escoin_tpu.models import ZOO
    from caffe_escoin_tpu.tools.draw import draw_net_to_file

    if args.model not in ZOO:
        sys.exit(f"unknown model {args.model!r}; available: {sorted(ZOO)}")
    builder, _ = ZOO[args.model]
    draw_net_to_file(builder(), args.output, name=args.model,
                     rankdir=args.rankdir)
    print(f"wrote {args.output} (render: dot -Tpng {args.output})")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="caffe-escoin-tpu")
    sub = ap.add_subparsers(dest="command", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--model", default="lenet")
    common.add_argument("--batch", type=int, default=8)
    common.add_argument("--num-classes", type=int, default=10)
    common.add_argument("--weights", default="")
    common.add_argument("--conv_mode", type=int, default=0,
                        help="0=LOWERED_GEMM 1=LOWERED_SPARSE 2=SCONV 3=SCONV_PAR")
    common.add_argument("--sparsity", type=float, default=0.0)
    common.add_argument("--block-shape", type=int, nargs=2, default=[128, 128])
    common.add_argument("--sparse-threshold", type=float, default=0.5)
    common.add_argument("--iterations", type=int, default=10)
    common.add_argument("--seed", type=int, default=0)
    common.add_argument("--platform", default="auto", choices=PLATFORMS,
                        help="pin the jax platform (auto: JAX's choice)")

    sub.add_parser("device_query", parents=[common]).set_defaults(
        fn=cmd_device_query)
    p_test = sub.add_parser("test", parents=[common])
    p_test.add_argument("--layerwise", action="store_true")
    p_test.set_defaults(fn=cmd_test)
    p_time = sub.add_parser("time", parents=[common])
    p_time.add_argument("--backward", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="also time per-layer backward (caffe time "
                             "reports both; --no-backward for forward-only)")
    p_time.set_defaults(fn=cmd_time)
    p_train = sub.add_parser("train", parents=[common])
    p_train.add_argument("--solver", default="sgd",
                         help="solver type (sgd|nesterov|adagrad|rmsprop|"
                              "adadelta|adam) or a solver .prototxt path")
    p_train.add_argument("--lr", type=float, default=0.01)
    p_train.add_argument("--momentum", type=float, default=0.9)
    p_train.add_argument("--weight-decay", type=float, default=0.0)
    p_train.add_argument("--lr-policy", default="fixed")
    p_train.add_argument("--gamma", type=float, default=0.1)
    p_train.add_argument("--step-size", type=int, default=100000)
    p_train.add_argument("--snapshot-prefix", default="snapshot")
    p_train.add_argument("--snapshot-interval", type=int, default=0)
    p_train.add_argument("--display", type=int, default=20)
    p_train.set_defaults(fn=cmd_train)

    p_expp = sub.add_parser("export_prototxt", parents=[common])
    p_expp.add_argument("--output", required=True,
                        help="NetParameter text output path")
    p_expp.add_argument("--fuse", action="store_true",
                        help="export the inference-fused graph")
    p_expp.add_argument("--compat", default="cescoin",
                        choices=["cescoin", "caffe"],
                        help="'caffe' drops framework-only params for "
                             "strict reference consumption")
    p_expp.set_defaults(fn=cmd_export_prototxt)

    p_exp = sub.add_parser("export_caffemodel", parents=[common])
    p_exp.add_argument("--output", required=True,
                       help="destination .caffemodel path")
    p_exp.set_defaults(fn=cmd_export_caffemodel)

    p_conv = sub.add_parser("convert_imageset")
    p_conv.add_argument("listfile")
    p_conv.add_argument("output")
    p_conv.add_argument("--root-folder", default="")
    p_conv.add_argument("--resize-height", type=int, default=0)
    p_conv.add_argument("--resize-width", type=int, default=0)
    p_conv.add_argument("--gray", action="store_true")
    p_conv.add_argument("--shuffle", action="store_true")
    p_conv.add_argument("--seed", type=int, default=0)
    p_conv.add_argument("--backend", choices=["cerec", "lmdb"],
                        default="cerec")
    p_conv.set_defaults(fn=cmd_convert_imageset)

    p_mean = sub.add_parser("compute_image_mean")
    p_mean.add_argument("source")
    p_mean.add_argument("output")
    p_mean.set_defaults(fn=cmd_compute_image_mean)

    p_ext = sub.add_parser("extract_features", parents=[common])
    p_ext.add_argument("--blobs", required=True,
                       help="comma-separated blob names to dump")
    p_ext.add_argument("--output", default="features.npz")
    p_ext.set_defaults(fn=cmd_extract_features)

    p_draw = sub.add_parser("draw_net")
    p_draw.add_argument("--model", default="lenet")
    p_draw.add_argument("--output", default="net.dot")
    p_draw.add_argument("--rankdir", default="LR")
    p_draw.set_defaults(fn=cmd_draw_net)

    args = ap.parse_args(argv)
    if hasattr(args, "platform"):
        from caffe_escoin_tpu.utils import runtime

        runtime.select_platform(args.platform)
        runtime.setup_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

"""Accuracy-parity harness: sparse modes vs dense forward on the same net.

The reference validated sparse kernels end-to-end by eyeballing top-1/top-5
of `caffe test` runs against dense (`run.sh:3-20`, SURVEY.md section 4) — no
tolerances. This tool makes that check quantitative: for each conv mode it
reports max |prob diff|, top-1 agreement rate, and top-5 overlap vs the
LOWERED_GEMM baseline on the same pruned weights.

  python -m caffe_escoin_tpu.tools.parity --model resnet50 --sparsity 0.9 \
      --batches 4 --platform cpu
"""

from __future__ import annotations

import argparse
import sys

from caffe_escoin_tpu.utils.runtime import PLATFORMS


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="lenet")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--num-classes", type=int, default=10)
    ap.add_argument("--sparsity", type=float, default=0.9)
    ap.add_argument("--block-shape", type=int, nargs=2, default=[128, 128])
    ap.add_argument("--platform", default="auto", choices=PLATFORMS,
                    help="pin the jax platform (auto: JAX's choice)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tol", type=float, default=1e-3,
                    help="max allowed |prob diff| (f32 accumulation-order "
                         "tolerance; reference defined none)")
    ap.add_argument("--weights", default="",
                    help="trained weights: a framework checkpoint (.npz "
                         "prefix) or a .caffemodel — parity on REAL "
                         "weights instead of random init (pass "
                         "--sparsity 0 if the checkpoint is already "
                         "pruned)")
    ap.add_argument("--fuse", action="store_true",
                    help="apply inference graph fusion (BN/Scale fold + "
                         "ReLU/residual epilogues) to every arm before "
                         "comparing — checks the deployed graph")
    args = ap.parse_args(argv)

    from caffe_escoin_tpu.utils import runtime

    runtime.select_platform(args.platform)
    runtime.setup_compile_cache()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from caffe_escoin_tpu.engine.context import ConvMode, ExecutionPolicy
    from caffe_escoin_tpu.models import ZOO
    from caffe_escoin_tpu.nn import Net
    from caffe_escoin_tpu.utils.pruning import prune_conv_weight

    builder, input_shapes = ZOO[args.model]
    data_shape = (args.batch,) + input_shapes["data"][1:]
    rng = np.random.default_rng(args.seed)

    def make_net(mode):
        policy = ExecutionPolicy(
            conv_mode=mode, block_shape=tuple(args.block_shape),
            interpret=jax.default_backend() == "cpu",
        )
        return Net(builder(num_classes=args.num_classes), policy=policy)

    base_net = make_net(ConvMode.LOWERED_GEMM)
    params = base_net.init(jax.random.PRNGKey(args.seed),
                           {"data": data_shape})
    state = {k: dict(v) for k, v in getattr(base_net, "state0", {}).items()}

    # trained weights: real-model parity instead of random init (the
    # check the reference ran as `caffe test` dense-vs-sparse, run.sh:3-20)
    if args.weights and args.weights.endswith(".caffemodel"):
        from caffe_escoin_tpu.tools.caffemodel import (assign_to_params,
                                                       batchnorm_state,
                                                       load_caffemodel)

        loaded = load_caffemodel(args.weights)
        params = assign_to_params(base_net, params, loaded)
        for n, st in batchnorm_state(loaded).items():
            if n in state:
                state[n] = {k: jnp.asarray(v) for k, v in st.items()}
        print(f"parity on imported caffemodel weights: {args.weights}")
    elif args.weights:
        from caffe_escoin_tpu.engine.checkpoint import load_checkpoint_full

        loaded, _, net_state, _ = load_checkpoint_full(
            args.weights.removesuffix(".npz"))
        for n, p in loaded.items():
            if n in params:
                params[n] = jax.tree_util.tree_map(jnp.asarray, p)
        if net_state:
            for n, st in net_state.items():
                if n in state:
                    state[n] = {k: jnp.asarray(v) for k, v in st.items()}
        print(f"parity on checkpoint weights: {args.weights}")

    pruned = dict(params)
    if args.sparsity > 0:
        for layer in base_net.layers:
            n = layer.spec.name
            if n in pruned and layer.spec.type in ("Convolution",
                                                   "ConvolutionReLU"):
                w = np.asarray(pruned[n]["w"])
                if w.shape[0] * w.shape[1] * w.shape[2] < 32:
                    continue
                q = dict(pruned[n])
                q["w"] = jnp.asarray(
                    prune_conv_weight(w, args.sparsity,
                                      tuple(args.block_shape)))
                pruned[n] = q

    def maybe_fuse(net, p):
        if not args.fuse:
            return net, p, state
        from caffe_escoin_tpu.nn.fuse import fuse_inference

        fnet, fp = fuse_inference(net, p, state=state)
        return fnet, fp, None  # BN folded: no state channel left

    xs = [jnp.asarray(rng.standard_normal(data_shape), jnp.float32)
          for _ in range(args.batches)]
    bnet, bparams, bstate = maybe_fuse(base_net, pruned)
    ref_probs = [np.asarray(bnet.apply(bparams, {"data": x},
                                       state=bstate)["prob"])
                 for x in xs]

    ok = True
    for mode in (ConvMode.LOWERED_SPARSE, ConvMode.SCONV, ConvMode.SCONV_PAR):
        net = make_net(mode)
        net.init(jax.random.PRNGKey(args.seed), {"data": data_shape})
        net, pruned_m, st_m = maybe_fuse(net, pruned)
        aligned = net.weight_align(pruned_m)
        fwd = jax.jit(lambda p, b: net.apply(p, b, state=st_m))
        max_diff = 0.0
        top1_agree = top5_overlap = total = 0
        for x, ref in zip(xs, ref_probs):
            probs = np.asarray(fwd(aligned, {"data": x})["prob"])
            max_diff = max(max_diff, float(np.abs(probs - ref).max()))
            t1 = probs.argmax(-1)
            r1 = ref.argmax(-1)
            top1_agree += int((t1 == r1).sum())
            t5 = np.argsort(-probs, -1)[:, :5]
            r5 = np.argsort(-ref, -1)[:, :5]
            for a, b in zip(t5, r5):
                top5_overlap += len(set(a) & set(b))
            total += len(t1)
        status = "OK" if max_diff <= args.tol else "FAIL"
        ok &= max_diff <= args.tol
        print(f"{mode.name:14s}: max|dprob|={max_diff:.2e} "
              f"top1 agree {top1_agree}/{total} "
              f"top5 overlap {top5_overlap}/{5*total}  [{status}]")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""Host-RSS growth per training iteration, the probe behind the solver's
RSS guard (engine/solver.py). Isolates WHERE per-iteration host memory goes:

  --variant train        full Solver-style jitted train step loop
  --variant train_nofetch  same but never pulls the loss to the host
  --variant forward      repeated jitted forward only (no state updates)
  --variant train_lenet  much smaller model (scales growth per-iter?)

Prints RSS (VmRSS) every --every iters as JSONL. Run once with
--platform cpu and once with --platform gpu; growth only on the GPU pins the
device client, growth on both pins jax/framework state.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rss_mb():
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) // 1024
    return -1


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="train",
                    choices=["train", "train_nofetch", "forward",
                             "train_lenet"])
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--every", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--platform", default="cpu",
                    choices=["auto", "cpu", "gpu"])
    ap.add_argument("--model", default="alexnet")
    args = ap.parse_args()

    import jax
    from caffe_escoin_tpu.utils.runtime import select_platform
    select_platform(args.platform)
    import numpy as np
    import jax.numpy as jnp

    from caffe_escoin_tpu.engine.solver import Solver
    from caffe_escoin_tpu.engine.solvers import SolverConfig
    from caffe_escoin_tpu.models import ZOO
    from caffe_escoin_tpu.nn import Net

    model = "lenet" if args.variant == "train_lenet" else args.model
    builder_raw, ish = ZOO[model]
    try:
        specs = builder_raw(num_classes=10, include_loss=True)
    except TypeError:
        specs = builder_raw(include_loss=True)
    size, ch = ish["data"][1], ish["data"][3]
    net = Net(specs, phase="train")
    cfg = SolverConfig(base_lr=0.01, momentum=0.9)
    sol = Solver(net, cfg, display=0)
    sol.init({"data": (args.batch, size, size, ch),
              "label": (args.batch,)})
    rng = np.random.default_rng(0)
    # fixed device-resident batch: data pipeline excluded from the bisect
    batch = {"data": jnp.asarray(rng.standard_normal(
        (args.batch, size, size, ch)).astype(np.float32) * 0.1),
        "label": jnp.asarray(rng.integers(0, 10, args.batch))}

    def it():
        while True:
            yield batch

    print(json.dumps({"variant": args.variant, "platform": args.platform,
                      "model": model, "rss_mb_start": rss_mb()}), flush=True)
    t0 = time.time()
    if args.variant == "forward":
        fwd = jax.jit(lambda p, b: net.loss(p, b, train=False))
        for i in range(args.iters):
            out = fwd(sol.params, batch)
            jax.block_until_ready(out)
            if (i + 1) % args.every == 0:
                print(json.dumps({"iter": i + 1, "rss_mb": rss_mb(),
                                  "s": round(time.time() - t0, 1)}),
                      flush=True)
    else:
        fetch = args.variant != "train_nofetch"
        src = it()
        done = 0
        while done < args.iters:
            n = min(args.every, args.iters - done)
            if fetch:
                sol.step(src, n, log=lambda *_: None)
            else:
                # replicate Solver.step's jit loop without the host float()
                if sol._step_fn is None:
                    sol._step_fn = sol._build_step()
                for _ in range(n):
                    sol.rng, sub = jax.random.split(sol.rng)
                    b2 = jax.tree_util.tree_map(lambda x: x[None], batch)
                    sol.params, sol.state, sol.net_state, _loss = \
                        sol._step_fn(sol.params, sol.state, sol.net_state,
                                     b2, jnp.float32(0.01),
                                     jnp.int32(sol.iter + 1), sub)
                    sol.iter += 1
            done += n
            jax.block_until_ready(sol.params)
            print(json.dumps({"iter": done, "rss_mb": rss_mb(),
                              "s": round(time.time() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main()

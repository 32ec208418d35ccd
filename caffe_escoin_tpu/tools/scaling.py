"""Multi-device scaling benchmark: batch-sharded sparse inference throughput.

BASELINE's scaling row asks for nnz/s per device at 1 / 2 / ... / N devices
with >=80% scaling efficiency (the reference's analogue claim is the
multi-GPU table in `docs/multigpu.md:26`). This harness measures
data-parallel sparse-conv inference (weights closed over and replicated —
the XBSP executor engages exactly as on one device; XLA partitions every dot's
batch dimension over the mesh with zero collectives in the forward path) and
writes one JSON row per device count.

On several GPUs run it unchanged. Without them, run on the virtual CPU
mesh to validate the mechanism and partitioning
(`XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu`);
virtual-mesh wall-clock shares one host's cores, so per-device efficiency
there is a lower bound dominated by host contention, not the interconnect.

    python -m caffe_escoin_tpu.tools.scaling --devices 1,2,4 \
        --model resnet50 --out chiprun_out/scaling.jsonl
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def log(m):
    print(m, file=sys.stderr, flush=True)


def measure(model: str, n_dev: int, batch_per_dev: int, sparsity: float,
            iters: int, seed: int = 0):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from caffe_escoin_tpu.engine.context import ConvMode, ExecutionPolicy
    from caffe_escoin_tpu.models import ZOO
    from caffe_escoin_tpu.nn import Net
    from caffe_escoin_tpu.utils.pruning import prune_conv_weight

    devices = jax.devices()[:n_dev]
    mesh = Mesh(np.array(devices), ("data",))
    policy = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR,
                             block_shape=(128, 128))
    builder, input_shapes = ZOO[model]
    net = Net(builder(), policy=policy, phase="test")
    batch = batch_per_dev * n_dev
    shape = (batch,) + tuple(input_shapes["data"][1:])
    with jax.default_device(jax.devices("cpu")[0]):
        params = net.init(jax.random.PRNGKey(seed), {"data": shape})
        total_nnz = 0
        pruned = {}
        for layer in net.layers:
            name = layer.spec.name
            p = params.get(name)
            if p is None:
                continue
            if (layer.spec.type in ("Convolution", "ConvolutionReLU")
                    and "w" in p):
                w = np.asarray(p["w"])
                if w.shape[0] * w.shape[1] * w.shape[2] >= 64:
                    q = dict(p)
                    wp = prune_conv_weight(w, sparsity, (128, 128))
                    q["w"] = jnp.asarray(wp)
                    pruned[name] = q
                    continue
            pruned[name] = p
        aligned = net.weight_align(pruned)
        # nnz-work per sample: sum over sparse conv layers of nnz * out-pixels
        nnz_work = 0.0
        for layer in net.layers:
            name = layer.spec.name
            a = aligned.get(name)
            if a is not None and hasattr(a, "stats") and a.stats is not None:
                out_shape = net.blob_shapes[layer.spec.tops[0]]
                nnz_work += a.stats.nnz * np.prod(out_shape[1:-1])

    data_sharding = NamedSharding(mesh, P("data"))
    fwd = jax.jit(lambda x: net.apply(aligned, {"data": x})["prob"],
                  in_shardings=data_sharding)
    rng = np.random.default_rng(seed)
    x = jax.device_put(
        rng.standard_normal(shape).astype(np.float32) * 0.1, data_sharding)
    jax.block_until_ready(fwd(x))  # compile
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fwd(x))
        best = min(best, time.perf_counter() - t0)
    nnz_per_s = nnz_work * batch / best
    return dict(devices=n_dev, batch=batch, batch_per_dev=batch_per_dev,
                time_s=round(best, 6),
                samples_per_s=round(batch / best, 2),
                gnnz_per_s=round(nnz_per_s / 1e9, 2),
                gnnz_per_s_per_dev=round(nnz_per_s / 1e9 / n_dev, 2))


def measure_halo(n_dev: int, sparsity: float, iters: int, seed: int = 0):
    """Spatial partitioning (halo exchange) of one sparse conv layer:
    the H dimension sharded over `model`, (KH-1)/2 boundary rows exchanged
    via ppermute per step — STRONG scaling over a fixed feature map."""
    import time as _time

    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from caffe_escoin_tpu.engine.context import ExecutionPolicy
    from caffe_escoin_tpu.parallel import halo
    from caffe_escoin_tpu.sparse.weight_align import weight_align
    from caffe_escoin_tpu.utils.pruning import prune_conv_weight

    # XBSP engine: the performance-bearing arm inside the spatial partition
    policy = ExecutionPolicy(block_shape=(16, 16))
    rng = np.random.default_rng(seed)
    cin, cout = 64, 64
    h = 16 * n_dev  # H divides the mesh
    w = 32
    wt = prune_conv_weight(
        rng.standard_normal((3, 3, cin, cout)).astype(np.float32), sparsity,
        (16, 16))
    aligned = weight_align(wt, rng.standard_normal(cout).astype(np.float32),
                           policy=policy)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("model",))
    x = jnp.asarray(rng.standard_normal((2, h, w, cin)).astype(np.float32))
    fwd = jax.jit(lambda x: halo.spatial_sconv2d(
        x, aligned, mesh=mesh, padding=(1, 1), policy=policy))
    jax.block_until_ready(fwd(x))
    best = float("inf")
    for _ in range(iters):
        t0 = _time.perf_counter()
        jax.block_until_ready(fwd(x))
        best = min(best, _time.perf_counter() - t0)
    nnz_work = aligned.stats.nnz * h * w * 2
    return dict(devices=n_dev, mode="halo", engine="xbsp",
                time_s=round(best, 6),
                gnnz_per_s=round(nnz_work / best / 1e9, 3),
                gnnz_per_s_per_dev=round(nnz_work / best / 1e9 / n_dev, 3))


def measure_tp(n_dev: int, sparsity: float, iters: int, seed: int = 0):
    """Tensor parallelism: cout-block-sharded BSC SpMM over `model`."""
    import time as _time

    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from caffe_escoin_tpu.engine.context import ExecutionPolicy
    from caffe_escoin_tpu.parallel import tp
    from caffe_escoin_tpu.sparse.weight_align import weight_align
    from caffe_escoin_tpu.utils.pruning import prune_conv_weight

    policy = ExecutionPolicy(block_shape=(16, 8), use_pallas=False)
    rng = np.random.default_rng(seed)
    cin, cout = 32, 8 * 8 * n_dev  # bn=8, cout blocks divide the mesh
    wt = prune_conv_weight(
        rng.standard_normal((3, 3, cin, cout)).astype(np.float32), sparsity,
        (16, 8))
    aligned = weight_align(wt, rng.standard_normal(cout).astype(np.float32),
                           policy=policy)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("model",))
    x = jnp.asarray(rng.standard_normal((2, 16, 16, cin)).astype(np.float32))
    fwd = jax.jit(lambda x: tp.tp_conv_lowered(
        x, aligned, mesh=mesh, padding=(1, 1), policy=policy))
    jax.block_until_ready(fwd(x))
    best = float("inf")
    for _ in range(iters):
        t0 = _time.perf_counter()
        jax.block_until_ready(fwd(x))
        best = min(best, _time.perf_counter() - t0)
    nnz_work = aligned.stats.nnz * 16 * 16 * 2
    return dict(devices=n_dev, mode="tp", time_s=round(best, 6),
                gnnz_per_s=round(nnz_work / best / 1e9, 3),
                gnnz_per_s_per_dev=round(nnz_work / best / 1e9 / n_dev, 3))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--batch_per_dev", type=int, default=4)
    ap.add_argument("--sparsity", type=float, default=0.9)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--mode", default="dp", choices=["dp", "halo", "tp"])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import jax

    avail = len(jax.devices())
    counts = [int(c) for c in args.devices.split(",") if int(c) <= avail]
    log(f"backend {jax.default_backend()}, {avail} devices; measuring "
        f"{counts} ({args.mode})")
    rows = []
    for n in counts:
        if args.mode == "halo":
            r = measure_halo(n, args.sparsity, args.iters)
        elif args.mode == "tp":
            r = measure_tp(n, args.sparsity, args.iters)
        else:
            r = measure(args.model, n, args.batch_per_dev, args.sparsity,
                        args.iters)
        if rows:
            r["scaling_efficiency"] = round(
                r["gnnz_per_s_per_dev"] / rows[0]["gnnz_per_s_per_dev"], 3)
        else:
            r["scaling_efficiency"] = 1.0
        r["model"] = args.model
        r["sparsity"] = args.sparsity
        r["backend"] = jax.default_backend()
        rows.append(r)
        sps = (f"{r['samples_per_s']:.1f} samples/s, "
               if "samples_per_s" in r else "")
        log(f"  {n} dev: {sps}{r['gnnz_per_s_per_dev']} Gnnz/s/dev, "
            f"eff {r['scaling_efficiency']:.0%}")
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(r) + "\n")
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())

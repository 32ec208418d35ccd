"""Per-layer / per-category forward timing.

Reproduces the reference's three instrumentation levels (SURVEY.md section 5):
per-layer Forward timing (`layer.hpp:438-472`), per-category aggregation —
conv / fc / data / other — (`Net::GetConvTime` et al., `net.cpp:516-565`), and
the `caffe time`-style per-layer report (`tools/caffe.cpp:374-461`).

A layer inside one jit program can't be timed individually, so the
harness offers two modes:

* ``time_net_layerwise`` — jits each layer separately and times it with
  block_until_ready (device-accurate per-layer cost, modest launch overhead;
  the analogue of the reference's per-layer cudaEvent timing).
* ``time_net_fused`` — times the whole jitted forward (what production runs).

Both report wall ms plus derived GFLOP/s and nnz/s for sparse conv layers.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import jax
import numpy as np

from caffe_escoin_tpu.nn.net import Net
from caffe_escoin_tpu.sparse.weight_align import AlignedConvWeight


def _sync(tree):
    for leaf in jax.tree_util.tree_leaves(tree):
        if hasattr(leaf, "block_until_ready"):
            leaf.block_until_ready()
    return tree


def time_fn(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median ms of fn(*args). On an accelerator this is the profiler's
    device timeline (`benchmark.device_time`: device time, not host
    dispatch); on the CPU it is the wall clock with sync (the reference's
    CPUTimer role, `benchmark.hpp:10-48`)."""
    if jax.default_backend() != "cpu":
        from caffe_escoin_tpu.utils.benchmark import device_time

        return device_time(lambda *a: fn(*a), *args, iters=iters) * 1e3
    for _ in range(warmup):
        _sync(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def time_net_fused(net: Net, params, inputs, *, iters: int = 10) -> float:
    fwd = jax.jit(lambda p, x: net.apply(p, x))
    return time_fn(fwd, params, inputs, iters=iters)


def time_net_layerwise(net: Net, params, inputs, *, iters: int = 10,
                       backward: bool = False) -> Dict[str, Any]:
    """Per-layer timing + category buckets. Returns
    {"layers": [{name, type, category, ms, gflops, nnz}], "categories": {...},
    "total_ms": float}.

    With ``backward=True`` each row gains ``bwd_ms`` — the per-layer VJP
    cost (grad w.r.t. params AND bottoms), matching `caffe time`'s
    forward/backward table (`tools/caffe.cpp:374-461`). Layers whose
    forward isn't differentiable (ArgMax, Accuracy, data layers) report
    bwd_ms = 0, like the reference's !layer_needs_backward."""
    blobs = dict(inputs)
    rows: List[Dict[str, Any]] = []
    buckets = {"conv": 0.0, "fc": 0.0, "data": 0.0, "other": 0.0}
    bwd_buckets = {"conv": 0.0, "fc": 0.0, "data": 0.0, "other": 0.0}
    for layer in net.layers:
        spec = layer.spec
        ins = [blobs[b] for b in spec.bottoms]
        p = params.get(spec.name, {})
        fwd = jax.jit(
            lambda p, ins, layer=layer: layer.apply(p, ins, train=False, rng=None)
        )
        ms = time_fn(fwd, p, ins, iters=iters)
        outs = fwd(p, ins)
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        for t, o in zip(spec.tops, outs):
            blobs[t] = o
        row = {"name": spec.name, "type": spec.type,
               "category": layer.category, "ms": ms}
        if backward:
            bwd_ms = 0.0
            if (p or ins) and spec.type not in ("ArgMax", "Accuracy"):
                def scalar(p, ins, layer=layer):
                    outs = layer.apply(p, ins, train=False, rng=None)
                    if not isinstance(outs, (list, tuple)):
                        outs = [outs]
                    tot = 0.0
                    for o in outs:
                        if jax.numpy.issubdtype(o.dtype, jax.numpy.floating):
                            tot = tot + jax.numpy.sum(
                                o.astype(jax.numpy.float32))
                    return tot

                try:
                    bwd = jax.jit(jax.grad(scalar, argnums=(0, 1)))
                    bwd(p, ins)  # compile/trace check
                    bwd_ms = time_fn(bwd, p, ins, iters=iters)
                except Exception:
                    bwd_ms = 0.0
            row["bwd_ms"] = bwd_ms
            bwd_buckets[layer.category] += bwd_ms
        if isinstance(p, AlignedConvWeight) and ins:
            n = ins[0].shape[0]
            out_sp = int(np.prod(outs[0].shape[1:-1]))
            nnz = p.stats.nnz if p.stats else int(np.asarray(p.dense != 0).sum())
            row["nnz"] = nnz
            row["gflops"] = 2.0 * nnz * out_sp * n / (ms * 1e-3) / 1e9
            row["nnz_per_s"] = nnz * out_sp * n / (ms * 1e-3)
        rows.append(row)
        buckets[layer.category] += ms
    result = {
        "layers": rows,
        "categories": buckets,
        "total_ms": sum(buckets.values()),
    }
    if backward:
        result["categories_backward"] = bwd_buckets
        result["total_backward_ms"] = sum(bwd_buckets.values())
    return result


def format_report(result: Dict[str, Any]) -> str:
    """`caffe time`-style text report (tools/caffe.cpp:374-461)."""
    has_bwd = "total_backward_ms" in result
    hdr = f"{'layer':<16}{'type':<20}{'cat':<7}{'fwd ms':>9}"
    if has_bwd:
        hdr += f"{'bwd ms':>9}"
    lines = [hdr + "  extra"]
    for r in result["layers"]:
        extra = ""
        if "gflops" in r:
            extra = f"{r['gflops']:.1f} GFLOP/s  {r['nnz_per_s']/1e9:.2f} Gnnz/s"
        line = (f"{r['name']:<16}{r['type']:<20}{r['category']:<7}"
                f"{r['ms']:>9.3f}")
        if has_bwd:
            line += f"{r.get('bwd_ms', 0.0):>9.3f}"
        lines.append(line + f"  {extra}")
    c = result["categories"]
    lines.append(
        f"[totals] conv={c['conv']:.3f}ms fc={c['fc']:.3f}ms data={c['data']:.3f}ms "
        f"other={c['other']:.3f}ms total={result['total_ms']:.3f}ms"
    )
    if has_bwd:
        cb = result["categories_backward"]
        lines.append(
            f"[backward] conv={cb['conv']:.3f}ms fc={cb['fc']:.3f}ms "
            f"data={cb['data']:.3f}ms other={cb['other']:.3f}ms "
            f"total={result['total_backward_ms']:.3f}ms"
        )
    return "\n".join(lines)


def debug_info(net, params, inputs, *, state=None, log=print):
    """Per-layer blob/param norm dump — the reference's `debug_info` mode
    (`src/caffe/net.cpp:761-774`: "[Forward] Layer <name>, top blob <top>
    data: <asum>"). Eager per-layer execution; returns the rows."""
    import numpy as np

    blobs = dict(inputs)
    if state is None:
        state = getattr(net, "state0", {})
    rows = []
    for layer in net.layers:
        spec = layer.spec
        ins = [blobs[b] for b in spec.bottoms]
        p = params.get(spec.share_params or spec.name, {})
        if layer.has_state:
            outs, _ = layer.apply_stateful(
                p, state.get(spec.name, {}) or layer.init_state(
                    [tuple(b.shape) for b in ins]),
                ins, train=False, rng=None)
        else:
            outs = layer.apply(p, ins, train=False, rng=None)
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        for t, o in zip(spec.tops, outs):
            blobs[t] = o
            asum = float(np.mean(np.abs(np.asarray(o))))
            rows.append({"layer": spec.name, "top": t, "data": asum})
            log(f"    [Forward] Layer {spec.name}, top blob {t} "
                f"data: {asum:.6g}")
        if isinstance(p, dict):
            for k, v in p.items():
                if hasattr(v, "shape"):
                    pn = float(np.mean(np.abs(np.asarray(v))))
                    rows.append({"layer": spec.name, "param": k, "data": pn})
    return rows

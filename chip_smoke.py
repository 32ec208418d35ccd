#!/usr/bin/env python3
"""Smoke test of the sparse CNN system on NVIDIA GPUs.

    python chip_smoke.py          # one card: phases 1-6 below
    python chip_smoke.py --four   # four cards: the multi-device paths only

One card, ResNet-50 at 224x224x3 and 1000 classes with random weights from
a seed, every conv but the stem and the FC pruned to 90% in 128x128 blocks:

1. identity: the device as JAX reports it, the card's name and power limit;
2. forwards at batch 32, each against the dense, unfused float32 net at
   HIGHEST precision (relative L2 of ``fc1000``):
   * the bf16 deployment with the pattern closed over (XBSP executors and
     the dense floor; fuse -> pack -> weight_align -> Net.apply), <= 2e-2:
     bf16 keeps about 3 digits through about 50 layers;
   * the float32 forward with the pattern traced (`__graft_entry__.entry`'s
     path: im2col + the Pallas SpMM kernel) at HIGHEST, <= 1e-4;
3. the Pallas SpMM kernel at the five ResNet-50 b32 GEMM views, on bf16
   operands against `jnp.dot` of the same operands at HIGHEST, <= 1e-3
   (only the summation order differs);
4. `autotune.measure_arms` on two ResNet-50 keys: every arm timed on the
   device timeline;
5. three SGD steps (gradient norm clipped to 1) of ResNet-50 with its loss
   at batch 16 through engine/solver.py on synthetic data: the first loss
   against the float32 loss at HIGHEST, <= 1e-2 (the step runs XLA's
   default TF32 convs), every loss and param finite;
6. the ``gpu`` pytest lane (tests/test_on_chip.py).

Each phase prints its compile seconds, ms per run (host clock around
`block_until_ready`), errors with their bounds, `memory_analysis()` and the
device's peak bytes in use. Any device that is not a GPU is refused; a
failed phase makes the exit code non-zero. The last line of a passing run
is ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": n}}``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
RESNET_GEMMS = ((25088, 1152, 128), (6272, 2304, 256), (1568, 4608, 512),
                (6272, 1024, 256), (1568, 512, 2048))
# (x_shape, kernel, cin, cout, stride, pad): a 3x3 of stage 2 and a
# reduce-1x1 of stage 3
RESNET_KEYS = (((32, 28, 28, 128), 3, 128, 128, 1, 1),
               ((32, 14, 14, 1024), 1, 1024, 256, 1, 0))


def log(msg=""):
    print(msg, flush=True)


def card_identity() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` as the driver reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


class Checks:
    """Collects bound checks; `done` raises if any failed."""

    def __init__(self, phase):
        self.phase, self.failed = phase, []

    def bound(self, name, err, bound):
        ok = err <= bound
        log(f"  {name}: rel L2 {err:.3e} (bound {bound:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            self.failed.append(f"{name}: {err:.3e} > {bound:.0e}")

    def true(self, name, cond):
        log(f"  {name}: {'ok' if cond else 'FAIL'}")
        if not cond:
            self.failed.append(name)

    def done(self):
        if self.failed:
            raise AssertionError(f"{self.phase}: {self.failed}")


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", "n/a")


def compile_and_run(label, fn, args, *, runs=5):
    """Compile jit(fn) for args, run it ``runs`` times; print compile
    seconds, ms per run (host clock around block_until_ready) and the
    compiled memory analysis. Returns the output."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    log(f"  {label}: compile {compile_s:.2f} s, "
        f"{statistics.median(times) * 1e3:.3f} ms/run, memory "
        f"{memory_of(compiled)}, peak_bytes_in_use {peak_bytes()}")
    return out


def memory_of(compiled):
    """The byte counts of `compiled.memory_analysis()`."""
    mem = compiled.memory_analysis()
    if mem is None:
        return None
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {f.replace("_size_in_bytes", ""): getattr(mem, f, None)
            for f in fields}


def phase_forwards(builder, input_shape, *, logits="fc1000", sparsity=0.9,
                   block=(128, 128), seed=0):
    """The bf16 closed-over and f32 traced sparse forwards of ``builder``
    against its dense, unfused float32 net at HIGHEST precision."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as graft
    from caffe_escoin_tpu.engine.context import ConvMode, ExecutionPolicy

    checks = Checks("forwards")
    t0 = time.perf_counter()
    ref_net, pruned = graft.pruned_model(
        builder, input_shape, ExecutionPolicy(), sparsity=sparsity,
        block=block, seed=seed)
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(
        input_shape).astype(np.float32))
    pol_b = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=block,
                            compute_dtype=jnp.bfloat16, cast_back=False)
    fnet_b, al_b = graft.deploy(builder, pol_b, ref_net, pruned)
    pol_t = ExecutionPolicy(conv_mode=ConvMode.SCONV, block_shape=block,
                            sparse_threshold=0.5, sconv_threshold=0.5)
    fnet_t, al_t = graft.deploy(builder, pol_t, ref_net, pruned)
    log(f"  build (init, prune, fuse, pack, align x2): "
        f"{time.perf_counter() - t0:.2f} s")

    with jax.default_matmul_precision("highest"):
        ref = compile_and_run(
            "reference (dense unfused f32, HIGHEST)",
            lambda p, xx: ref_net.apply(p, {"data": xx},
                                        return_blobs=True)[logits],
            (pruned, x))
    out_b = compile_and_run(
        "bf16, pattern closed over",
        lambda xx: fnet_b.apply(al_b, {"data": xx},
                                return_blobs=True)[logits], (x,))
    checks.true("bf16 output finite, shape", bool(jnp.isfinite(out_b).all())
                and out_b.shape == ref.shape)
    checks.bound("bf16 closed-over vs reference", rel_l2(out_b, ref), 2e-2)
    with jax.default_matmul_precision("highest"):
        out_t = compile_and_run("f32, pattern traced (entry), HIGHEST",
                                graft.traced_forward(fnet_t, logits),
                                (al_t, x))
    checks.bound("f32 traced vs reference", rel_l2(out_t, ref), 1e-4)
    checks.done()


def phase_spmm(shapes, *, sparsity=0.9, block=(128, 128), interpret=False,
               seed=0):
    """The Pallas SpMM kernel on bf16 operands against jnp.dot of the same
    operands at HIGHEST, and on float32 operands at the first shape."""
    import jax
    import jax.numpy as jnp

    from caffe_escoin_tpu.kernels.bsc_pallas import bsc_spmm_pallas
    from caffe_escoin_tpu.sparse.formats import dense_to_bsc
    from caffe_escoin_tpu.utils.pruning import prune_blocks

    checks = Checks("spmm")
    rng = np.random.default_rng(seed)
    for i, (m, k, n) in enumerate(shapes):
        w = prune_blocks(rng.standard_normal((k, n)).astype(np.float32)
                         * 0.05, sparsity, block)
        bsc = dense_to_bsc(w, block)
        for dtype, bound in (("bfloat16", 1e-3), ("float32", 1e-5)):
            if dtype == "float32" and i:
                continue
            b = jax.tree_util.tree_map(
                lambda l: l.astype(dtype) if l.dtype == jnp.float32 else l,
                bsc)
            a = jnp.asarray(rng.standard_normal((m, k)), dtype)
            out = compile_and_run(
                f"kernel {dtype} ({m}, {k}, {n})",
                lambda aa, bb: bsc_spmm_pallas(aa, bb, out_dtype=jnp.float32,
                                               interpret=interpret), (a, b))
            ref = jnp.dot(a.astype(jnp.float32),
                          jnp.asarray(w).astype(dtype).astype(jnp.float32),
                          precision="highest")
            checks.bound(f"kernel {dtype} ({m}, {k}, {n}) vs jnp.dot",
                         rel_l2(out, ref), bound)
    checks.done()


def phase_autotune(keys, *, sparsity=0.9, block=(128, 128), seed=0):
    """measure_arms on each (x_shape, k, cin, cout, stride, pad) key: every
    arm must come back timed."""
    import jax.numpy as jnp

    from caffe_escoin_tpu.engine import autotune
    from caffe_escoin_tpu.engine.context import ExecutionPolicy
    from caffe_escoin_tpu.sparse.weight_align import weight_align
    from caffe_escoin_tpu.utils.benchmark import timer_name
    from caffe_escoin_tpu.utils.pruning import prune_conv_weight

    checks = Checks("autotune")
    pol = ExecutionPolicy(block_shape=block, compute_dtype=jnp.bfloat16,
                          cast_back=False)
    rng = np.random.default_rng(seed)
    for x_shape, k, cin, cout, s, p in keys:
        w = prune_conv_weight(rng.standard_normal(
            (k, k, cin, cout)).astype(np.float32) * 0.05, sparsity, block)
        al = weight_align(w, None, policy=pol)
        t0 = time.perf_counter()
        times = autotune.measure_arms(al, pol, x_shape, (s, s), (p, p),
                                      (1, 1), iters=8)
        pretty = ", ".join(f"{a}={t * 1e6:.1f}us" for a, t in times.items())
        log(f"  {x_shape} k{k} {cin}->{cout}: {pretty} "
            f"[{timer_name()}, {time.perf_counter() - t0:.1f} s, "
            f"peak_bytes_in_use {peak_bytes()}]")
        checks.true(f"all arms timed for {x_shape} k{k}",
                    set(times) == set(autotune.ARMS)
                    and all(0 < t < 1 for t in times.values()))
    checks.done()


def phase_solver(builder, input_shape, num_classes, *, steps=3, seed=0):
    """``steps`` SGD steps of builder(include_loss=True) on synthetic data
    through engine/solver.py; the first loss against the float32 loss at
    HIGHEST."""
    import jax
    import jax.numpy as jnp

    from caffe_escoin_tpu.engine.solver import Solver
    from caffe_escoin_tpu.engine.solvers import SolverConfig
    from caffe_escoin_tpu.nn import Net

    checks = Checks("solver")
    net = Net(builder(include_loss=True), phase="train")
    # the zoo's Caffe-style ResNet-50 init starts near a loss of 2e3
    # (residual sums grow stage by stage), so the step clips its gradient
    # norm as Caffe's `clip_gradients` does; unclipped, SGD at 0.01 leaves
    # the finite range in one step
    cfg = SolverConfig(solver_type="sgd", base_lr=0.01, momentum=0.9,
                       weight_decay=1e-4, clip_gradients=1.0)
    solver = Solver(net, cfg, display=0)
    batch = input_shape[0]
    solver.init({"data": input_shape, "label": (batch,)})
    p0, ns0 = solver.params, solver.net_state
    rng = np.random.default_rng(seed)
    batches = [{"data": jnp.asarray(rng.standard_normal(input_shape),
                                    jnp.float32),
                "label": jnp.asarray(rng.integers(0, num_classes, batch),
                                     jnp.int32)} for _ in range(steps)]
    data = iter(batches)
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        solver.step(data, 1, log=log)
        jax.block_until_ready(solver.params)
        times.append(time.perf_counter() - t0)
        losses.append(solver._losses[-1])
    step_args = (solver.params, solver.state, solver.net_state,
                 jax.tree_util.tree_map(lambda a: a[None], batches[0]),
                 jnp.float32(cfg.base_lr), jnp.int32(1),
                 jax.random.PRNGKey(seed))
    mem = memory_of(solver._step_fn.lower(*step_args).compile())
    log(f"  first step (compile + run) {times[0]:.2f} s, "
        f"{statistics.median(times[1:] or times) * 1e3:.3f} ms/step after, "
        f"losses {losses}, memory {mem}, peak_bytes_in_use {peak_bytes()}")
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda p, b: net.loss(p, b, train=True, state=ns0))(
            p0, batches[0])
    checks.bound("first loss vs float32 reference", rel_l2(losses[0], ref),
                 1e-2)
    finite = all(bool(jnp.isfinite(v).all())
                 for v in jax.tree_util.tree_leaves(solver.params))
    checks.true("losses and params finite",
                finite and bool(np.isfinite(losses).all()))
    moved = any(not np.array_equal(np.asarray(a), np.asarray(b)) for a, b in
                zip(jax.tree_util.tree_leaves(p0),
                    jax.tree_util.tree_leaves(solver.params)))
    checks.true("params updated", moved)
    checks.done()


def phase_gpu_tests():
    """The `gpu` pytest lane, in this process (one process per card)."""
    import pytest

    class Count:
        passed, other = 0, []

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.failed or report.skipped:
                self.other.append(f"{report.nodeid} {report.outcome}")

    os.environ["CESCOIN_GPU_TESTS"] = "1"
    count = Count()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_on_chip.py")],
                     plugins=[count])
    checks = Checks("gpu tests")
    checks.true(f"{count.passed} passed, none failed or skipped",
                rc == 0 and count.passed > 0 and not count.other)
    checks.done()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths (data parallel "
                         "training, batch-sharded sparse inference, tensor "
                         "parallel and halo), each against one card")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {dev.platform!r} "
              f"({dev.device_kind})", file=sys.stderr)
        return 2
    from caffe_escoin_tpu.utils import runtime

    log(f"[identity] jax {jax.__version__}: platform {dev.platform}, kind "
        f"{dev.device_kind!r}, count {len(devices)}")
    log(f"[identity] card: {card_identity()}")
    log(f"[identity] compile cache: {runtime.setup_compile_cache()}")

    import __graft_entry__ as graft
    from caffe_escoin_tpu.models import resnet

    if args.four:
        if len(devices) < 4:
            print(f"chip_smoke --four: needs 4 cards, found {len(devices)}",
                  file=sys.stderr)
            return 2
        phases = [("four cards: multi-device paths vs one card",
                   lambda: _four(graft))]
    else:
        phases = [
            ("forwards: ResNet-50 b32, 90% 128x128 blocks",
             lambda: phase_forwards(resnet.resnet50, (32, 224, 224, 3))),
            ("spmm: Pallas kernel at the ResNet-50 b32 GEMM views",
             lambda: phase_spmm(RESNET_GEMMS)),
            ("autotune: measure_arms on two ResNet-50 keys",
             lambda: phase_autotune(RESNET_KEYS)),
            ("solver: 3 SGD steps of ResNet-50 b16",
             lambda: phase_solver(resnet.resnet50, (16, 224, 224, 3), 1000)),
            ("gpu tests: tests/test_on_chip.py", phase_gpu_tests),
        ]
    failed = []
    for name, run in phases:
        log(f"[phase] {name}")
        t0 = time.perf_counter()
        try:
            run()
            log(f"[phase] ok in {time.perf_counter() - t0:.1f} s")
        except Exception as e:  # report every phase, then fail the run
            import traceback

            traceback.print_exc()
            failed.append(name)
            log(f"[phase] FAILED in {time.perf_counter() - t0:.1f} s: "
                f"{type(e).__name__}: {e}")
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    log(f"[identity] card: {card_identity()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


def _four(graft):
    """The multi-device paths on four cards, each against one card."""
    t0 = time.perf_counter()
    errs = graft.multichip_checks(4)
    log(f"  multichip_checks(4): {time.perf_counter() - t0:.1f} s, "
        f"peak_bytes_in_use {peak_bytes()}")
    checks = Checks("four cards")
    for name, err in errs.items():
        checks.bound(name, err, graft.MULTICHIP_BOUNDS[name])
    checks.true("all four-card paths ran", len(errs) == len(
        graft.MULTICHIP_BOUNDS))
    checks.done()


if __name__ == "__main__":
    sys.exit(main())

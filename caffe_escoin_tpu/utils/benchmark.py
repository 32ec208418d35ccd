"""On-device benchmarking utilities.

Replaces the reference's `Timer`/`CPUTimer` (`include/caffe/util/benchmark.hpp`)
with harnesses that survive two measurement hazards:

1. **XLA dead-code elimination**: timing `f(x)[0,0]` in a loop lets XLA slice
   the computation to one element. The host-clock harness chains the FULL
   output back into the next iteration's input (same-shape ops) or folds it
   with a `jnp.sum` consumed by the carry.
2. **Fixed per-execution overhead**: `slope_time` runs the in-graph loop at
   two iteration counts and reports (T(n2) - T(n1)) / (n2 - n1), cancelling
   any per-execution constant.

On an accelerator the timer of record is `device_time`, which reads module
executions from the profiler's device timeline and never falls back to a
host clock. `timer_name()` says which timer a backend gets; every benchmark
result carries it.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, List

import jax
import jax.numpy as jnp
from jax import lax

# profiler-trace planes holding the accelerator's own timeline; on a GPU
# their lines are the CUDA streams ("Stream #13(Compute)", ...), one event
# per kernel or copy the device ran
DEVICE_PLANE_PREFIX = "/device:"
# host span around each timed execution, which assigns device events to it
ITERATION_SPAN = "cescoin.device_time"
# the stat naming the XLA program that launched a device event
PROGRAM_STAT = "program_id"
# a device execution may read this much longer than its host span before
# the split is refused (one H100 trace read 27.04 ms of device events
# inside a 26.78 ms host span)
SPAN_SLACK = 1.05
_ANNOUNCED = []


def _loop_fn(op: Callable, iters: int, same_shape: bool):
    if same_shape:
        @jax.jit
        def rep(x):
            def body(i, x):
                return (op(x) * 0.999).astype(x.dtype)
            return lax.fori_loop(0, iters, body, x)
    else:
        @jax.jit
        def rep(x):
            # The op's input is loop-invariant; to defeat hoisting we perturb
            # x by the (tiny) carry scalar each iteration. The
            # optimization_barrier forces the FULL output to materialize —
            # without it XLA fuses the op into the scalar consumer and (e.g.)
            # a conv's output never touches device memory, under-reporting
            # the cost of any op measured this way.
            def body(i, carry):
                delta, x = carry
                y = (x + delta.astype(x.dtype)).astype(x.dtype)
                out = lax.optimization_barrier(op(y))
                probe = out.ravel()[0].astype(jnp.float32)
                return (probe * 1e-30 + delta * 0.5, x)
            return lax.fori_loop(0, iters, body,
                                 (jnp.float32(0.0), x))[0]
    return rep


def _best_total(rep, x, repeats: int = 2) -> float:
    rep(x)  # compile + warm
    jax.block_until_ready(rep(x))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(rep(x))
        best = min(best, time.perf_counter() - t0)
    return best


def slope_time(op: Callable, x, *, n1: int = 50, n2: int = 250,
               same_shape: bool = False, repeats: int = 2) -> float:
    """Seconds per op execution on the host clock, fixed dispatch cost
    cancelled."""
    t1 = _best_total(_loop_fn(op, n1, same_shape), x, repeats)
    t2 = _best_total(_loop_fn(op, n2, same_shape), x, repeats)
    return max(1e-9, (t2 - t1) / (n2 - n1))


def wall_time(f: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Plain dispatch timing (includes per-call overhead) — for end-to-end
    model latency where that overhead is part of the user experience."""
    import numpy as np

    for _ in range(warmup):
        jax.block_until_ready(f(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def timer_name() -> str:
    """The timer `device_time` uses on the current backend: the profiler's
    device timeline on an accelerator, the host-clock slope on the CPU."""
    return "host-slope" if jax.default_backend() == "cpu" else "device-trace"


def iteration_device_times(trace_dir: str) -> List[float]:
    """Device seconds of each timed execution in the profiler trace under
    ``trace_dir`` (see `spans_in`).

    Raises when the trace has no program kernels or they do not split
    into the timed executions: a host clock must not stand in for the
    device timeline unannounced."""
    import glob
    import os

    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise RuntimeError(f"no profiler trace was written under {trace_dir}")
    return spans_in(ProfileData.from_file(paths[0]).planes)


def spans_in(planes) -> List[float]:
    """Per-execution device spans from loaded planes (objects with
    ``.name`` and ``.lines``; lines with ``.name`` and ``.events``; events
    with ``.name``, ``.start_ns``, ``.duration_ns`` and ``.stats``).

    The host marks each of n timed executions with an `ITERATION_SPAN`.
    On the device, every kernel an XLA program launches carries the
    program's ``program_id`` stat, and every execution of a program
    launches the same kernels, so a program's events sorted by start split
    into its executions by count. The n executions are spread evenly over
    the programs seen (one for `device_time`, one per closure for
    `device_time_cycle`). An execution's time is its span, from its first
    kernel's start to its last one's end (gaps between kernels included).
    Device and host clocks need not agree, so spans are checked against
    the host spans by duration only (`SPAN_SLACK`)."""
    windows, programs, lines = [], {}, set()
    for plane in planes:
        on_device = plane.name.startswith(DEVICE_PLANE_PREFIX)
        for line in plane.lines:
            if on_device:
                lines.add(f"{plane.name} | {line.name}")
            for e in line.events:
                if on_device:
                    pid = dict(e.stats).get(PROGRAM_STAT)
                    if pid is not None:
                        programs.setdefault(str(pid), []).append(
                            (e.start_ns, e.start_ns + e.duration_ns))
                elif e.name == ITERATION_SPAN:
                    windows.append((e.start_ns, e.duration_ns))
    lines = sorted(lines)
    n = len(windows)
    if not programs:
        raise RuntimeError(
            "the profiler trace has no program kernels on a device plane "
            f"({DEVICE_PLANE_PREFIX}*; device lines seen: {lines or 'none'})")
    if n == 0 or n % len(programs):
        raise RuntimeError(f"{n} timed executions over {len(programs)} "
                           f"device programs (device lines: {lines})")
    if not _ANNOUNCED:
        _ANNOUNCED.append(1)
        print(f"[device_time] device timeline: {lines}", file=sys.stderr,
              flush=True)
    runs = n // len(programs)
    executions = []
    for pid, events in programs.items():
        if len(events) % runs:
            raise RuntimeError(f"program {pid}: {len(events)} device events "
                               f"do not split into {runs} executions")
        k = len(events) // runs
        events.sort()
        for r in range(runs):
            chunk = events[r * k:(r + 1) * k]
            executions.append((chunk[0][0], max(e for _, e in chunk)))
    spans = []
    for (start, end), (_, window) in zip(sorted(executions), sorted(windows)):
        if end - start > window * SPAN_SLACK:
            raise RuntimeError(
                f"a {end - start} ns device execution in a {window} ns host "
                f"span: the device events were not split into the timed "
                f"executions (device lines: {lines})")
        spans.append((end - start) * 1e-9)
    return spans


def _traced_median(run_iteration: Callable[[int], None], iters: int) -> float:
    import statistics
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        with jax.profiler.trace(td):
            for i in range(iters):
                with jax.profiler.TraceAnnotation(ITERATION_SPAN):
                    run_iteration(i)
        spans = iteration_device_times(td)
    return statistics.median(spans)


def _host_slope(f: Callable, args) -> float:
    """`slope_time` of f(*args) looped over its first array argument (the
    others, e.g. a params dict, are held fixed)."""
    i = next(i for i, a in enumerate(args) if hasattr(a, "dtype"))
    return slope_time(lambda x: f(*args[:i], x, *args[i + 1:]), args[i])


def device_time(f: Callable, *args, iters: int = 20, arg_sets=None) -> float:
    """Median on-device seconds per execution of jit(f)(*args).

    On an accelerator this reads each execution's span from the profiler's
    device timeline (`iteration_device_times`) and raises if the trace
    lacks it. On the CPU backend it is the host-clock `slope_time`
    (`timer_name()` says which).

    ``arg_sets`` (a list of >=2 argument tuples, cycled across iterations)
    keeps a module from reading its inputs out of a warm cache: repeating
    the SAME module on the SAME buffers lets operands that fit in the
    H100's 50 MB L2 stay resident across executions, so memory-bound
    modules report times below their device-memory roofline. Cycling
    distinct buffers restores the cold-read cost every layer pays inside a
    real net forward, where the rest of the network's traffic evicts it
    between uses. Pass it for any module whose operands fit in L2.
    """
    sets = list(arg_sets) if arg_sets else [args]
    if jax.default_backend() == "cpu":
        return _host_slope(f, sets[0])
    fj = f if hasattr(f, "lower") else jax.jit(f)  # keep a jitted f's cache
    for s in sets:
        jax.block_until_ready(fj(*s))  # compile + warm every variant
    return _traced_median(
        lambda i: jax.block_until_ready(fj(*sets[i % len(sets)])), iters)


def device_time_cycle(pairs, *, iters: int = 20) -> float:
    """Like ``device_time(..., arg_sets=...)`` but for CLOSURE variants:
    ``pairs`` is a list of (callable, args-tuple); each callable closes over
    its own weight replica (needed when the sparse pattern must be concrete
    at trace time, so weights cannot be jit arguments). Cycling distinct
    modules+buffers keeps each execution's operands cold the same way
    arg_sets does.

    Returns median on-device seconds per execution across all variants.
    """
    if jax.default_backend() == "cpu":
        return _host_slope(*pairs[0])
    fjs = [(jax.jit(f), a) for f, a in pairs]
    for fj, a in fjs:
        jax.block_until_ready(fj(*a))

    def run(i):
        fj, a = fjs[i % len(fjs)]
        jax.block_until_ready(fj(*a))

    return _traced_median(run, iters)

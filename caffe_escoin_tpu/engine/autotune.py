"""Measured per-shape executor autotuning for the sparse conv dispatcher.

Hand rules for the XBSP arm (`kernels/xla_block_sparse.best_arm`) derived
from one net's profiles route other nets' shapes badly (GoogLeNet's 28x28
reduce-1x1 shapes went to "unroll" and lost to the dense bf16 baseline).
The reference has the same problem class — its per-shape CUDA-kernel
dispatch (`math_functions.cu:589-694`) hardcodes shape templates — and the
fix here is to MEASURE each candidate arm once per (shape, pattern) on the
device, cache
the winner, and include the dense bf16 conv itself as a candidate so the
sparse path can never lose to its own baseline (the never-lose floor).

Measurement happens lazily at trace time: the aligned weights are closed
over (concrete), so each candidate can be jitted and timed on a synthetic
input of the real shape as ordinary eager work while the outer trace is
paused on the Python dispatch line. Results cache in-process and,
optionally, in a JSON file (``ExecutionPolicy.autotune_cache`` /
``$CESCOIN_AUTOTUNE_CACHE``) so a deployment ships its table offline.

Enabled by ``ExecutionPolicy(autotune=True)``; off by default (tests and
CPU meshes keep the zero-compile heuristic path).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

_CACHE: Dict[str, str] = {}
_TIMES: Dict[str, Dict[str, float]] = {}  # key -> arm -> seconds (reporting)
_LOCK = threading.RLock()
_LOADED_FILES: set = set()
_MEASURING = threading.local()
# graph-calibration overrides: consulted before _CACHE so calibrate_graph
# can A/B whole-net timings over candidate per-key arm assignments without
# touching the persistent table until a winner is chosen
_OVERRIDES: Dict[str, str] = {}
_RECORDING = threading.local()
# active net scope for calibrated-assignment lookup (see net_scope): a
# graph-calibration demotion is a property of one net's COMPOSITION, not of
# the (shape, pattern) key alone — served globally it would force another
# net's identical layer dense. Scoped entries live in the same
# cache file under "net=<tag>|<key>".
_NET_SCOPE: Optional[str] = None

ARMS = ("unroll", "gathered", "gathered_cols", "dense")


def _scoped_key(key: str, tag: Optional[str]) -> str:
    return f"net={tag}|{key}" if tag else key


@contextlib.contextmanager
def net_scope(tag: Optional[str]):
    """Serve per-net calibrated arm assignments for ``tag`` (falling back
    to the global per-(shape, pattern) table) inside the context."""
    global _NET_SCOPE
    prev = _NET_SCOPE
    _NET_SCOPE = tag
    try:
        yield
    finally:
        _NET_SCOPE = prev


def _pattern_sig(aligned) -> Tuple[int, int, int, int]:
    """Cheap pattern signature: arm cost depends on block COUNTS, not on
    which particular blocks are live."""
    import jax

    block_row = np.asarray(jax.device_get(aligned.bsc.block_row))
    bcol_nnz = np.asarray(jax.device_get(aligned.bsc.bcol_nnz))
    total_live = int(bcol_nnz.sum())
    union = len({int(block_row[j, s]) for j in range(block_row.shape[0])
                 for s in range(int(bcol_nnz[j]))})
    return total_live, union, int(block_row.shape[0]), aligned.bsc.n_brows


def device_kind() -> str:
    """The card a measurement was taken on: the backend and the device's
    kind (an arm measured on one card is not served on another)."""
    import jax

    return f"{jax.default_backend()}:{jax.devices()[0].device_kind}"


def cache_key(aligned, x_shape, stride, padding, dilation, dtype) -> str:
    sig = _pattern_sig(aligned)
    parts = (device_kind(), tuple(x_shape), str(dtype),
             aligned.kernel_shape, tuple(stride), tuple(padding),
             tuple(dilation), aligned.cin_pad, aligned.cout,
             aligned.groups, aligned.bsc.block_shape, sig)
    return repr(parts)


_FINGERPRINT: Optional[str] = None


def code_fingerprint() -> str:
    """Hash of the executor-kernel sources. A cached arm is a MEASUREMENT
    of specific kernel code; serving it after the kernels change silently
    skips re-measurement. The cache file records this fingerprint and is
    ignored wholesale on mismatch.

    Env toggles that change kernel BEHAVIOR are folded in too:
    an arm measured under CESCOIN_XBSP_NOPAD=1 is a measurement of
    different code than the padded default — same hazard class as a source
    edit. The fingerprint is cached per-process, so flip toggles before
    first use (they are process-level switches, not per-call knobs)."""
    global _FINGERPRINT
    if _FINGERPRINT is None:
        import hashlib

        import caffe_escoin_tpu.kernels as kpkg

        h = hashlib.sha256()
        kdir = os.path.dirname(os.path.abspath(kpkg.__file__))
        for name in sorted(os.listdir(kdir)):
            if name.endswith(".py"):
                with open(os.path.join(kdir, name), "rb") as fh:
                    h.update(fh.read())
        for toggle in ("CESCOIN_XBSP_NOPAD",):
            h.update(f"{toggle}={os.environ.get(toggle, '')}".encode())
        _FINGERPRINT = h.hexdigest()[:16]
    return _FINGERPRINT


def _load_file(path: str) -> None:
    with _LOCK:
        if not path or path in _LOADED_FILES:
            return
        _LOADED_FILES.add(path)
        if os.path.exists(path):
            try:
                with open(path) as fh:
                    data = json.load(fh)
            except (OSError, json.JSONDecodeError):
                return
            ver = data.pop("__kernel_fingerprint__", None)
            if ver != code_fingerprint():
                print(f"[autotune] cache {path} was measured against "
                      f"different kernel code ({ver} != "
                      f"{code_fingerprint()}); ignoring it — arms will be "
                      f"re-measured", flush=True)
                return
            _CACHE.update(data)


def _save_file(path: str) -> None:
    if not path:
        return
    try:
        with open(path, "w") as fh:
            json.dump({"__kernel_fingerprint__": code_fingerprint(),
                       **_CACHE}, fh, indent=0)
    except OSError:
        pass


def measure_arms(aligned, policy, x_shape, stride, padding, dilation,
                 *, iters: int = 10) -> Dict[str, float]:
    """Device-time each candidate executor on a synthetic input of the
    real shape. Returns arm -> seconds."""
    import jax
    import jax.numpy as jnp

    from caffe_escoin_tpu.kernels import xla_block_sparse as xbs
    from caffe_escoin_tpu.ops import conv as conv_ops
    from caffe_escoin_tpu.utils.benchmark import device_time

    dtype = (policy.compute_dtype if policy.compute_dtype is not None
             else jnp.float32)
    # 4 distinct inputs cycled per measurement: repeated identical dispatch
    # leaves the input L2-warm across executions and under-reports
    # memory-bound arms (utils/benchmark.device_time). Weights stay
    # closed-over (warm) in every arm alike, which favors the dense arm (its
    # weights are the largest), keeping the never-lose floor conservative.
    rng = np.random.default_rng(0)
    xsets = [(jnp.asarray(rng.standard_normal(x_shape), jnp.float32)
              .astype(dtype),) for _ in range(4)]
    x = xsets[0][0]
    wd = aligned.dense.astype(dtype)

    cands = {
        "unroll": lambda y: xbs.conv(
            y, aligned, stride=stride, padding=padding, dilation=dilation),
        "gathered": lambda y: xbs.conv_gathered(
            y, aligned, stride=stride, padding=padding, dilation=dilation),
        "gathered_cols": lambda y: xbs.conv_gathered_cols(
            y, aligned, stride=stride, padding=padding, dilation=dilation),
        "dense": lambda y: conv_ops.conv2d_dense(
            y, wd, aligned.bias, stride=stride, padding=padding,
            dilation=dilation, groups=aligned.groups),
    }
    times = {}
    for arm, fn in cands.items():
        try:
            times[arm] = device_time(fn, x, iters=max(iters, 8),
                                     arg_sets=xsets)
        except Exception as e:  # arm not executable for this shape
            print(f"[autotune] arm '{arm}' failed for {tuple(x_shape)} "
                  f"k{aligned.kernel_shape} cout{aligned.cout}: "
                  f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)
    return times


def choose_arm(aligned, policy, x_shape, stride, padding, dilation,
               *, log=None) -> Optional[str]:
    """Cached measured winner for this (shape, pattern); None when
    measurement is impossible (e.g. called re-entrantly from a candidate's
    own trace)."""
    if getattr(_MEASURING, "active", False):
        return None  # re-entrant call from inside a candidate's trace
    path = (getattr(policy, "autotune_cache", "")
            or os.environ.get("CESCOIN_AUTOTUNE_CACHE", ""))
    _load_file(path)
    import jax.numpy as jnp

    dtype = (policy.compute_dtype if policy.compute_dtype is not None
             else jnp.float32)
    key = cache_key(aligned, x_shape, stride, padding, dilation, dtype)
    rec = getattr(_RECORDING, "keys", None)
    with _LOCK:
        if key in _OVERRIDES:
            if rec is not None:
                rec.append((key, _OVERRIDES[key]))
            return _OVERRIDES[key]
        if _NET_SCOPE is not None:
            skey = _scoped_key(key, _NET_SCOPE)
            if skey in _CACHE:
                if rec is not None:
                    rec.append((key, _CACHE[skey]))
                return _CACHE[skey]
        if key in _CACHE:
            if rec is not None:
                rec.append((key, _CACHE[key]))
            if (os.environ.get("CESCOIN_AUTOTUNE_LOG_HITS")
                    and rec is None):
                # cached picks must be distinguishable from fresh
                # measurements: after a kernel change, a served entry means
                # the tuner did NOT re-time the arms (delete the cache file
                # or unset CESCOIN_AUTOTUNE_CACHE to force re-measurement)
                print(f"[autotune] cached arm '{_CACHE[key]}' for "
                      f"{x_shape} k{aligned.kernel_shape} "
                      f"cout{aligned.cout} (no re-measurement)",
                      flush=True)
            return _CACHE[key]
    _MEASURING.active = True
    try:
        times = measure_arms(aligned, policy, x_shape, stride, padding,
                             dilation)
    finally:
        _MEASURING.active = False
    if not times:
        return None
    winner = min(times, key=times.get)
    with _LOCK:
        _CACHE[key] = winner
        _TIMES[key] = times
        _save_file(path)
    if rec is not None:
        rec.append((key, winner))
    if log is not None:
        pretty = " ".join(f"{a}={t*1e6:.0f}us" for a, t in sorted(
            times.items()))
        log(f"autotune {x_shape} k{aligned.kernel_shape} "
            f"cout{aligned.cout}: {pretty} -> {winner}")
    return winner


@contextlib.contextmanager
def record_keys():
    """Collect every (cache_key, arm) served to choose_arm callers inside
    the context — including cache hits — so graph-level calibration can
    enumerate the distinct arm decisions a whole-net trace depends on,
    with multiplicity."""
    prev = getattr(_RECORDING, "keys", None)
    _RECORDING.keys = []
    try:
        yield _RECORDING.keys
    finally:
        _RECORDING.keys = prev


def _key_traffic(key: str, mult: int = 1) -> float:
    """Rough per-key time-share estimate from the cache key itself (the
    key repr embeds x_shape/stride/cout): ifmap + ofmap bytes x layer
    multiplicity. Used to order polish trials when isolated arm times are
    unavailable (file-loaded winners)."""
    import ast

    try:
        t = ast.literal_eval(key)
        n, h, w, c = t[1]
        sh, sw = t[4]
        cout = t[8]
        return float(mult) * (n * h * w * c
                              + n * (h // sh) * (w // sw) * cout)
    except Exception:
        return 0.0


def calibrate_graph(time_fn: Callable[[], float], *,
                    margin: float = 0.02,
                    keep_margin: float = 0.005,
                    max_flips: Optional[int] = None,
                    polish: int = 0,
                    cache_path: Optional[str] = None,
                    net_tag: Optional[str] = None,
                    log=None) -> Dict:
    """Whole-graph validation of the per-layer autotuned arm assignment.

    Per-(shape, pattern) ISOLATED measurement keeps each layer's weight
    blocks cache-warm, which flatters many-small-dots schedules; composed
    through a real graph those picks can LOSE to the dense floor (a
    GoogLeNet whose every per-layer arm measured as a winner ran slower
    end to end than its forced-dense sparse graph). This is the
    graph-scope completion of the never-lose
    floor, and of SURVEY §5's global-vs-per-layer conv_mode fix: the
    reference could only set conv_mode globally; here the per-layer choice
    is validated against — and can fall back to — the composed graph.

    ``time_fn`` builds a FRESH jitted whole-net forward (so the trace
    re-consults choose_arm) and returns its measured seconds. Algorithm:

    1. Time the current assignment, recording the (key, arm) decisions.
    2. Time the all-dense assignment (the graph-scope dense floor).
    3. If the current assignment is within ``margin`` of the floor (i.e.
       not more than ``margin`` SLOWER — a tolerance, because whole-net
       timings carry run-to-run noise and a borderline re-derivation
       from the floor would churn the table without a real win), keep it.
       Otherwise greedily re-enable each key's isolated winner —
       highest estimated gain first (from the isolated arm times when
       available) — keeping a flip only when the measured whole-graph
       time improves by ``keep_margin``.
    4. Persist the winning per-key arms to the autotune cache, so later
       runs (and the committed table) serve the calibrated assignment.
       With ``net_tag``, keys whose calibrated arm DIFFERS from the
       isolated assignment are persisted under a per-net scope
       ("net=<tag>|<key>", served inside `net_scope(tag)`) instead of
       overwriting the global per-(shape, pattern) table: a demotion
       caused by one net's composition must not force another net's
       identical layer dense. Confirmed keys (arm unchanged)
       stay global.

    Returns a report dict with the three timings and the final arms.
    """
    with record_keys() as rec:
        t_cur = time_fn()
    mult: Dict[str, int] = {}
    arms: Dict[str, str] = {}
    for key, arm in rec:
        mult[key] = mult.get(key, 0) + 1
        arms[key] = arm
    sparse_keys = [k for k, a in arms.items() if a != "dense"]
    report = {"t_isolated": t_cur, "keys": len(arms),
              "sparse_keys": len(sparse_keys)}
    path = (cache_path if cache_path is not None
            else os.environ.get("CESCOIN_AUTOTUNE_CACHE", ""))
    if not sparse_keys:
        report.update(t_final=t_cur, t_dense=None, flips=0,
                      arms=dict(arms))
        return report

    def set_overrides(d):
        with _LOCK:
            _OVERRIDES.clear()
            _OVERRIDES.update(d)

    try:
        assign = {k: "dense" for k in sparse_keys}
        set_overrides(assign)
        t_dense = time_fn()
        report["t_dense"] = t_dense
        flips = 0
        if t_cur <= t_dense * (1.0 + margin):
            # isolated picks compose fine — keep them
            assign = dict(arms)
            best = t_cur
            flips = len(sparse_keys)
            if log:
                log(f"calibrate_graph: isolated assignment stands "
                    f"({t_cur*1e3:.3f}ms vs dense floor "
                    f"{t_dense*1e3:.3f}ms)")
        else:
            # estimated per-key gain from the isolated measurements
            # (absent for file-loaded winners -> 0, recorded order)
            def gain(k):
                t = _TIMES.get(k, {})
                if arms[k] in t and "dense" in t:
                    return (t["dense"] - t[arms[k]]) * mult[k]
                return 0.0

            order = sorted(sparse_keys, key=gain, reverse=True)
            if max_flips is not None:
                order = order[:max_flips]
            best = t_dense
            for k in order:
                assign[k] = arms[k]
                set_overrides(assign)
                t = time_fn()
                if t < best * (1.0 - keep_margin):
                    best = t
                    flips += 1
                    if log:
                        log(f"calibrate_graph: keep {arms[k]} for "
                            f"{k[:72]}... ({t*1e3:.3f}ms)")
                else:
                    assign[k] = "dense"

        # polish: bounded search over ALTERNATIVE arms for the
        # highest-traffic keys — the accepted assignment may still carry
        # isolated picks that a different arm beats composed (session
        # noise flips isolated winners on ~1/3 of keys)
        trials = 0
        if polish > 0:
            order2 = sorted(assign, key=lambda k: -_key_traffic(
                k, mult.get(k, 1)))
            for k in order2:
                if trials >= polish:
                    break
                for alt in ("dense", "unroll", "gathered",
                            "gathered_cols"):
                    if alt == assign[k] or trials >= polish:
                        continue
                    prev = assign[k]
                    assign[k] = alt
                    set_overrides(assign)
                    try:
                        t = time_fn()
                    except Exception:
                        # an alternative arm may not be executable for
                        # this shape — treat as no-improvement
                        assign[k] = prev
                        trials += 1
                        continue
                    trials += 1
                    if t < best * (1.0 - keep_margin):
                        best = t
                        if log:
                            log(f"calibrate_graph: polish {prev}->{alt} "
                                f"for {k[:64]}... ({t*1e3:.3f}ms)")
                    else:
                        assign[k] = prev
        report.update(t_final=best, flips=flips, polish_trials=trials,
                      arms=dict(assign))
        with _LOCK:
            for k, arm in assign.items():
                if net_tag and arm != arms.get(k):
                    _CACHE[_scoped_key(k, net_tag)] = arm
                else:
                    _CACHE[k] = arm
            if path:
                _save_file(path)
        if log:
            log(f"calibrate_graph: isolated {t_cur*1e3:.3f}ms, dense floor "
                f"{t_dense*1e3:.3f}ms, calibrated {best*1e3:.3f}ms "
                f"({flips}/{len(sparse_keys)} sparse keys kept, "
                f"{trials} polish trials)")
        return report
    finally:
        set_overrides({})


def report() -> Dict[str, Dict[str, float]]:
    """Measured times for every autotuned key (for bench/docs tables)."""
    with _LOCK:
        return {k: dict(v) for k, v in _TIMES.items()}


def clear() -> None:
    with _LOCK:
        _CACHE.clear()
        _TIMES.clear()
        _LOADED_FILES.clear()

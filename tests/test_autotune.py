"""Graph-level arm calibration (engine/autotune.calibrate_graph): the
graph-scope completion of the never-lose floor. Per-layer ISOLATED autotune
picks can lose COMPOSED (a GoogLeNet whose every per-layer arm measured as
a winner ran slower end to end than its forced-dense sparse graph);
calibration A/Bs the whole graph over
candidate assignments and persists the winners.

Deterministic on CPU: time_fn consults choose_arm (like a real trace) but
returns a crafted cost model, so the greedy algorithm's decisions are
exactly checkable without device-timing noise."""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.engine import autotune  # noqa: E402
from caffe_escoin_tpu.engine.context import ExecutionPolicy  # noqa: E402
from caffe_escoin_tpu.sparse.weight_align import weight_align  # noqa: E402
from caffe_escoin_tpu.utils.pruning import prune_conv_weight  # noqa: E402


@pytest.fixture
def two_keys(tmp_path, monkeypatch):
    """Two distinct aligned weights + shapes -> two distinct cache keys,
    seeded into the autotune cache with sparse winners (no measurement)."""
    monkeypatch.setenv("CESCOIN_AUTOTUNE_CACHE",
                       str(tmp_path / "arms.json"))
    autotune.clear()
    pol = ExecutionPolicy(block_shape=(8, 8), autotune=True)
    rng = np.random.default_rng(0)

    def make(cin, cout, k):
        w = prune_conv_weight(
            rng.standard_normal((k, k, cin, cout)).astype(np.float32),
            0.9, (8, 8))
        return weight_align(jnp.asarray(w), None, policy=pol)

    a = make(32, 32, 3)
    b = make(32, 64, 1)
    shape_a, shape_b = (2, 8, 8, 32), (2, 8, 8, 32)
    key_a = autotune.cache_key(a, shape_a, (1, 1), (1, 1), (1, 1),
                               jnp.float32)
    key_b = autotune.cache_key(b, shape_b, (1, 1), (0, 0), (1, 1),
                               jnp.float32)
    assert key_a != key_b
    autotune._CACHE[key_a] = "gathered"
    autotune._CACHE[key_b] = "unroll"

    def consult():
        """What a whole-net trace does: ask choose_arm per conv site
        (key_a used twice — multiplicity)."""
        a1 = autotune.choose_arm(a, pol, shape_a, (1, 1), (1, 1), (1, 1))
        autotune.choose_arm(a, pol, shape_a, (1, 1), (1, 1), (1, 1))
        a2 = autotune.choose_arm(b, pol, shape_b, (1, 1), (0, 0), (1, 1))
        return a1, a2

    yield key_a, key_b, consult, str(tmp_path / "arms.json")
    autotune.clear()


def test_record_keys_collects_hits_with_multiplicity(two_keys):
    key_a, key_b, consult, _ = two_keys
    with autotune.record_keys() as rec:
        consult()
    assert [k for k, _ in rec] == [key_a, key_a, key_b]
    assert dict(rec) == {key_a: "gathered", key_b: "unroll"}


def test_calibrate_flips_losing_key_to_dense_and_persists(two_keys):
    key_a, key_b, consult, path = two_keys

    def time_fn():
        a1, a2 = consult()
        # crafted composed-graph cost: key_a's sparse arm LOSES composed
        # (warm-isolated pick), key_b's genuinely wins
        t = 1.0
        if a1 != "dense":
            t += 0.5
        if a2 != "dense":
            t -= 0.3
        return t

    rep = autotune.calibrate_graph(time_fn, log=lambda m: None)
    assert rep["t_isolated"] == pytest.approx(1.2)
    assert rep["t_dense"] == pytest.approx(1.0)
    assert rep["t_final"] == pytest.approx(0.7)
    assert rep["flips"] == 1
    assert rep["arms"] == {key_a: "dense", key_b: "unroll"}
    # persisted: later runs (and the committed table) serve the calibrated
    # assignment through the ordinary cache path
    assert autotune._CACHE[key_a] == "dense"
    assert autotune._CACHE[key_b] == "unroll"
    with open(path) as fh:
        assert json.load(fh)[key_a] == "dense"
    # overrides cleared: the cache, not the override table, now rules
    assert autotune._OVERRIDES == {}
    assert consult() == ("dense", "unroll")


def test_calibrate_keeps_assignment_that_already_wins(two_keys):
    key_a, key_b, consult, _ = two_keys

    def time_fn():
        a1, a2 = consult()
        t = 1.0
        for arm in (a1, a2):
            if arm != "dense":
                t -= 0.2  # both sparse picks compose fine
        return t

    rep = autotune.calibrate_graph(time_fn, log=lambda m: None)
    assert rep["t_final"] == pytest.approx(0.6)
    assert rep["t_dense"] == pytest.approx(1.0)
    assert autotune._CACHE[key_a] == "gathered"  # untouched
    assert autotune._CACHE[key_b] == "unroll"


def test_calibrate_no_sparse_keys_is_noop():
    autotune.clear()
    rep = autotune.calibrate_graph(lambda: 1.0)
    assert rep["sparse_keys"] == 0 and rep["t_final"] == 1.0


def test_cache_file_invalidated_on_kernel_change(tmp_path, monkeypatch):
    """A cached arm is a measurement of specific kernel code: the cache
    file records a kernel-source fingerprint and is ignored wholesale
    when it doesn't match (stale winners must be re-measured, not
    served)."""
    import json as _json

    path = str(tmp_path / "arms.json")
    monkeypatch.setenv("CESCOIN_AUTOTUNE_CACHE", path)
    autotune.clear()
    autotune._CACHE["k1"] = "gathered"
    autotune._save_file(path)

    # matching fingerprint: entries load
    autotune.clear()
    autotune._load_file(path)
    assert autotune._CACHE.get("k1") == "gathered"

    # stale fingerprint: file ignored
    data = _json.load(open(path))
    data["__kernel_fingerprint__"] = "deadbeefdeadbeef"
    _json.dump(data, open(path, "w"))
    autotune.clear()
    autotune._load_file(path)
    assert "k1" not in autotune._CACHE

    # legacy file without a fingerprint: also treated as stale
    del data["__kernel_fingerprint__"]
    _json.dump(data, open(path, "w"))
    autotune.clear()
    autotune._load_file(path)
    assert "k1" not in autotune._CACHE
    autotune.clear()


def test_calibrate_polish_flips_to_better_alternative(two_keys):
    """polish: even when the isolated assignment stands, a bounded search
    tries alternative arms on high-traffic keys and keeps composed wins."""
    key_a, key_b, consult, _ = two_keys

    def time_fn():
        a1, a2 = consult()
        t = 1.0
        if a1 != "dense":
            t -= 0.1   # key_a's pick ok (stands)...
        if a1 == "gathered_cols":
            t -= 0.2   # ...but an alternative is better composed
        if a2 != "dense":
            t -= 0.1
        return t

    rep = autotune.calibrate_graph(time_fn, polish=8, log=lambda m: None)
    assert rep["t_final"] == pytest.approx(0.6)
    assert rep["polish_trials"] >= 1
    assert rep["arms"][key_a] == "gathered_cols"
    assert autotune._CACHE[key_a] == "gathered_cols"
    assert consult()[0] == "gathered_cols"


def test_cache_key_carries_device_kind(monkeypatch):
    """A table measured on one card is never served on another: the key
    names the backend AND the device kind."""
    pol = ExecutionPolicy(block_shape=(8, 8))
    w = prune_conv_weight(np.random.default_rng(1).standard_normal(
        (3, 3, 16, 16)).astype(np.float32), 0.8, (8, 8))
    al = weight_align(jnp.asarray(w), None, policy=pol)
    args = (al, (1, 8, 8, 16), (1, 1), (1, 1), (1, 1), jnp.float32)
    kind = jax.devices()[0].device_kind
    key = autotune.cache_key(*args)
    assert f"cpu:{kind}" in key

    class Dev:
        device_kind = "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(jax, "devices", lambda *a: [Dev()])
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    other = autotune.cache_key(*args)
    assert "gpu:NVIDIA H100 80GB HBM3" in other and other != key


def test_measure_arms_logs_failing_arm(monkeypatch, capsys):
    """An arm that raises is dropped from the timings but never silently:
    its error is printed."""
    from caffe_escoin_tpu.kernels import xla_block_sparse as xbs
    from caffe_escoin_tpu.utils import benchmark

    pol = ExecutionPolicy(block_shape=(8, 8))
    w = prune_conv_weight(np.random.default_rng(2).standard_normal(
        (1, 1, 16, 16)).astype(np.float32), 0.8, (8, 8))
    al = weight_align(jnp.asarray(w), None, policy=pol)

    def broken(*a, **k):
        raise RuntimeError("kernel refused by the compiler")

    monkeypatch.setattr(xbs, "conv_gathered", broken)
    monkeypatch.setattr(benchmark, "device_time", lambda *a, **k: (
        a[0](a[1]), 1e-3)[1])
    times = autotune.measure_arms(al, pol, (1, 4, 4, 16), (1, 1), (0, 0),
                                  (1, 1))
    assert "gathered" not in times and "unroll" in times
    err = capsys.readouterr().err
    assert "arm 'gathered' failed" in err
    assert "kernel refused by the compiler" in err

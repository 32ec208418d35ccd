"""Process set-up (utils/runtime.py) and the device timer's refusal to
stand a host clock in for a missing device timeline (utils/benchmark.py)."""

import types

import jax
import jax.numpy as jnp
import pytest

from caffe_escoin_tpu.utils import benchmark, runtime


def _plane(name, lines):
    """Events are (name, start_ns, duration_ns[, program_id])."""
    return types.SimpleNamespace(name=name, lines=[
        types.SimpleNamespace(name=ln, events=[
            types.SimpleNamespace(
                name=ev[0], start_ns=ev[1], duration_ns=ev[2],
                stats=[("program_id", ev[3])] if len(ev) > 3 else [])
            for ev in evs])
        for ln, evs in lines])


SPAN = benchmark.ITERATION_SPAN
HOST2 = _plane("/host:CPU", [("python", [(SPAN, 0, 100), (SPAN, 200, 100)])])


def test_spans_in_reads_each_execution_on_the_device():
    """Two timed executions of one program: its kernels split by count, and
    each execution's time is its span (gaps between kernels included, a
    wide one too). The device clock is offset from the host's, and events
    without a program (memsets) are not counted."""
    planes = [HOST2, _plane("/device:GPU:0", [
        ("Stream #13(Memset,Compute)", [
            ("memset", 505, 1),
            ("k1", 510, 5, "7"), ("k2", 540, 10, "7"),
            ("k1", 560, 5, "7"), ("k2", 590, 20, "7")]),
        ("Stream #14(MemcpyD2D)", [("copy", 520, 5, "7"), ("copy", 570, 5, "7")]),
    ])]
    assert benchmark.spans_in(planes) == pytest.approx([40e-9, 50e-9])


def test_spans_in_cycles_programs():
    """device_time_cycle: two closures (programs), one execution each."""
    planes = [HOST2, _plane("/device:GPU:0", [("Stream #13(Compute)", [
        ("a", 10, 5, "1"), ("a", 20, 10, "1"),
        ("b", 300, 5, "2"), ("b", 320, 40, "2")])])]
    assert benchmark.spans_in(planes) == pytest.approx([20e-9, 60e-9])


def test_spans_in_refuses_a_trace_without_device_events():
    planes = [_plane("/host:CPU", [("python", [(SPAN, 0, 100),
                                               ("k1", 10, 5, "7")])]),
              _plane("/device:GPU:0", [("Stream #13(Compute)", [])])]
    with pytest.raises(RuntimeError, match="Stream #13"):
        benchmark.spans_in(planes)


@pytest.mark.parametrize("events", [
    [("k1", 10, 5, "7")],                                  # 1 event, 2 runs
    [("k1", 10, 5, "7"), ("k2", 20, 400, "7")],            # longer than host
    [("a", 10, 5, "1"), ("b", 20, 5, "2"), ("c", 30, 5, "3")],  # 3 programs
])
def test_spans_in_refuses_events_that_do_not_split(events):
    planes = [HOST2, _plane("/device:GPU:0", [("Stream #13(Compute)",
                                               events)])]
    with pytest.raises(RuntimeError, match="execution|programs"):
        benchmark.spans_in(planes)


def test_device_time_never_falls_back_on_gpu(monkeypatch):
    """A real trace with no device plane (the CPU's) under a backend that
    claims to be a GPU: device_time raises instead of timing on the host."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    called = []
    monkeypatch.setattr(benchmark, "slope_time",
                        lambda *a, **k: called.append(1) or 1.0)
    assert benchmark.timer_name() == "device-trace"
    with pytest.raises(RuntimeError, match="device plane"):
        benchmark.device_time(lambda x: x * 2, jnp.ones((8,)), iters=2)
    assert not called


def test_device_time_on_cpu_is_the_named_host_clock():
    assert benchmark.timer_name() == "host-slope"
    t = benchmark.device_time(lambda x: x * 2, jnp.ones((64,)), iters=2)
    assert t > 0


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.append((k, v)))
    assert runtime.setup_compile_cache() == str(tmp_path)
    assert not [k for k, _ in updates if k == "jax_compilation_cache_dir"]


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    path = runtime.setup_compile_cache()
    assert path == runtime.COMPILE_CACHE
    assert updates["jax_compilation_cache_dir"] == path
    assert path.startswith(runtime.CHECKOUT)
    assert path.endswith(".jax_cache")


@pytest.mark.parametrize("name", ["auto", "cpu"])
def test_select_platform(name):
    assert runtime.select_platform(name) == "cpu"


def test_select_platform_rejects_unknown():
    with pytest.raises(ValueError, match="platform"):
        runtime.select_platform("metal")

"""Solver tests mirroring `src/caffe/test/test_gradient_based_solver.cpp`:
analytic update checks, all six solver types, snapshot/restore round-trips,
LR policies, clipping, L1/L2 regularization."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from caffe_escoin_tpu.engine import solvers
from caffe_escoin_tpu.engine.checkpoint import load_checkpoint, save_checkpoint
from caffe_escoin_tpu.engine.lr_policies import learning_rate
from caffe_escoin_tpu.engine.solver import Solver
from caffe_escoin_tpu.engine.solvers import SolverConfig
from caffe_escoin_tpu.models import lenet
from caffe_escoin_tpu.nn import Net

ALL_SOLVERS = ["sgd", "nesterov", "adagrad", "rmsprop", "adadelta", "adam"]


def _toy():
    params = {"layer": {"w": jnp.array([1.0, -2.0, 3.0])}}
    grads = {"layer": {"w": jnp.array([0.5, 0.5, -1.0])}}
    return params, grads


def test_sgd_momentum_analytic():
    cfg = SolverConfig(solver_type="sgd", momentum=0.9)
    params, grads = _toy()
    state = solvers.init_state(cfg, params)
    lr = 0.1
    p1, s1 = solvers.update(cfg, params, grads, state, lr)
    # v1 = lr*g ; w1 = w - v1
    np.testing.assert_allclose(np.asarray(p1["layer"]["w"]),
                               np.array([1.0, -2.0, 3.0]) - 0.1 * np.array([0.5, 0.5, -1.0]),
                               rtol=1e-6)
    p2, s2 = solvers.update(cfg, p1, grads, s1, lr)
    v2 = 0.9 * 0.1 * np.array([0.5, 0.5, -1.0]) + 0.1 * np.array([0.5, 0.5, -1.0])
    np.testing.assert_allclose(np.asarray(p2["layer"]["w"]),
                               np.asarray(p1["layer"]["w"]) - v2, rtol=1e-6)


def test_nesterov_analytic():
    cfg = SolverConfig(solver_type="nesterov", momentum=0.5)
    params, grads = _toy()
    state = solvers.init_state(cfg, params)
    p1, s1 = solvers.update(cfg, params, grads, state, 0.1)
    g = np.array([0.5, 0.5, -1.0])
    v1 = 0.1 * g
    upd = 1.5 * v1  # (1+m)*v1 - m*0
    np.testing.assert_allclose(np.asarray(p1["layer"]["w"]),
                               np.array([1.0, -2.0, 3.0]) - upd, rtol=1e-6)


def test_adagrad_analytic():
    cfg = SolverConfig(solver_type="adagrad", delta=1e-7)
    params, grads = _toy()
    state = solvers.init_state(cfg, params)
    p1, _ = solvers.update(cfg, params, grads, state, 0.1)
    g = np.array([0.5, 0.5, -1.0])
    expect = np.array([1.0, -2.0, 3.0]) - 0.1 * g / (np.abs(g) + 1e-7)
    np.testing.assert_allclose(np.asarray(p1["layer"]["w"]), expect, rtol=1e-5)


def test_adam_analytic():
    cfg = SolverConfig(solver_type="adam", adam_beta1=0.9, adam_beta2=0.999,
                       delta=1e-8)
    params, grads = _toy()
    state = solvers.init_state(cfg, params)
    p1, _ = solvers.update(cfg, params, grads, state, 0.1, it=1)
    g = np.array([0.5, 0.5, -1.0])
    m = 0.1 * g
    v = 0.001 * g * g
    corr = math.sqrt(1 - 0.999) / (1 - 0.9)
    expect = np.array([1.0, -2.0, 3.0]) - 0.1 * corr * m / (np.sqrt(v) + 1e-8)
    np.testing.assert_allclose(np.asarray(p1["layer"]["w"]), expect, rtol=1e-5)


@pytest.mark.parametrize("solver_type", ALL_SOLVERS)
def test_solver_reduces_loss_on_regression(solver_type):
    """All solvers must reduce loss on a tiny least-squares problem (the
    reference's RunLeastSquaresSolver pattern)."""
    from caffe_escoin_tpu.nn import LayerSpec

    specs = [
        LayerSpec("ip", "InnerProduct", ("data",), params=dict(num_output=1)),
        LayerSpec("loss", "EuclideanLoss", ("ip", "target")),
    ]
    net = Net(specs, phase="train")
    # adadelta's effective step is scaled by sqrt(h2/h) which starts near
    # sqrt(delta); Caffe's adadelta examples use base_lr 1.0 and rely on many
    # iterations (examples/mnist/lenet_solver_adadelta.prototxt)
    if solver_type == "adadelta":
        cfg = SolverConfig(solver_type=solver_type, base_lr=1.0, momentum=0.9,
                           delta=1e-3)
    else:
        cfg = SolverConfig(solver_type=solver_type, base_lr=0.05, momentum=0.5)
    solver = Solver(net, cfg, display=0)
    solver.init({"data": (8, 4), "target": (8, 1)})

    rng = np.random.default_rng(0)
    w_true = rng.standard_normal((4, 1)).astype(np.float32)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    y = x @ w_true

    batch = {"data": jnp.asarray(x), "target": jnp.asarray(y)}
    loss0 = float(net.loss(solver.params, batch))
    solver.step(iter([batch] * 60), 50, log=lambda s: None)
    loss1 = float(net.loss(solver.params, batch))
    assert loss1 < loss0 * 0.7, (solver_type, loss0, loss1)


def test_snapshot_restore_roundtrip(tmp_path):
    from caffe_escoin_tpu.nn import LayerSpec

    specs = [
        LayerSpec("ip", "InnerProduct", ("data",), params=dict(num_output=2)),
        LayerSpec("loss", "SoftmaxWithLoss", ("ip", "label")),
    ]
    net = Net(specs, phase="train")
    cfg = SolverConfig(solver_type="adam", base_lr=0.01)
    s1 = Solver(net, cfg, snapshot_prefix=str(tmp_path / "snap"), display=0)
    s1.init({"data": (4, 3), "label": (4,)})
    batch = {"data": jnp.ones((4, 3)), "label": jnp.array([0, 1, 0, 1])}
    s1.step(iter([batch] * 10), 5, log=lambda s: None)
    path = s1.snapshot()

    # continue 5 more steps
    s1.step(iter([batch] * 10), 5, log=lambda s: None)
    ref = jax.device_get(s1.params)

    # restore into a fresh solver, replay the same 5 steps
    s2 = Solver(net, cfg, display=0)
    s2.init({"data": (4, 3), "label": (4,)})
    s2.restore(path)
    assert s2.iter == 5
    s2.rng = jax.random.PRNGKey(0)
    s1_rng_replay = None  # rngs differ; but this net is deterministic (no dropout)
    s2.step(iter([batch] * 10), 5, log=lambda s: None)
    got = jax.device_get(s2.params)
    for layer in ref:
        for k in ref[layer]:
            np.testing.assert_allclose(got[layer][k], ref[layer][k], rtol=1e-5,
                                       atol=1e-6)


def test_checkpoint_format_roundtrip(tmp_path):
    params = {"a": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                    "b": np.zeros(3, np.float32)}}
    state = {"h": {"a": {"w": np.ones((2, 3), np.float32),
                         "b": np.ones(3, np.float32)}}}
    save_checkpoint(str(tmp_path / "c"), params, solver_state=state,
                    meta={"iter": 7})
    p, s, meta = load_checkpoint(str(tmp_path / "c"))
    assert meta["iter"] == 7
    np.testing.assert_array_equal(p["a"]["w"], params["a"]["w"])
    np.testing.assert_array_equal(s["h"]["a"]["b"], state["h"]["a"]["b"])


def test_lr_policies():
    assert learning_rate(10, base_lr=1.0, policy="fixed") == 1.0
    assert learning_rate(10, base_lr=1.0, policy="step", gamma=0.1,
                         step_size=5) == pytest.approx(0.01)
    assert learning_rate(2, base_lr=1.0, policy="exp", gamma=0.5) == 0.25
    assert learning_rate(3, base_lr=1.0, policy="multistep", gamma=0.1,
                         stepvalues=(2, 5)) == pytest.approx(0.1)
    assert learning_rate(50, base_lr=1.0, policy="poly", power=1.0,
                         max_iter=100) == pytest.approx(0.5)
    assert learning_rate(100000, base_lr=2.0, policy="inv", gamma=1e-4,
                         power=0.75) < 2.0


def test_clip_gradients():
    cfg = SolverConfig(clip_gradients=1.0)
    grads = {"l": {"w": jnp.array([3.0, 4.0])}}  # norm 5
    clipped = solvers.clip_gradients(cfg, grads)
    np.testing.assert_allclose(np.asarray(clipped["l"]["w"]),
                               np.array([0.6, 0.8]), rtol=1e-6)


def test_regularization_l1_l2():
    cfg2 = SolverConfig(weight_decay=0.1, regularization_type="L2")
    cfg1 = SolverConfig(weight_decay=0.1, regularization_type="L1")
    params = {"l": {"w": jnp.array([2.0, -3.0])}}
    grads = {"l": {"w": jnp.zeros(2)}}
    g2 = solvers.regularize(cfg2, params, grads)
    np.testing.assert_allclose(np.asarray(g2["l"]["w"]), [0.2, -0.3], rtol=1e-6)
    g1 = solvers.regularize(cfg1, params, grads)
    np.testing.assert_allclose(np.asarray(g1["l"]["w"]), [0.1, -0.1], rtol=1e-6)
    # per-layer override (ParamSpec.regularization_type analogue)
    gmix = solvers.regularize(cfg2, params, grads, {"l": "L1"})
    np.testing.assert_allclose(np.asarray(gmix["l"]["w"]), [0.1, -0.1], rtol=1e-6)


def test_lr_mult_freezes_and_scales():
    """ParamSpec lr_mult semantics (caffe.proto:300-310): 0 freezes a blob,
    2 doubles its step — checked analytically for sgd and adam."""
    for st in ("sgd", "adam"):
        cfg = SolverConfig(solver_type=st, momentum=0.9)
        params = {"a": {"w": jnp.array([1.0, 2.0]), "b": jnp.array([0.5])},
                  "frozen": {"w": jnp.array([3.0])}}
        grads = {"a": {"w": jnp.array([1.0, 1.0]), "b": jnp.array([1.0])},
                 "frozen": {"w": jnp.array([1.0])}}
        mults = {"a": {"w": 1.0, "b": 2.0}, "frozen": {"w": 0.0}}
        state = solvers.init_state(cfg, params)
        p1, _ = solvers.update(cfg, params, grads, state, 0.1, it=1,
                               lr_mults=mults)
        # frozen blob untouched
        np.testing.assert_allclose(np.asarray(p1["frozen"]["w"]), [3.0])
        # bias stepped exactly 2x the weight step
        dw = float(params["a"]["w"][0] - p1["a"]["w"][0])
        db = float(params["a"]["b"][0] - p1["a"]["b"][0])
        np.testing.assert_allclose(db, 2 * dw, rtol=1e-6)


def test_decay_mult_zero_skips_bias_decay():
    """decay_mult 0 (the Caffe bias convention) must remove the decay term
    for that blob only."""
    cfg = SolverConfig(solver_type="sgd", momentum=0.0, weight_decay=0.1)
    params = {"a": {"w": jnp.array([2.0]), "b": jnp.array([4.0])}}
    grads = {"a": {"w": jnp.array([0.0]), "b": jnp.array([0.0])}}
    dmults = {"a": {"w": 1.0, "b": 0.0}}
    g = solvers.regularize(cfg, params, grads, decay_mults=dmults)
    np.testing.assert_allclose(np.asarray(g["a"]["w"]), [0.2], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(g["a"]["b"]), [0.0])


def test_param_multipliers_from_specs_end_to_end():
    """Solver auto-derives multipliers from LayerSpec param_specs (the
    prototxt `param { lr_mult }` path) and the frozen layer stays put."""
    from caffe_escoin_tpu.nn import LayerSpec

    specs = [
        LayerSpec("fc1", "InnerProduct", ("data",),
                  params=dict(num_output=8,
                              param_specs=[{"lr_mult": 0.0,
                                            "decay_mult": 0.0},
                                           {"lr_mult": 0.0,
                                            "decay_mult": 0.0}])),
        LayerSpec("relu1", "ReLU", ("fc1",), tops=("r1",)),
        LayerSpec("fc2", "InnerProduct", ("r1",),
                  params=dict(num_output=4)),
        LayerSpec("loss", "SoftmaxWithLoss", ("fc2", "label")),
    ]
    net = Net(specs, phase="train")
    cfg = SolverConfig(solver_type="sgd", base_lr=0.1, momentum=0.0,
                       weight_decay=0.01)
    solver = Solver(net, cfg, display=0)
    solver.init({"data": (8, 16), "label": (8,)})
    assert solver.lr_mults["fc1"]["w"] == 0.0
    assert solver.lr_mults["fc2"]["w"] == 1.0
    w0 = np.asarray(solver.params["fc1"]["w"]).copy()
    rng = np.random.default_rng(0)

    def src():
        while True:
            yield {"data": jnp.asarray(rng.standard_normal((8, 16)),
                                       jnp.float32),
                   "label": jnp.asarray(rng.integers(0, 4, 8), jnp.float32)}

    solver.step(src(), 3, log=lambda *a: None)
    np.testing.assert_array_equal(np.asarray(solver.params["fc1"]["w"]), w0)
    assert not np.array_equal(np.asarray(solver.params["fc2"]["w"]),
                              np.zeros(1))
    # fc2 did move
    assert float(np.abs(np.asarray(solver.params["fc2"]["w"])).sum()) > 0


def test_rss_guard_snapshots_and_stops(tmp_path):
    """The host-RSS guard (engine/solver.py): when VmRSS crosses
    rss_limit_gb the loop snapshots and stops cleanly (instead of an OOM
    kill), and a fresh solver restores and continues from the same
    iteration."""
    from caffe_escoin_tpu.nn import LayerSpec

    specs = [
        LayerSpec("ip", "InnerProduct", ("data",), params=dict(num_output=2)),
        LayerSpec("loss", "SoftmaxWithLoss", ("ip", "label")),
    ]
    net = Net(specs, phase="train")
    cfg = SolverConfig(solver_type="sgd", base_lr=0.01)
    s = Solver(net, cfg, snapshot_prefix=str(tmp_path / "rss"), display=0)
    s.init({"data": (4, 3), "label": (4,)})
    s.rss_limit_gb = 1e-6  # any real process exceeds this immediately
    s.rss_check_every = 3
    rng = np.random.default_rng(0)
    batch = {"data": jnp.asarray(rng.standard_normal((4, 3)),
                                 dtype=jnp.float32),
             "label": jnp.asarray([0, 1, 0, 1])}
    msgs = []
    s.step(iter([batch] * 100), 100, log=msgs.append)
    assert s.rss_stopped
    assert s.iter == 3  # stopped at the first check, not after 100
    assert any("RSS" in m for m in msgs)
    # clean continuation in a "fresh process"
    s2 = Solver(net, cfg, snapshot_prefix=str(tmp_path / "rss"), display=0)
    s2.init({"data": (4, 3), "label": (4,)})
    s2.restore(str(tmp_path / "rss") + "_iter_3")
    assert s2.iter == 3
    s2.step(iter([batch] * 10), 10, log=lambda m: None)
    assert s2.iter == 13 and not s2.rss_stopped

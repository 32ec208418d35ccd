"""Gradual (AGP) in-training pruning + group-lasso regularization.

The accuracy experiment (docs/EXPERIMENTS_alexnet.md) measured one-shot
block-90% pruning collapsing AlexNet-scale training to chance; these test
the training-time ramp that fixes it (utils/pruning.agp_sparsity /
PruningSchedule / Solver.set_pruning_schedule) and the block-granular
regularization pressure (engine/solvers.group_lasso_grad — the reference's
`regularization_type` lever, `sgd_solver.cpp:144-206`, at BSC granularity).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from caffe_escoin_tpu.engine import solvers  # noqa: E402
from caffe_escoin_tpu.utils import pruning  # noqa: E402


class TestAgpSchedule:
    def test_endpoints_and_monotone(self):
        kw = dict(start_iter=100, end_iter=1100, final_sparsity=0.9,
                  freq=50)
        assert pruning.agp_sparsity(0, **kw) == 0.0
        assert pruning.agp_sparsity(99, **kw) == 0.0
        assert pruning.agp_sparsity(100, **kw) == 0.0
        assert pruning.agp_sparsity(1100, **kw) == 0.9
        assert pruning.agp_sparsity(10**6, **kw) == 0.9
        vals = [pruning.agp_sparsity(t, **kw) for t in range(100, 1101, 50)]
        assert all(b >= a for a, b in zip(vals, vals[1:]))
        # the cubic ramp front-loads pruning: halfway through, sparsity is
        # already at 7/8 of the target
        assert pruning.agp_sparsity(600, **kw) >= 0.9 * 7 / 8

    def test_freq_quantization(self):
        kw = dict(start_iter=0, end_iter=1000, final_sparsity=0.8, freq=100)
        assert (pruning.agp_sparsity(150, **kw)
                == pruning.agp_sparsity(100, **kw))

    def test_initial_sparsity(self):
        kw = dict(start_iter=0, end_iter=100, final_sparsity=0.9,
                  initial_sparsity=0.5, freq=1)
        assert pruning.agp_sparsity(0, **kw) == 0.5
        assert pruning.agp_sparsity(100, **kw) == 0.9


class TestGradualMasks:
    def test_block_masks_sparsity(self):
        rng = np.random.default_rng(0)
        params = {"conv1": {"w": rng.standard_normal((3, 3, 8, 16)),
                            "b": np.zeros(16)},
                  "fc": {"w": rng.standard_normal((64, 32))}}
        masks = pruning.gradual_masks(params, 0.5, block_shape=(4, 4))
        # conv: 3*3*2*4=72 blocks, half pruned
        m = masks["conv1"]["w"]
        assert m.shape == (3, 3, 8, 16)
        frac = 1.0 - m.mean()
        assert 0.4 <= frac <= 0.6
        assert masks["conv1"]["b"].min() == 1.0  # bias never masked
        assert 0.4 <= 1.0 - masks["fc"]["w"].mean() <= 0.6

    def test_element_masks(self):
        rng = np.random.default_rng(1)
        params = {"fc": {"w": rng.standard_normal((32, 32))}}
        masks = pruning.gradual_masks(params, 0.75, granularity="element")
        assert abs((1.0 - masks["fc"]["w"].mean()) - 0.75) < 0.01

    def test_small_conv_skipped(self):
        rng = np.random.default_rng(2)
        params = {"conv1": {"w": rng.standard_normal((3, 3, 3, 16))}}
        masks = pruning.gradual_masks(params, 0.9)
        assert masks["conv1"]["w"].min() == 1.0  # 3-channel input: dense


class TestGroupLasso:
    def test_gradient_direction_2d(self):
        w = np.zeros((4, 4), np.float32)
        w[:2, :2] = 2.0  # one live 2x2 block
        g = solvers.group_lasso_grad(jnp.asarray(w), (2, 2))
        g = np.asarray(g)
        # live block: w / ||w|| = 2/4 = 0.5; zero blocks: 0
        np.testing.assert_allclose(g[:2, :2], 0.5, atol=1e-5)
        np.testing.assert_allclose(g[2:, 2:], 0.0, atol=1e-6)

    def test_conv_blocks_per_offset(self):
        rng = np.random.default_rng(3)
        w = rng.standard_normal((3, 3, 4, 4)).astype(np.float32)
        g = np.asarray(solvers.group_lasso_grad(jnp.asarray(w), (4, 4)))
        for off in range(9):
            blk = w.reshape(9, 4, 4)[off]
            want = blk / np.sqrt((blk ** 2).sum() + 1e-12)
            np.testing.assert_allclose(g.reshape(9, 4, 4)[off], want,
                                       rtol=1e-4, atol=1e-5)

    def test_regularize_dispatch(self):
        cfg = solvers.SolverConfig(weight_decay=0.1,
                                   regularization_type="group_lasso",
                                   group_block=(2, 2))
        params = {"fc": {"w": jnp.ones((2, 2))}}
        grads = {"fc": {"w": jnp.zeros((2, 2))}}
        out = solvers.regularize(cfg, params, grads)
        np.testing.assert_allclose(np.asarray(out["fc"]["w"]), 0.1 * 0.5,
                                   atol=1e-5)


class TestSolverSchedule:
    def _toy(self):
        from caffe_escoin_tpu.engine.solver import Solver
        from caffe_escoin_tpu.nn.net import LayerSpec, Net

        specs = [
            LayerSpec(name="fc1", type="InnerProduct", bottoms=("data",),
                      tops=("fc1",), params=dict(num_output=32)),
            LayerSpec(name="relu1", type="ReLU", bottoms=("fc1",),
                      tops=("r1",)),
            LayerSpec(name="fc2", type="InnerProduct", bottoms=("r1",),
                      tops=("fc2",), params=dict(num_output=8)),
            LayerSpec(name="loss", type="SoftmaxWithLoss",
                      bottoms=("fc2", "label"), tops=("loss",)),
        ]
        net = Net(specs, phase="train")
        cfg = solvers.SolverConfig(base_lr=0.05, momentum=0.9)
        sol = Solver(net, cfg, display=0)
        sol.init({"data": (8, 16), "label": (8,)})
        return sol

    def _data(self):
        rng = np.random.default_rng(0)

        def it():
            while True:
                x = rng.standard_normal((8, 16)).astype(np.float32)
                y = (x.sum(axis=1) > 0).astype(np.int32) % 8
                yield {"data": jnp.asarray(x), "label": jnp.asarray(y)}
        return it()

    def test_ramp_reaches_target_and_freezes(self):
        sol = self._toy()
        sched = pruning.PruningSchedule(
            final_sparsity=0.75, start_iter=5, end_iter=25, freq=5,
            granularity="element")
        sol.set_pruning_schedule(sched)
        logs = []
        sol.step(self._data(), 40, log=logs.append)
        w1 = np.asarray(sol.params["fc1"]["w"])
        w2 = np.asarray(sol.params["fc2"]["w"])
        assert abs(pruning.sparsity_of(w1) - 0.75) < 0.02
        assert abs(pruning.sparsity_of(w2) - 0.75) < 0.02
        # ramp was gradual: at least 3 distinct intermediate targets logged
        prunes = [ln for ln in logs if ln.startswith("Pruning:")]
        assert len(prunes) >= 3
        # frozen after end_iter: pattern identical across later steps
        pat = (w1 != 0)
        sol.step(self._data(), 5, log=lambda *_: None)
        assert ((np.asarray(sol.params["fc1"]["w"]) != 0) == pat).all()

    def test_block_granularity_masks_blocks(self):
        sol = self._toy()
        sched = pruning.PruningSchedule(
            final_sparsity=0.5, start_iter=0, end_iter=10, freq=2,
            granularity="block", block_shape=(4, 4))
        sol.set_pruning_schedule(sched)
        sol.step(self._data(), 15, log=lambda *_: None)
        w = np.asarray(sol.params["fc1"]["w"])  # (16, 32) -> 4x8 blocks
        blocks = w.reshape(4, 4, 8, 4).transpose(0, 2, 1, 3)
        empt = sum(1 for i in range(4) for j in range(8)
                   if (blocks[i, j] == 0).all())
        assert abs(empt / 32 - 0.5) <= 0.1

    def test_masks_as_argument_no_rebuild(self):
        sol = self._toy()
        sched = pruning.PruningSchedule(
            final_sparsity=0.6, start_iter=2, end_iter=12, freq=2,
            granularity="element")
        sol.set_pruning_schedule(sched)
        # first nonzero target lands at iter 4 (iter 2 ramps from 0)
        sol.step(self._data(), 5, log=lambda *_: None)  # masks turn on
        assert sol.param_masks is not None
        fn_after_on = sol._step_fn
        sol.step(self._data(), 10, log=lambda *_: None)  # ramp updates
        assert sol._step_fn is fn_after_on  # no rebuild across the ramp

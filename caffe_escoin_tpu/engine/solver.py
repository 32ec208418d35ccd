"""Solver driver: the training loop.

Reference: `Solver::Solve/Step/TestAll/Snapshot/Restore`
(`src/caffe/solver.cpp:180-472`). Re-designed functionally: the per-iteration
work (forward+backward over iter_size micro-batches, regularize, clip, solver
update) is ONE jitted function; the Python loop only feeds data and handles
snapshots/tests/signals. On a device mesh the same step function is jitted
with shardings (see parallel/) — data parallelism falls out of batch sharding
with no NCCL-style callback machinery (`parallel.cpp` has no analogue here:
XLA inserts the gradient psum).

Signal handling mirrors `util/signal_handler.cpp` + `tools/caffe.cpp:236-243`:
SIGINT -> stop (snapshot_after_train honored), SIGHUP -> snapshot.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Callable, Dict, Iterator, Optional

import jax
import jax.numpy as jnp
import numpy as np

from caffe_escoin_tpu.engine import solvers
from caffe_escoin_tpu.engine.checkpoint import (load_checkpoint_full,
                                                save_checkpoint)
from caffe_escoin_tpu.engine.lr_policies import learning_rate
from caffe_escoin_tpu.nn.net import Net


def _vm_rss_gb() -> float:
    """Current process VmRSS in GB (0.0 where /proc is unavailable)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS"):
                    return float(line.split()[1]) / 1e6  # kB -> GB
    except OSError:
        pass
    return 0.0


class Solver:
    def __init__(
        self,
        net: Net,
        cfg: solvers.SolverConfig,
        *,
        test_net: Optional[Net] = None,
        test_data_iter: Optional[Iterator[Dict]] = None,
        snapshot_prefix: str = "snapshot",
        snapshot_interval: int = 0,
        test_interval: int = 0,
        test_iters: int = 1,
        display: int = 20,
        average_loss: int = 1,
        rng=None,
        reg_overrides: Optional[Dict[str, str]] = None,
        lr_mults=None,
        decay_mults=None,
    ):
        self.net = net
        self.test_net = test_net
        self.test_data_iter = test_data_iter
        self.cfg = cfg
        self.snapshot_prefix = snapshot_prefix
        self.snapshot_interval = snapshot_interval
        self.test_interval = test_interval
        self.test_iters = test_iters
        self.display = display
        self.average_loss = average_loss
        self.rng = rng if rng is not None else jax.random.PRNGKey(0)
        self.iter = 0
        self.params = None
        self.state = None
        # non-trainable buffers (BatchNorm moving stats): threaded through
        # the step fn, NEVER given to the solver update — the reference pins
        # these blobs with lr_mult 0
        self.net_state = {}
        self._stop = False
        self._snapshot_requested = False
        self._losses = []
        self._step_fn = None
        self.reg_overrides = reg_overrides
        # ParamSpec lr_mult/decay_mult pytrees (caffe.proto:300-310); None
        # auto-derives from the net's param_specs at init()
        self.lr_mults = lr_mults
        self.decay_mults = decay_mults
        self.param_masks = None
        self.pruning_schedule = None
        self._prune_select = None
        self._last_mask_sparsity = None
        # Host-RSS guard, off unless $CESCOIN_RSS_LIMIT_GB is set: a device
        # client that leaks host memory per iteration (scripts/rss_probe.py
        # measures it) would end a long run in an OOM kill. Instead the loop
        # snapshots and stops cleanly when VmRSS crosses the limit; callers
        # respawn a fresh process and `restore()`.
        lim = os.environ.get("CESCOIN_RSS_LIMIT_GB")
        try:
            self.rss_limit_gb: Optional[float] = float(lim) if lim else None
        except ValueError:
            raise ValueError(
                f"CESCOIN_RSS_LIMIT_GB={lim!r} is not a number") from None
        self.rss_check_every = 50
        self.rss_stopped = False

    # ------------------------------------------------------------------
    def set_param_masks(self, masks) -> None:
        """Pin pruned weights at zero during training (masked fine-tuning).

        This is how the framework *produces* the sparse models the
        reference consumed pre-made from GESL/SkimCaffe (`run.sh:3-5`):
        magnitude-prune, then fine-tune with the zero pattern frozen. The
        mask (a 0/1 pytree congruent with params; utils.pruning.masks_of)
        is applied inside the jitted step right after the solver update.
        Masks are a jit ARGUMENT, not a closure: updating their VALUES
        (the AGP ramp does so every schedule step) costs no recompile —
        only turning masking on/off rebuilds the step function.
        """
        had = self.param_masks is not None
        if masks is not None:
            # device-resident once: passing host numpy masks to the jitted
            # step would re-upload the full mask pytree every iteration
            masks = jax.tree_util.tree_map(jnp.asarray, masks)
        self.param_masks = masks
        if (masks is not None) != had:
            self._step_fn = None  # masked-ness changed: rebuild

    # ------------------------------------------------------------------
    def set_pruning_schedule(self, schedule, select=None) -> None:
        """Gradual in-training pruning (utils.pruning.PruningSchedule).

        At every ``schedule.freq`` iterations inside [start_iter,
        end_iter] the target sparsity follows the AGP cubic ramp
        (utils.pruning.agp_sparsity) and masks are recomputed from the
        CURRENT weights (utils.pruning.gradual_masks); after end_iter the
        final mask stays frozen (masked fine-tuning). This is the
        training-time route to ACCURATE block-sparse models — one-shot
        block pruning can collapse AlexNet to chance, which gradual
        ramping avoids; see the reference's
        regularization-pressure lever (`sgd_solver.cpp:144-206`) for the
        analogous (weaker) capability."""
        self.pruning_schedule = schedule
        self._prune_select = select
        self._last_mask_sparsity = None

    # ------------------------------------------------------------------
    def _maybe_update_masks(self, log=print) -> None:
        sched = self.pruning_schedule
        if sched is None or self.iter < sched.start_iter:
            return
        freq = max(1, sched.freq)
        due = (self.iter - sched.start_iter) % freq == 0
        # one final recompute at/after end_iter, then frozen
        past_end = self.iter >= sched.end_iter
        if past_end and self._last_mask_sparsity == sched.final_sparsity:
            return
        if not due and not past_end:
            return
        from caffe_escoin_tpu.utils import pruning as _pr

        s = _pr.agp_sparsity(
            self.iter, start_iter=sched.start_iter,
            end_iter=sched.end_iter, freq=freq,
            final_sparsity=sched.final_sparsity,
            initial_sparsity=sched.initial_sparsity)
        if s <= 0 or s == self._last_mask_sparsity and not past_end:
            return
        masks = _pr.gradual_masks(
            self.params, s, granularity=sched.granularity,
            block_shape=sched.block_shape, select=self._prune_select)
        self.set_param_masks(masks)
        # apply immediately so the sparsity the log reports is real
        self.params = jax.tree_util.tree_map(
            lambda p, m: p * m, self.params, self.param_masks)
        self._last_mask_sparsity = sched.final_sparsity if past_end else s
        log(f"Pruning: iteration {self.iter}, target sparsity {s:.4f} "
            f"({sched.granularity})")

    # ------------------------------------------------------------------
    def init(self, input_shapes: Dict[str, tuple]):
        self.rng, sub = jax.random.split(self.rng)
        self.params, self.net_state = self.net.init_with_state(
            sub, input_shapes)
        self.state = solvers.init_state(self.cfg, self.params)
        if self.lr_mults is None and self.decay_mults is None:
            self.lr_mults, self.decay_mults = solvers.param_multipliers(
                self.net, self.params)
        return self.params

    # ------------------------------------------------------------------
    def _build_step(self):
        net, cfg = self.net, self.cfg
        with_masks = self.param_masks is not None
        self._step_has_masks = with_masks

        def step(params, state, net_state, batches, lr, it, rng,
                 masks=None):
            """batches: pytree stacked over iter_size on axis 0."""

            def loss_of(p, ns, batch, r):
                return net.loss(p, batch, train=True, rng=r, state=ns,
                                return_state=True)

            def micro(i, acc):
                grads_acc, loss_acc, ns = acc
                batch = jax.tree_util.tree_map(lambda x: x[i], batches)
                r = jax.random.fold_in(rng, i)
                (loss, ns), g = jax.value_and_grad(loss_of, has_aux=True)(
                    params, ns, batch, r)
                grads_acc = jax.tree_util.tree_map(
                    lambda a, b: a + b, grads_acc, g
                )
                return grads_acc, loss_acc + loss, ns

            zero_g = jax.tree_util.tree_map(jnp.zeros_like, params)
            grads, loss, new_net_state = jax.lax.fori_loop(
                0, cfg.iter_size, micro, (zero_g, 0.0, net_state)
            )
            # Normalize (sgd_solver.cpp:102-118)
            if cfg.iter_size > 1:
                grads = jax.tree_util.tree_map(
                    lambda g: g / cfg.iter_size, grads
                )
            grads = solvers.regularize(cfg, params, grads, self.reg_overrides,
                                       decay_mults=self.decay_mults)
            grads = solvers.clip_gradients(cfg, grads)
            new_params, new_state = solvers.update(
                cfg, params, grads, state, lr, it, lr_mults=self.lr_mults
            )
            if with_masks:
                new_params = jax.tree_util.tree_map(
                    lambda p, m: p * m, new_params, masks
                )
            return new_params, new_state, new_net_state, loss / cfg.iter_size

        return jax.jit(step)

    # ------------------------------------------------------------------
    def install_signal_handlers(self):
        def on_sigint(sig, frame):
            self._stop = True

        def on_sighup(sig, frame):
            self._snapshot_requested = True

        signal.signal(signal.SIGINT, on_sigint)
        if hasattr(signal, "SIGHUP"):
            signal.signal(signal.SIGHUP, on_sighup)

    # ------------------------------------------------------------------
    def step(self, data_iter: Iterator[Dict], iters: int,
             log: Callable[[str], None] = print):
        start = self.iter
        while self.iter < start + iters and not self._stop:
            self._maybe_update_masks(log=log)
            if self._step_fn is None:
                self._step_fn = self._build_step()
            if (self.test_interval and self.test_net is not None
                    and self.iter % self.test_interval == 0):
                # TestAll every test_interval (solver.cpp:191-195)
                self.test_all(data_iter=self.test_data_iter, log=log)
            batch = next(data_iter)
            # stack iter_size micro-batches (iter_size==1: add axis)
            if self.cfg.iter_size == 1:
                batches = jax.tree_util.tree_map(lambda x: x[None], batch)
            else:
                extra = [next(data_iter) for _ in range(self.cfg.iter_size - 1)]
                batches = jax.tree_util.tree_map(
                    lambda *xs: jnp.stack(xs), batch, *extra
                )
            lr = learning_rate(
                self.iter, base_lr=self.cfg.base_lr, policy=self.cfg.lr_policy,
                gamma=self.cfg.gamma, step_size=self.cfg.step_size,
                stepvalues=self.cfg.stepvalues, power=self.cfg.power,
                max_iter=self.cfg.max_iter,
            )
            self.rng, sub = jax.random.split(self.rng)
            step_args = (self.params, self.state, self.net_state, batches,
                         jnp.float32(lr), jnp.int32(self.iter + 1), sub)
            if getattr(self, "_step_has_masks", False):
                # masks ride as a jit argument: AGP ramp updates change
                # their VALUES every schedule step with zero recompiles
                step_args = step_args + (self.param_masks,)
            self.params, self.state, self.net_state, loss = self._step_fn(
                *step_args)
            self._losses.append(float(loss))
            if len(self._losses) > self.average_loss:
                self._losses.pop(0)
            if self.display and self.iter % self.display == 0:
                smoothed = float(np.mean(self._losses))
                log(f"Iteration {self.iter}, lr = {lr:.6g}, "
                    f"loss = {smoothed:.6g}")
            self.iter += 1
            if (self.snapshot_interval and
                    self.iter % self.snapshot_interval == 0):
                self.snapshot()
            if self._snapshot_requested:
                self.snapshot()
                self._snapshot_requested = False
            if (self.rss_limit_gb is not None
                    and self.iter % self.rss_check_every == 0
                    and _vm_rss_gb() > self.rss_limit_gb):
                path = self.snapshot()
                self.rss_stopped = True
                log(f"Iteration {self.iter}: host RSS "
                    f"{_vm_rss_gb():.1f} GB > limit {self.rss_limit_gb} GB "
                    f"(host-RSS guard) — snapshotted to {path}, "
                    "stopping; restore() in a fresh process to continue")
                break
        return self.params

    # ------------------------------------------------------------------
    def solve(self, data_iter, iters: int, *, snapshot_after_train=True,
              log=print):
        self.step(data_iter, iters, log=log)
        if snapshot_after_train:
            self.snapshot()
        return self.params

    # ------------------------------------------------------------------
    def test_all(self, data_iter=None, log=print):
        if data_iter is None:
            data_iter = self.test_data_iter
        if self.test_net is None or data_iter is None:
            return {}
        if getattr(self, "_test_fwd", None) is None:
            # cache the jitted test forward: a fresh lambda per call would
            # recompile the whole test net at every test_interval
            self._test_fwd = jax.jit(
                lambda p, ns, b: self.test_net.apply(p, b, state=ns,
                                                     train=False))
        fwd = self._test_fwd
        metrics: Dict[str, list] = {}
        for _ in range(self.test_iters):
            out = fwd(self.params, self.net_state, next(data_iter))
            for k, v in out.items():
                if np.ndim(v) == 0:
                    metrics.setdefault(k, []).append(float(v))
        result = {k: float(np.mean(v)) for k, v in metrics.items()}
        for k, v in result.items():
            log(f"    Test net output: {k} = {v:.4g}")
        return result

    # ------------------------------------------------------------------
    def snapshot(self):
        path = f"{self.snapshot_prefix}_iter_{self.iter}"
        save_checkpoint(path, self.params, solver_state=self.state,
                        net_state=self.net_state,
                        meta={"iter": self.iter,
                              "solver_type": self.cfg.solver_type})
        return path

    def restore(self, path: str):
        params, state, net_state, meta = load_checkpoint_full(path)
        self.params = jax.tree_util.tree_map(jnp.asarray, params)
        if state is not None:
            self.state = jax.tree_util.tree_map(jnp.asarray, state)
        if net_state is not None:
            self.net_state = jax.tree_util.tree_map(jnp.asarray, net_state)
        self.iter = int(meta.get("iter", 0))
        return self.params

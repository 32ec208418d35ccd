"""Centered finite-difference gradient checker.

A re-make of the reference's `GradientChecker`
(`include/caffe/test/test_gradient_check_util.hpp:18-60`), the utility nearly
every reference layer test uses to validate analytic backward passes. Here the
analytic gradient is `jax.grad`, so the checker's job shifts: it validates the
*composition* — custom epilogues, masking contracts, loss_weight accumulation,
straight-through tricks — against ground-truth finite differences, not
hand-written backward kernels.

Kink handling (the reference's `kink_`/`kink_range_`): non-smooth ops (ReLU,
max-eltwise, hinge) have no defined derivative at the kink and an FD estimate
straddling it is garbage. The caller supplies, per element of the checked
argument, its distance to the nearest kink; elements closer than
``kink_range`` are skipped — same contract as the reference's scalar kink.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np


def fd_gradients(fn: Callable, args, *, wrt: int = 0, eps: float = 1e-3):
    """Centered-difference gradient of scalar ``fn(*args)`` w.r.t.
    ``args[wrt]``, all elements perturbed in one vmapped batch."""
    x0 = np.asarray(args[wrt], np.float32)
    n = x0.size

    def fn_x(x):
        a = list(args)
        a[wrt] = x
        return fn(*a)

    eye = np.eye(n, dtype=np.float32) * eps
    flat = x0.ravel()[None, :]
    xs = np.concatenate([flat + eye, flat - eye]).reshape((2 * n,) + x0.shape)
    vals = jax.vmap(jax.jit(fn_x))(jnp.asarray(xs))
    vals = np.asarray(vals, np.float64)
    return ((vals[:n] - vals[n:]) / (2.0 * eps)).reshape(x0.shape)


def check_gradient(
    fn: Callable,
    args,
    *,
    wrt: int = 0,
    eps: float = 1e-3,
    threshold: float = 1e-2,
    kink: Optional[np.ndarray] = None,
    kink_range: float = 0.0,
) -> None:
    """Assert jax.grad(fn, wrt)(*args) matches centered finite differences.

    Tolerance is the reference's scale-aware bound
    (`test_gradient_check_util.hpp:157-166`):
        |analytic - estimated| <= threshold * max(1, |analytic|, |estimated|)

    ``kink``: per-element distance to the nearest non-smooth point of
    args[wrt] (e.g. |x| for ReLU); elements with kink < kink_range are
    excluded from the comparison.
    """
    analytic = np.asarray(
        jax.grad(lambda *a: fn(*a), argnums=wrt)(*args), np.float64
    )
    estimated = fd_gradients(fn, args, wrt=wrt, eps=eps)
    mask = np.ones(analytic.shape, bool)
    if kink is not None and kink_range > 0:
        mask &= np.asarray(kink) >= kink_range
    assert mask.any(), "kink range excluded every element"
    scale = np.maximum(1.0, np.maximum(np.abs(analytic), np.abs(estimated)))
    err = np.abs(analytic - estimated) / scale
    bad = (err > threshold) & mask
    if bad.any():
        idx = tuple(np.argwhere(bad)[0])
        raise AssertionError(
            f"gradient mismatch at {idx} ({int(bad.sum())}/{mask.sum()} "
            f"checked elements): analytic={analytic[idx]:.6g} "
            f"fd={estimated[idx]:.6g} relerr={err[idx]:.3g} "
            f"(threshold {threshold})"
        )

"""GPU test lane: the sparse executors compiled for the card, against the
float32 oracle.

The CPU lane runs the Pallas kernel in interpreter mode, which knows
nothing of the GPU compiler's limits (block shapes, shared memory,
registers); this small marked suite compiles the kernels for the card.
Run on the machine with the GPU:

    CESCOIN_GPU_TESTS=1 python -m pytest -m gpu tests/test_on_chip.py

`chip_smoke.py` runs the same lane. Elsewhere every test skips in its
fixture.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU backend (got {jax.default_backend()}): "
                    "CESCOIN_GPU_TESTS=1 python -m pytest -m gpu "
                    "tests/test_on_chip.py")
    return jax.devices()[0]


def _oracle(x, w, pad, stride=(1, 1)):
    return lax.conv_general_dilated(
        x, w, stride, [pad, pad],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), precision="highest")


def _setup(cin, cout, k, sparsity, seed=0):
    from caffe_escoin_tpu.engine.context import ExecutionPolicy
    from caffe_escoin_tpu.sparse.weight_align import weight_align
    from caffe_escoin_tpu.utils.pruning import prune_conv_weight

    rng = np.random.default_rng(seed)
    w = prune_conv_weight(
        rng.standard_normal((k, k, cin, cout)).astype(np.float32) * 0.05,
        sparsity, (128, 128))
    policy = ExecutionPolicy(block_shape=(128, 128))
    aligned = weight_align(w, None, policy=policy)
    x = jnp.asarray(
        rng.standard_normal((2, 10, 10, cin)).astype(np.float32) * 0.1)
    return x, w, aligned, policy


@pytest.mark.parametrize("arm", ["unroll", "gathered"])
def test_xbsp_arms_on_chip(gpu, arm):
    from caffe_escoin_tpu.kernels import xla_block_sparse as xbs

    x, w, aligned, _ = _setup(128, 256, 3, 0.9)
    fn = xbs.conv if arm == "unroll" else xbs.conv_gathered
    out = jax.jit(lambda y: fn(y, aligned, padding=(1, 1)))(
        x.astype(jnp.bfloat16))
    ref = _oracle(x, jnp.asarray(w), (1, 1))
    err = float(jnp.max(jnp.abs(out.astype(jnp.float32) - ref)))
    assert err < 5e-3, f"{arm}: max err {err}"


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 1e-3), ("float32", 1e-5)])
def test_bsc_spmm_pallas_on_chip(gpu, dtype, tol):
    """The Triton-route kernel on a traced pattern with a ragged M tile,
    against jnp.dot of the same operands at HIGHEST precision (relative
    L2; only the summation order differs)."""
    from caffe_escoin_tpu.kernels.bsc_pallas import bsc_spmm_pallas
    from caffe_escoin_tpu.sparse.formats import dense_to_bsc
    from caffe_escoin_tpu.utils.pruning import prune_blocks

    rng = np.random.default_rng(1)
    w = prune_blocks(
        rng.standard_normal((512, 256)).astype(np.float32) * 0.05, 0.9,
        (128, 128))
    bsc = dense_to_bsc(w, (128, 128))
    bsc = jax.tree_util.tree_map(
        lambda l: l.astype(dtype) if l.dtype == jnp.float32 else l, bsc)
    x = jnp.asarray(rng.standard_normal((300, 512)), dtype)
    out = jax.jit(lambda y, b: bsc_spmm_pallas(
        y, b, out_dtype=jnp.float32))(x, bsc)
    wq = jnp.asarray(w).astype(dtype).astype(jnp.float32)
    ref = jnp.dot(x.astype(jnp.float32), wq, precision="highest")
    err = float(jnp.linalg.norm(out.astype(jnp.float32) - ref)
                / jnp.linalg.norm(ref))
    assert err < tol, f"bsc_spmm_pallas {dtype}: rel err {err}"


def test_sparse_fc_spmm_on_chip(gpu):
    from caffe_escoin_tpu.kernels import xla_block_sparse as xbs
    from caffe_escoin_tpu.sparse.formats import dense_to_bsc
    from caffe_escoin_tpu.utils.pruning import prune_blocks

    rng = np.random.default_rng(2)
    w = prune_blocks(
        rng.standard_normal((1024, 512)).astype(np.float32) * 0.05, 0.9,
        (128, 128))
    bsc = dense_to_bsc(w, (128, 128))
    x = jnp.asarray(rng.standard_normal((64, 1024)).astype(np.float32))
    out = jax.jit(lambda y: xbs.spmm(y, bsc))(x.astype(jnp.bfloat16))
    ref = jnp.dot(x, jnp.asarray(w), precision="highest")
    err = float(jnp.max(jnp.abs(out.astype(jnp.float32) - ref)))
    assert err < 5e-2, f"xbsp spmm: max err {err}"


def test_device_timer_reads_the_device_timeline(gpu):
    """device_time reads the device timeline (no host-clock stand-in)."""
    from caffe_escoin_tpu.utils import benchmark

    assert benchmark.timer_name() == "device-trace"
    x = jnp.ones((1024, 1024), jnp.bfloat16)
    t = benchmark.device_time(lambda a: a @ a, x, iters=5)
    assert 0 < t < 0.1

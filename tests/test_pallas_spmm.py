"""Pallas BSC SpMM kernel (Triton route) vs oracle, in interpreter mode on
the CPU; the same kernel compiles for the GPU (tests/test_on_chip.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from caffe_escoin_tpu.engine.context import ConvMode, ExecutionPolicy
from caffe_escoin_tpu.kernels import bsc_pallas
from caffe_escoin_tpu.kernels.bsc_pallas import bsc_spmm_pallas
from caffe_escoin_tpu.kernels.reference import conv2d_reference
from caffe_escoin_tpu.kernels.spmm import bsc_spmm_traced
from caffe_escoin_tpu.ops.conv import conv2d
from caffe_escoin_tpu.sparse import dense_to_bsc
from caffe_escoin_tpu.sparse.weight_align import weight_align
from caffe_escoin_tpu.utils.pruning import prune_blocks, prune_conv_weight


@pytest.mark.parametrize(
    "shape,block,sparsity,m",
    [
        ((256, 256), (128, 128), 0.75, 300),   # ragged last M tile
        ((96, 64), (16, 16), 0.5, 64),
        ((64, 128), (16, 128), 1.0, 16),       # every block pruned
        ((72, 48), (16, 16), 0.9, 10),         # K tail padded, M < tile
        ((40, 32), (16, 16), 0.0, 9),          # dense pattern
    ],
)
def test_bsc_pallas_matches_oracle(rng, shape, block, sparsity, m):
    k, n = shape
    w = prune_blocks(rng.standard_normal((k, n)).astype(np.float32), sparsity, block)
    bsc = dense_to_bsc(w, block)
    a = rng.standard_normal((m, k)).astype(np.float32)
    out = bsc_spmm_pallas(a, bsc, tile_m=64, interpret=True)
    np.testing.assert_allclose(np.asarray(out), a @ w, rtol=1e-4, atol=1e-4)


def test_bsc_pallas_tile_sizes(rng):
    """The M tile changes the grid, never the result."""
    w = prune_blocks(rng.standard_normal((64, 64)).astype(np.float32), 0.5, (16, 16))
    bsc = dense_to_bsc(w, (16, 16))
    a = rng.standard_normal((70, 64)).astype(np.float32)
    ref = a @ w
    for tile_m in [16, 32, 128]:
        out = bsc_spmm_pallas(a, bsc, tile_m=tile_m, interpret=True)
        np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-4, atol=1e-4)


def test_bsc_pallas_bf16(rng):
    w = prune_blocks(rng.standard_normal((64, 64)).astype(np.float32), 0.5, (16, 16))
    bsc = dense_to_bsc(w.astype(np.float32), (16, 16))
    bsc = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x, bsc
    )
    a = rng.standard_normal((16, 64)).astype(np.float32).astype(jnp.bfloat16)
    out = bsc_spmm_pallas(a, bsc, tile_m=16, interpret=True, out_dtype=jnp.float32)
    assert out.dtype == jnp.float32
    ref = np.asarray(a, np.float32) @ np.asarray(
        jnp.asarray(w, jnp.bfloat16), np.float32
    )
    np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-2, atol=2e-2)


def test_conv2d_uses_pallas_path(rng):
    """conv2d with a TRACED pattern + use_pallas/interpret runs the kernel
    through the lowered path and matches the oracle."""
    w = prune_conv_weight(
        rng.standard_normal((3, 3, 16, 32)).astype(np.float32), 0.9, (16, 16)
    )
    b = rng.standard_normal(32).astype(np.float32)
    policy = ExecutionPolicy(block_shape=(16, 16), use_pallas=True,
                             interpret=True)
    aligned = weight_align(w, b, policy=policy)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    out = jax.jit(lambda al, y: conv2d(y, al, padding=(1, 1),
                                       mode=ConvMode.SCONV, policy=policy))(
        aligned, x)
    ref = conv2d_reference(x, w, b, padding=(1, 1))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("block,ok", [
    ((128, 128), True), ((16, 64), True), ((8, 128), False),
    ((96, 128), False), ((128, 24), False),
])
def test_pallas_supported_follows_triton_rules(block, ok):
    w = np.ones((block[0] * 2, block[1] * 2), np.float32)
    assert bsc_pallas.pallas_supported(dense_to_bsc(w, block)) is ok


def test_unsupported_block_shape_raises(rng):
    w = prune_blocks(rng.standard_normal((24, 24)).astype(np.float32), 0.5, (8, 8))
    with pytest.raises(ValueError, match="Triton"):
        bsc_spmm_pallas(np.ones((4, 24), np.float32), dense_to_bsc(w, (8, 8)),
                        interpret=True)


@pytest.mark.parametrize("itemsize,bk,bn", [(2, 128, 128), (4, 128, 128),
                                            (2, 256, 128), (4, 16, 16)])
def test_config_fits_shared_memory(itemsize, bk, bn):
    """Pipelined stages stay under the block's shared-memory budget, tiles
    are powers of two, and a small M shrinks the tile."""
    tile_m, k_chunk, warps, stages = bsc_pallas._config(100000, bk, bn,
                                                        itemsize)
    assert stages >= 1 and warps == 4
    assert tile_m & (tile_m - 1) == 0 and bk % k_chunk == 0
    assert stages * (tile_m * bk + bk * bn) * itemsize <= bsc_pallas._SMEM_BUDGET
    assert bsc_pallas._config(20, bk, bn, itemsize)[0] == 32


def test_traced_dispatch_picks_kernel_or_plain(rng, monkeypatch):
    """bsc_spmm_traced: the kernel when the policy enables it and the blocks
    fit the route; the plain scan otherwise — same numbers either way."""
    w = prune_blocks(rng.standard_normal((64, 48)).astype(np.float32), 0.5, (16, 16))
    bsc = dense_to_bsc(w, (16, 16))
    a = rng.standard_normal((20, 64)).astype(np.float32)
    calls = []
    real = bsc_pallas.bsc_spmm_pallas
    monkeypatch.setattr(bsc_pallas, "bsc_spmm_pallas",
                        lambda *x, **k: calls.append(1) or real(*x, **k))
    on = ExecutionPolicy(use_pallas=True, interpret=True)
    out_k = bsc_spmm_traced(a, bsc, on)
    assert calls == [1]
    out_p = bsc_spmm_traced(a, bsc, ExecutionPolicy())  # CPU: plain scan
    assert calls == [1]
    np.testing.assert_allclose(np.asarray(out_k), a @ w, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(out_p), a @ w, rtol=1e-4, atol=1e-4)


def test_interpret_refused_on_gpu_backend(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with pytest.raises(ValueError, match="interpret"):
        ExecutionPolicy(interpret=True).pallas_enabled()
    assert ExecutionPolicy().pallas_enabled() is True
    assert ExecutionPolicy(use_pallas=False).pallas_enabled() is False


def test_pallas_off_by_default_on_cpu():
    assert ExecutionPolicy().pallas_enabled() is False
    assert ExecutionPolicy(interpret=True).pallas_enabled() is True

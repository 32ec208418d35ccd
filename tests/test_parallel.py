"""Multi-device tests on the virtual 8-device CPU mesh: data parallelism,
spatial halo exchange, tensor (cout) partitioning.

The reference could only test multi-GPU on real hardware
(`test_gradient_based_solver.cpp:199-210`); the virtual mesh lets sharding
semantics be CI-tested, with the driver's dryrun validating the same code
multi-chip."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from caffe_escoin_tpu.engine.context import ConvMode, ExecutionPolicy
from caffe_escoin_tpu.engine.solvers import SolverConfig
from caffe_escoin_tpu.kernels.reference import conv2d_reference
from caffe_escoin_tpu.models import lenet
from caffe_escoin_tpu.nn import Net
from caffe_escoin_tpu.parallel import dp, halo, mesh as mesh_lib, tp
from caffe_escoin_tpu.sparse.weight_align import weight_align
from caffe_escoin_tpu.utils.pruning import prune_conv_weight

requires_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


@requires_8
def test_mesh_construction():
    m = mesh_lib.make_mesh(data=4, model=2)
    assert m.shape == {"data": 4, "model": 2}
    m2 = mesh_lib.make_mesh(model=2)
    assert m2.shape == {"data": 4, "model": 2}


@requires_8
def test_dp_train_step_matches_single_device():
    mesh = mesh_lib.make_mesh(data=8, model=1)
    net = Net(lenet.lenet5(include_loss=True), phase="train")
    params = net.init(jax.random.PRNGKey(0), {"data": (16, 28, 28, 1),
                                              "label": (16,)})
    cfg = SolverConfig(solver_type="sgd", base_lr=0.1, momentum=0.9)
    from caffe_escoin_tpu.engine import solvers
    state = solvers.init_state(cfg, params)
    rng = np.random.default_rng(0)
    batch = {"data": jnp.asarray(rng.standard_normal((16, 28, 28, 1)),
                                 jnp.float32),
             "label": jnp.asarray(rng.integers(0, 10, 16))}

    step = dp.make_dp_train_step(net, cfg, mesh)
    p_rep = dp.replicate_params(mesh, params)
    s_rep = dp.replicate_params(mesh, state)
    b_shard = dp.shard_batch(mesh, batch)
    new_p, new_s, _, loss = step(p_rep, s_rep, {}, b_shard, jnp.float32(0.1),
                                 jnp.int32(1), jax.random.PRNGKey(1))

    # single-device reference
    def loss_of(p):
        return net.loss(p, batch, train=True, rng=jax.random.PRNGKey(1))

    l0, grads = jax.value_and_grad(loss_of)(params)
    g0 = solvers.regularize(cfg, params, grads)
    ref_p, _ = solvers.update(cfg, params, g0, state, 0.1)
    np.testing.assert_allclose(float(loss), float(l0), rtol=1e-5)
    for name in ref_p:
        for k in ref_p[name]:
            np.testing.assert_allclose(
                np.asarray(new_p[name][k]), np.asarray(ref_p[name][k]),
                rtol=1e-4, atol=1e-5,
            )


@requires_8
@pytest.mark.parametrize("model_axis", [2, 4])
def test_halo_spatial_conv_matches_dense(rng, model_axis):
    mesh = mesh_lib.make_mesh(data=8 // model_axis, model=model_axis)
    x = rng.standard_normal((2, 16, 12, 8)).astype(np.float32)
    w = rng.standard_normal((3, 3, 8, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    out = halo.spatial_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              mesh=mesh, kernel=(3, 3), padding=(1, 1))
    ref = conv2d_reference(x, w, b, padding=(1, 1))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


@requires_8
def test_halo_spatial_sparse_conv_matches_dense(rng):
    """Halo exchange + the XBSP direct sconv on a 4-way spatial partition —
    the BASELINE config-5 execution pattern."""
    mesh = mesh_lib.make_mesh(data=2, model=4)
    policy = ExecutionPolicy(block_shape=(16, 16))
    w = prune_conv_weight(rng.standard_normal((3, 3, 16, 32)).astype(np.float32),
                          0.85, (16, 16))
    b = rng.standard_normal(32).astype(np.float32)
    aligned = weight_align(w, b, policy=policy)
    x = rng.standard_normal((2, 16, 8, 16)).astype(np.float32)
    out = halo.spatial_sconv2d(jnp.asarray(x), aligned, mesh=mesh,
                               padding=(1, 1), policy=policy)
    ref = conv2d_reference(x, w, b, padding=(1, 1))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


@requires_8
def test_tp_lowered_sparse_conv(rng):
    """Cout-block-partitioned BSC SpMM over 4 devices == dense oracle."""
    mesh = mesh_lib.make_mesh(data=2, model=4)
    policy = ExecutionPolicy(block_shape=(16, 8), use_pallas=False)
    w = prune_conv_weight(rng.standard_normal((3, 3, 16, 64)).astype(np.float32),
                          0.8, (16, 8))
    b = rng.standard_normal(64).astype(np.float32)
    aligned = weight_align(w, b, policy=policy)
    assert aligned.bsc.n_bcols % 4 == 0
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    out = tp.tp_conv_lowered(jnp.asarray(x), aligned, mesh=mesh,
                             padding=(1, 1), policy=policy)
    ref = conv2d_reference(x, w, b, padding=(1, 1))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


@requires_8
def test_gspmd_param_shardings(rng):
    """Whole-net jit with TP weight shardings compiles and matches."""
    mesh = mesh_lib.make_mesh(data=4, model=2)
    net = Net(lenet.lenet5())
    params = net.init(jax.random.PRNGKey(0), {"data": (4, 28, 28, 1)})
    shardings = tp.param_shardings(net, params, mesh)
    p_sharded = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, s), params, shardings,
        is_leaf=lambda x: isinstance(x, NamedSharding),
    )
    x = {"data": jnp.asarray(rng.standard_normal((4, 28, 28, 1)), jnp.float32)}
    out = jax.jit(lambda p, x: net.apply(p, x))(p_sharded, x)["prob"]
    ref = net.apply(params, x)["prob"]
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def test_scaling_harness_two_devices():
    """tools/scaling.py measures batch-sharded sparse inference on a
    sub-mesh and reports per-device throughput + efficiency."""
    from caffe_escoin_tpu.tools.scaling import measure

    r1 = measure("lenet", 1, 4, 0.9, iters=1)
    r2 = measure("lenet", 2, 4, 0.9, iters=1)
    assert r1["devices"] == 1 and r2["devices"] == 2
    assert r2["batch"] == 8
    assert r1["gnnz_per_s_per_dev"] > 0 and r2["gnnz_per_s_per_dev"] > 0


@requires_8
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_halo_xbsp_engine_matches_dense(rng, shards):
    """The performance-bearing XBSP arm inside the spatial partition:
    2/4/8-way H shards vs the single-device oracle."""
    mesh = mesh_lib.make_mesh(data=8 // shards, model=shards)
    policy = ExecutionPolicy(block_shape=(8, 8))
    w = prune_conv_weight(
        rng.standard_normal((3, 3, 16, 32)).astype(np.float32), 0.8, (1, 8))
    b = rng.standard_normal(32).astype(np.float32)
    aligned = weight_align(w, b, policy=policy)
    x = rng.standard_normal((2, 16, 8, 16)).astype(np.float32)
    out = halo.spatial_sconv2d(jnp.asarray(x), aligned, mesh=mesh,
                               padding=(1, 1), policy=policy)
    ref = conv2d_reference(x, w, b, padding=(1, 1))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


@requires_8
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("k,pad", [(3, 1), (1, 0)])
def test_halo_stride2_at_partition_boundaries(rng, shards, k, pad):
    """Stride-2 across shard boundaries (SURVEY §7 hard part): the
    downsample phase must be shard-invariant. k3p1s2 (stage-entry 3x3) and
    k1p0s2 (ResNet branch1 projection) vs the single-device oracle."""
    mesh = mesh_lib.make_mesh(data=8 // shards, model=shards)
    policy = ExecutionPolicy(block_shape=(8, 8))
    w = prune_conv_weight(
        rng.standard_normal((k, k, 16, 32)).astype(np.float32), 0.8, (1, 8))
    b = rng.standard_normal(32).astype(np.float32)
    aligned = weight_align(w, b, policy=policy)
    x = rng.standard_normal((2, 16, 8, 16)).astype(np.float32)
    out = halo.spatial_sconv2d(jnp.asarray(x), aligned, mesh=mesh,
                               padding=(pad, pad), policy=policy,
                               stride=(2, 2))
    ref = conv2d_reference(x, w, b, stride=(2, 2), padding=(pad, pad))
    assert out.shape == ref.shape
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


@requires_8
@pytest.mark.parametrize("shards", [2, 4])
def test_halo_grouped_conv_at_partition_boundaries(rng, shards):
    """Grouped conv (block-diagonal GEMM view) under spatial partitioning
    (SURVEY §7 hard part) vs the single-device oracle."""
    mesh = mesh_lib.make_mesh(data=8 // shards, model=shards)
    policy = ExecutionPolicy(block_shape=(8, 8))
    g = 2
    w = prune_conv_weight(
        rng.standard_normal((3, 3, 8, 32)).astype(np.float32), 0.75, (1, 8))
    b = rng.standard_normal(32).astype(np.float32)
    aligned = weight_align(w, b, groups=g, policy=policy)
    x = rng.standard_normal((2, 16, 8, 16)).astype(np.float32)
    out = halo.spatial_sconv2d(jnp.asarray(x), aligned, mesh=mesh,
                               padding=(1, 1), policy=policy)
    ref = conv2d_reference(x, w, b, padding=(1, 1), groups=g)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


@requires_8
def test_halo_stride_residual_shape_guard():
    """Per-shard rows not divisible by the stride must be rejected loudly."""
    mesh = mesh_lib.make_mesh(data=2, model=4)
    policy = ExecutionPolicy(block_shape=(8, 8))
    w = prune_conv_weight(
        np.random.default_rng(0).standard_normal((3, 3, 8, 16)).astype(
            np.float32), 0.8, (1, 8))
    aligned = weight_align(w, None, policy=policy)
    x = jnp.zeros((1, 12, 8, 8))  # 12 rows / 4 shards = 3, not divisible by 2
    with pytest.raises(ValueError):
        halo.spatial_sconv2d(x, aligned, mesh=mesh, padding=(1, 1),
                             policy=policy, stride=(2, 2))


@requires_8
def test_dp_inference_forward_is_collective_free():
    """The batch-sharded sparse inference forward must lower with ZERO
    cross-device collectives (weights replicated and closed over, batch
    sharded) — the scaling argument: across real devices the only loss
    vs linear is input distribution, so the single-device saturation
    curve (bench.py --batch-curve) carries the efficiency claim. The reference's DP forward was likewise collective-free
    (NCCL only touched gradients, `parallel.cpp:227-256`)."""
    mesh = mesh_lib.make_mesh(data=8, model=1)
    policy = ExecutionPolicy(block_shape=(8, 8))
    w = prune_conv_weight(
        np.random.default_rng(0).standard_normal((3, 3, 16, 32)).astype(
            np.float32), 0.8, (8, 8))
    aligned = weight_align(w, None, policy=policy)
    from caffe_escoin_tpu.ops.conv import conv2d_sconv

    x = jnp.zeros((8, 8, 8, 16))
    shard = NamedSharding(mesh, P("data"))
    fwd = jax.jit(
        lambda y: conv2d_sconv(y, aligned, stride=(1, 1), padding=(1, 1),
                               dilation=(1, 1), relu=False, policy=policy,
                               batch_parallel=True),
        in_shardings=shard)
    txt = fwd.lower(x).compile().as_text()
    for op in ("all-reduce", "all-gather", "reduce-scatter",
               "collective-permute", "all-to-all"):
        assert op not in txt, f"unexpected collective {op} in DP forward"


@requires_8
def test_halo_deep_tower_matches_sequential(rng):
    """spatial_sconv_tower: ONE exchange for a k3 -> 1x1 -> k3 chain ==
    the layerwise global reference (the shard_map-edge amortization)."""
    mesh = mesh_lib.make_mesh(data=2, model=4)
    policy = ExecutionPolicy(block_shape=(16, 16), use_pallas=False)
    ws = [
        prune_conv_weight(
            rng.standard_normal((3, 3, 16, 16)).astype(np.float32), 0.8,
            (16, 16)),
        prune_conv_weight(
            rng.standard_normal((1, 1, 16, 16)).astype(np.float32), 0.8,
            (16, 16)),
        prune_conv_weight(
            rng.standard_normal((3, 3, 16, 32)).astype(np.float32), 0.8,
            (16, 16)),
    ]
    aligneds = [weight_align(w, None, policy=policy) for w in ws]
    x = rng.standard_normal((2, 16, 8, 16)).astype(np.float32)
    out = halo.spatial_sconv_tower(jnp.asarray(x), aligneds, mesh=mesh,
                                   policy=policy, relu=True)
    ref = jnp.asarray(x)
    for w in ws:
        ph = (w.shape[0] - 1) // 2
        ref = conv2d_reference(np.asarray(ref), w, None, padding=(ph, ph))
        ref = jnp.maximum(jnp.asarray(ref), 0.0)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@requires_8
def test_halo_deep_tower_rejects_oversized_halo(rng):
    mesh = mesh_lib.make_mesh(data=2, model=4)
    policy = ExecutionPolicy(block_shape=(16, 16))
    w = prune_conv_weight(
        rng.standard_normal((7, 7, 16, 16)).astype(np.float32), 0.8,
        (16, 16))
    aligneds = [weight_align(w, None, policy=policy)] * 2
    x = rng.standard_normal((1, 8, 8, 16)).astype(np.float32)
    with pytest.raises(ValueError, match="deep halo"):
        halo.spatial_sconv_tower(jnp.asarray(x), aligneds, mesh=mesh,
                                 policy=policy)


@requires_8
def test_halo_chain_matches_sequential(rng):
    """spatial_sconv_chain: ONE shard_map entry, per-layer exchanges, no
    margin duplication — must equal the layerwise global reference."""
    mesh = mesh_lib.make_mesh(data=2, model=4)
    policy = ExecutionPolicy(block_shape=(16, 16), use_pallas=False)
    ws = [
        prune_conv_weight(
            rng.standard_normal((3, 3, 16, 16)).astype(np.float32), 0.8,
            (16, 16)),
        prune_conv_weight(
            rng.standard_normal((1, 1, 16, 16)).astype(np.float32), 0.8,
            (16, 16)),
        prune_conv_weight(
            rng.standard_normal((3, 3, 16, 32)).astype(np.float32), 0.8,
            (16, 16)),
    ]
    aligneds = [weight_align(w, None, policy=policy) for w in ws]
    x = rng.standard_normal((2, 16, 8, 16)).astype(np.float32)
    out = halo.spatial_sconv_chain(jnp.asarray(x), aligneds, mesh=mesh,
                                   policy=policy, relu=True)
    ref = jnp.asarray(x)
    for w in ws:
        ph = (w.shape[0] - 1) // 2
        ref = conv2d_reference(np.asarray(ref), w, None, padding=(ph, ph))
        ref = jnp.maximum(jnp.asarray(ref), 0.0)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)

"""XLA-native static block-sparse conv (kernels/xla_block_sparse.py) vs the
dense oracle — the primary sparse executor's correctness suite, following
the reference-oracle pattern of `src/caffe/test/test_convolution_layer.cpp`.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from caffe_escoin_tpu.engine.context import ConvMode, ExecutionPolicy  # noqa: E402
from caffe_escoin_tpu.kernels import xla_block_sparse  # noqa: E402
from caffe_escoin_tpu.ops import conv as conv_ops  # noqa: E402
from caffe_escoin_tpu.sparse.weight_align import weight_align  # noqa: E402
from caffe_escoin_tpu.utils.pruning import prune_conv_weight  # noqa: E402

POLICY = ExecutionPolicy(block_shape=(128, 128))


def _case(n, h, w, cin, cout, k, pad, sparsity, *, stride=1, dilation=1,
          relu=False, bias=False, seed=0, tol=1e-4):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((n, h, w, cin)).astype(np.float32)
                    * 0.1)
    wt = rng.standard_normal((k, k, cin, cout)).astype(np.float32) * 0.05
    wp = prune_conv_weight(wt, sparsity, (min(128, cin), 128))
    b = (rng.standard_normal(cout).astype(np.float32) * 0.1 if bias else None)
    aligned = weight_align(wp, b, policy=POLICY)
    assert xla_block_sparse.supported(aligned, POLICY)
    out = xla_block_sparse.conv(
        x, aligned, stride=(stride, stride), padding=(pad, pad),
        dilation=(dilation, dilation), relu=relu)
    ref = lax.conv_general_dilated(
        x, jnp.asarray(wp), (stride, stride), [(pad, pad), (pad, pad)],
        rhs_dilation=(dilation, dilation),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), precision="highest")
    if b is not None:
        ref = ref + b
    if relu:
        ref = jnp.maximum(ref, 0.0)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=tol, atol=tol / 10)


@pytest.mark.parametrize("sparsity", [0.5, 0.9, 0.99])
def test_3x3(sparsity):
    _case(2, 14, 14, 256, 256, 3, 1, sparsity)


def test_1x1():
    _case(2, 14, 14, 256, 512, 1, 0, 0.9)


def test_stride2():
    # the reference's tuned kernels never supported stride > 1; XBSP does
    _case(2, 14, 14, 128, 256, 3, 1, 0.9, stride=2)


def test_dilation2():
    _case(2, 14, 14, 128, 128, 3, 2, 0.8, dilation=2)


def test_bias_relu():
    _case(2, 10, 10, 128, 128, 3, 1, 0.9, relu=True, bias=True)


def test_small_channels():
    _case(2, 28, 28, 64, 64, 3, 1, 0.85)


def test_5x5():
    _case(2, 12, 12, 96, 160, 5, 2, 0.8)


def test_unsupported_when_pattern_traced():
    rng = np.random.default_rng(0)
    wt = rng.standard_normal((3, 3, 128, 128)).astype(np.float32) * 0.05
    aligned = weight_align(prune_conv_weight(wt, 0.9, (128, 128)), None,
                           policy=POLICY)

    seen = []

    @jax.jit
    def f(al, x):
        seen.append(xla_block_sparse.supported(al, POLICY))
        return conv_ops.conv2d(x, al, stride=(1, 1), padding=(1, 1),
                               dilation=(1, 1), relu=False, policy=POLICY,
                               mode=ConvMode.SCONV)

    x = jnp.asarray(rng.standard_normal((1, 8, 8, 128)).astype(np.float32))
    out = f(aligned, x)  # falls back to an executor that handles tracers
    assert out.shape == (1, 8, 8, 128)
    assert seen == [False]


def test_dispatch_routes_to_xbsp_when_concrete():
    rng = np.random.default_rng(0)
    wt = rng.standard_normal((3, 3, 128, 128)).astype(np.float32) * 0.05
    wp = prune_conv_weight(wt, 0.9, (128, 128))
    aligned = weight_align(wp, None, policy=POLICY)
    x = jnp.asarray(rng.standard_normal((1, 8, 8, 128)).astype(np.float32))
    out = conv_ops.conv2d(x, aligned, stride=(1, 1), padding=(1, 1),
                          dilation=(1, 1), relu=False, policy=POLICY,
                          mode=ConvMode.SCONV)
    ref = lax.conv_general_dilated(
        x, jnp.asarray(wp), (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), precision="highest")
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("sparsity", [0.7, 0.9])
def test_spmm_static_unroll(sparsity):
    """FC twin of the conv unroll (ops/linear.py fast path) vs dense oracle."""
    from caffe_escoin_tpu.sparse.formats import dense_to_bsc
    from caffe_escoin_tpu.utils.pruning import prune_blocks

    rng = np.random.default_rng(3)
    w = prune_blocks(
        rng.standard_normal((200, 96)).astype(np.float32), sparsity, (8, 16))
    bsc = dense_to_bsc(w, (8, 16))
    x = jnp.asarray(rng.standard_normal((10, 200)).astype(np.float32))
    b = jnp.asarray(rng.standard_normal(96).astype(np.float32))
    out = jax.jit(
        lambda x: xla_block_sparse.spmm(x, bsc, bias=b, relu=True))(x)
    ref = jnp.maximum(x @ jnp.asarray(w) + b, 0.0)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_linear_sparse_routes_to_xbsp():
    from caffe_escoin_tpu.ops import linear as linear_ops
    from caffe_escoin_tpu.sparse.formats import dense_to_bsc
    from caffe_escoin_tpu.utils.pruning import prune_blocks

    rng = np.random.default_rng(4)
    w = prune_blocks(
        rng.standard_normal((64, 48)).astype(np.float32), 0.8, (8, 8))
    bsc = dense_to_bsc(w, (8, 8))
    x = jnp.asarray(rng.standard_normal((3, 2, 64)).astype(np.float32))
    out = jax.jit(lambda x: linear_ops.linear_sparse(x, bsc))(x)
    ref = x @ jnp.asarray(w)
    assert out.shape == (3, 2, 48)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_arm_dispatch_rules():
    """best_arm: unroll for k>1 / reduce-1x1; gathered for expand-1x1;
    dense for full-union expand-1x1 with block-filling cin (the
    write-bound regime)."""
    rng = np.random.default_rng(5)
    pol = ExecutionPolicy(block_shape=(128, 128))

    def align(cin, cout, k, sp):
        w = prune_conv_weight(
            rng.standard_normal((k, k, cin, cout)).astype(np.float32), sp,
            (128, 128))
        return weight_align(w, None, policy=pol)

    assert xla_block_sparse.best_arm(align(256, 256, 3, 0.9), pol) == "unroll"
    assert xla_block_sparse.best_arm(align(512, 256, 1, 0.9), pol) == "unroll"
    # heuristic-path never-lose floor: without measurement, >= 25% live
    # blocks runs dense — the hand rules composed to an e2e loss at 70%
    # sparsity; autotune (the deployment default) measures instead of
    # gating
    assert xla_block_sparse.best_arm(align(256, 128, 1, 0.5), pol) == "dense"
    assert xla_block_sparse.best_arm(align(256, 128, 1, 0.7), pol) == "dense"
    a = align(128, 512, 1, 0.5)  # K = one 128-block -> union is always full
    assert xla_block_sparse.union_live_fraction(a) == 1.0
    assert xla_block_sparse.best_arm(a, pol) == "dense"
    assert xla_block_sparse.best_arm(
        a, pol.replace(xbsp_arm="gathered")) == "gathered"


@pytest.mark.parametrize("arm", ["unroll", "gathered", "auto"])
def test_all_arms_match_oracle_through_dispatch(arm):
    rng = np.random.default_rng(6)
    pol = ExecutionPolicy(block_shape=(128, 128), xbsp_arm=arm)
    w = prune_conv_weight(
        rng.standard_normal((1, 1, 128, 256)).astype(np.float32) * 0.1,
        0.75, (128, 128))
    al = weight_align(w, None, policy=pol)
    x = jnp.asarray(rng.standard_normal((2, 8, 8, 128)).astype(np.float32))
    out = conv_ops.conv2d(x, al, mode=ConvMode.SCONV_PAR, policy=pol)
    ref = lax.conv_general_dilated(
        x, jnp.asarray(w), (1, 1), [(0, 0), (0, 0)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), precision="highest")
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_unstructured_pattern_dispatches_dense():
    """90% UNSTRUCTURED pruning leaves ~every 128x128 block live; the
    dispatcher must fall back to dense conv (block-density profitability,
    the reference's base_conv_layer.cpp:752 fallback at block granularity)."""
    rng = np.random.default_rng(8)
    pol = ExecutionPolicy(block_shape=(128, 128))
    w = prune_conv_weight(
        rng.standard_normal((3, 3, 128, 128)).astype(np.float32), 0.9,
        None)  # element-wise
    al = weight_align(w, None, policy=pol)
    assert al.sparsity >= 0.89
    assert al.block_density > 0.9
    assert xla_block_sparse.best_arm(al, pol) == "dense"
    # and the full dispatch still matches the oracle
    x = jnp.asarray(rng.standard_normal((1, 6, 6, 128)).astype(np.float32))
    out = conv_ops.conv2d(x, al, padding=(1, 1), mode=ConvMode.SCONV,
                          policy=pol)
    ref = lax.conv_general_dilated(
        x, jnp.asarray(w), (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), precision="highest")
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("shape", [
    (2, 7, 7, 256, 256, 3, 1, 0.9),
    (1, 14, 14, 26, 18, 3, 1, 0.7),     # channel tails both sides
    (2, 10, 10, 32, 32, 5, 2, 0.8),
    (1, 8, 8, 32, 32, 1, 0, 0.9),
])
def test_gathered_cols_matches_oracle(shape):
    """Per-column gathered GEMM (XBSP-GC) vs the dense oracle."""
    n, h, w, cin, cout, k, pad, sp = shape
    pol = ExecutionPolicy(block_shape=(8, 8))
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((n, h, w, cin)).astype(np.float32)
                    * 0.1)
    wt = rng.standard_normal((k, k, cin, cout)).astype(np.float32) * 0.05
    wp = prune_conv_weight(wt, sp, (8, 8))
    b = rng.standard_normal(cout).astype(np.float32) * 0.1
    aligned = weight_align(wp, b, policy=pol)
    assert aligned.bsc is not None
    out = xla_block_sparse.conv_gathered_cols(
        x, aligned, padding=(pad, pad), relu=True)
    ref = lax.conv_general_dilated(
        x, jnp.asarray(wp), (1, 1), [(pad, pad), (pad, pad)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), precision="highest")
    ref = jnp.maximum(ref + b, 0.0)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def test_gathered_cols_dispatch_via_policy():
    """xbsp_arm='gathered_cols' routes conv2d_sconv through the new arm."""
    rng = np.random.default_rng(4)
    pol = ExecutionPolicy(block_shape=(128, 128), xbsp_arm="gathered_cols")
    w = prune_conv_weight(
        rng.standard_normal((3, 3, 128, 128)).astype(np.float32), 0.9,
        (128, 128))
    al = weight_align(w, None, policy=pol)
    x = jnp.asarray(rng.standard_normal((1, 7, 7, 128)).astype(np.float32))
    out = conv_ops.conv2d_sconv(x, al, stride=(1, 1), padding=(1, 1),
                                dilation=(1, 1), relu=False, policy=pol,
                                batch_parallel=True)
    ref = lax.conv_general_dilated(
        x, jnp.asarray(w), (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), precision="highest")
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def test_block_dense_gate_precedes_autotune(tmp_path, monkeypatch):
    """The block-density dense fallback must run BEFORE the autotune cache:
    per-layer isolated measurement keeps weight blocks cache-warm and can
    pick unroll/gathered for unstructured-dense patterns that lose
    end-to-end. A poisoned cache entry must not be
    consulted."""
    rng = np.random.default_rng(9)
    pol = ExecutionPolicy(block_shape=(128, 128), autotune=True)
    w = prune_conv_weight(
        rng.standard_normal((1, 1, 128, 256)).astype(np.float32), 0.9,
        None)  # unstructured -> every block live
    al = weight_align(w, None, policy=pol)
    assert al.block_density > 0.9

    from caffe_escoin_tpu.engine import autotune as at
    x_shape = (2, 8, 8, 128)
    key = at.cache_key(al, x_shape, (1, 1), (0, 0), (1, 1), jnp.float32)
    with at._LOCK:
        at._CACHE[key] = "unroll"  # poison: what a warm microbench chose
    try:
        assert xla_block_sparse.best_arm(
            al, pol, x_shape=x_shape, stride=(1, 1), padding=(0, 0),
            dilation=(1, 1)) == "dense"
    finally:
        with at._LOCK:
            at._CACHE.pop(key, None)


def test_fc_unstructured_pattern_uses_dense_matmul():
    """InnerProduct sparse gate mirrors the conv block-density rule: an
    element-sparse but block-dense fc weight must run the single dense
    matmul, not the block unroll."""
    from caffe_escoin_tpu.nn import LayerSpec, Net

    rng = np.random.default_rng(10)
    pol = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR,
                          block_shape=(128, 128))
    specs = [
        LayerSpec("data", "Input", (), ("data",)),
        LayerSpec("fc", "InnerProduct", ("data",), ("fc",),
                  params=dict(num_output=256)),
    ]
    net = Net(specs, policy=pol)
    params = net.init(jax.random.PRNGKey(0), {"data": (2, 256)})
    w = np.asarray(params["fc"]["w"])
    from caffe_escoin_tpu.utils.pruning import prune_magnitude
    params["fc"] = dict(params["fc"], w=jnp.asarray(prune_magnitude(w, 0.9)))
    aligned = net.weight_align(params)
    al = aligned["fc"]
    assert al.block_density > 0.9
    x = jnp.asarray(rng.standard_normal((2, 256)).astype(np.float32))
    out = net.apply(aligned, {"data": x})["fc"]
    ref = x @ jnp.asarray(params["fc"]["w"]) + jnp.asarray(params["fc"]["b"])
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)
    # the dispatch decision itself: block-dense -> NOT the sparse branch
    assert not (al.bsc is not None and al.sparsity >= pol.sparse_threshold
                and al.block_density <= 0.5)


@pytest.mark.parametrize("h,w,k,stride,pad,dil", [
    (8, 8, 3, 1, 1, 1),
    (9, 7, 3, 2, 1, 1),
    (8, 8, 5, 1, 2, 1),
    (11, 11, 3, 1, 2, 2),
    (8, 8, 3, 2, 0, 1),
    (7, 7, 1, 1, 0, 1),
])
def test_nopad_slab_matches_padded_form(monkeypatch, h, w, k, stride, pad,
                                        dil):
    """The pad-free unroll (valid-interior slices + output-side zero pads,
    _nopad_slab) computes bit-identically to the materialized padded-ifmap
    form across strides/dilations/kernels — removing the padded-x copy
    must not change semantics anywhere, including offsets that read only
    halo."""
    rng = np.random.default_rng(3)
    cin, cout = 32, 32
    w_ = prune_conv_weight(
        rng.standard_normal((k, k, cin, cout)).astype(np.float32),
        0.7, (16, 16))
    pol = ExecutionPolicy(block_shape=(16, 16))
    aligned = weight_align(jnp.asarray(w_), None, policy=pol)
    x = jnp.asarray(rng.standard_normal((2, h, w, cin)).astype(np.float32))
    kw = dict(stride=(stride, stride), padding=(pad, pad),
              dilation=(dil, dil))

    for fn in (xla_block_sparse.conv, xla_block_sparse.conv_gathered,
               xla_block_sparse.conv_gathered_cols):
        monkeypatch.delenv("CESCOIN_XBSP_NOPAD", raising=False)
        out_padded = np.asarray(fn(x, aligned, **kw))
        monkeypatch.setenv("CESCOIN_XBSP_NOPAD", "1")
        out_nopad = np.asarray(fn(x, aligned, **kw))
        np.testing.assert_array_equal(out_nopad, out_padded,
                                      err_msg=fn.__name__)

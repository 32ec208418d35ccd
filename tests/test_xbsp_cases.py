"""Direct sparse conv executors (kernels/xla_block_sparse.py: the per-block
unroll and the gathered single GEMM) vs the dense oracle over a sweep of
shapes, sparsities, epilogues and dtypes — coverage the reference never
had for its sparse paths (SURVEY §4), following the oracle pattern of
`src/caffe/test/test_convolution_layer.cpp:22-148`.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from caffe_escoin_tpu.engine.context import ExecutionPolicy  # noqa: E402
from caffe_escoin_tpu.kernels import xla_block_sparse as xbs  # noqa: E402
from caffe_escoin_tpu.kernels.reference import conv2d_reference  # noqa: E402
from caffe_escoin_tpu.ops.conv import conv2d_sconv  # noqa: E402
from caffe_escoin_tpu.sparse.weight_align import weight_align  # noqa: E402
from caffe_escoin_tpu.utils.pruning import prune_conv_weight  # noqa: E402

POLICY = ExecutionPolicy(block_shape=(128, 128))
EXECUTORS = {"unroll": xbs.conv, "gathered": xbs.conv_gathered}

# (n, h, w, cin, cout, k, pad, sparsity, options)
CASES = {
    "3x3_sp50": (2, 14, 14, 256, 256, 3, 1, 0.5, {}),
    "3x3_sp75": (2, 14, 14, 256, 256, 3, 1, 0.75, {}),
    "3x3_sp90": (2, 14, 14, 256, 256, 3, 1, 0.9, {}),
    "3x3_sp99": (2, 14, 14, 256, 256, 3, 1, 0.99, {}),
    "1x1": (2, 14, 14, 256, 512, 1, 0, 0.9, {}),
    "5x5_pad2": (2, 12, 12, 96, 160, 5, 2, 0.8, {}),
    "small_channels": (2, 28, 28, 64, 64, 3, 1, 0.85, {}),
    "bias_relu": (2, 10, 10, 128, 128, 3, 1, 0.9,
                  {"relu": True, "bias": True}),
    "unaligned_width": (2, 7, 7, 128, 256, 3, 1, 0.9, {}),
    "multi_cin_block": (1, 9, 9, 256, 128, 3, 1, 0.7, {"seed": 3}),
    "bf16_activations": (2, 14, 14, 128, 128, 3, 1, 0.9,
                         {"bf16": True, "seed": 1}),
    "dispatch_residual": (2, 10, 10, 16, 32, 3, 1, 0.8,
                          {"residual": True, "relu": True, "bias": True}),
}


@pytest.mark.parametrize("arm", sorted(EXECUTORS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_xbsp_conv_matches_oracle(case, arm):
    n, h, w, cin, cout, k, pad, sparsity, opt = CASES[case]
    rng = np.random.default_rng(opt.get("seed", 0))
    if opt.get("residual"):
        # the conv2d_sconv dispatch with a fused residual + ReLU epilogue,
        # small blocks, the forced executor arm
        pol = ExecutionPolicy(block_shape=(8, 8), xbsp_arm=arm)
        wt = prune_conv_weight(
            rng.standard_normal((k, k, cin, cout)).astype(np.float32),
            sparsity, (8, 8))
        b = rng.standard_normal(cout).astype(np.float32)
        aligned = weight_align(wt, b, policy=pol)
        x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
        res = rng.standard_normal((n, h, w, cout)).astype(np.float32)
        out = conv2d_sconv(jnp.asarray(x), aligned, stride=(1, 1),
                           padding=(pad, pad), dilation=(1, 1), relu=True,
                           policy=pol, batch_parallel=True,
                           residual=jnp.asarray(res))
        ref = np.maximum(conv2d_reference(x, wt, b, padding=(pad, pad)) + res,
                         0.0)
        np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-4, atol=1e-4)
        return

    x = jnp.asarray(rng.standard_normal((n, h, w, cin)).astype(np.float32)
                    * 0.1)
    wt = rng.standard_normal((k, k, cin, cout)).astype(np.float32) * 0.05
    wp = prune_conv_weight(wt, sparsity, (min(128, cin), 128))
    b = (rng.standard_normal(cout).astype(np.float32) * 0.1
         if opt.get("bias") else None)
    aligned = weight_align(wp, b, policy=POLICY)
    assert xbs.supported(aligned, POLICY)
    relu = opt.get("relu", False)
    xin = x.astype(jnp.bfloat16) if opt.get("bf16") else x
    out = EXECUTORS[arm](xin, aligned, padding=(pad, pad), relu=relu)
    ref = lax.conv_general_dilated(
        x, jnp.asarray(wp), (1, 1), [(pad, pad), (pad, pad)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), precision="highest")
    if b is not None:
        ref = ref + b
    if relu:
        ref = jnp.maximum(ref, 0.0)
    if opt.get("bf16"):
        assert out.dtype == jnp.bfloat16
        np.testing.assert_allclose(np.asarray(out, np.float32),
                                   np.asarray(ref), rtol=0.05, atol=0.02)
    else:
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=1e-4, atol=1e-5)

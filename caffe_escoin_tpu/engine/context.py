"""Execution policy: the replacement for `Caffe::conv_mode`.

The reference selects the convolution algorithm through a *global* singleton
enum settable only from the `test` CLI command, with hardcoded profitability
thresholds (`include/caffe/common.hpp:112,154`, `tools/caffe.cpp:293-301`,
thresholds 0.5/0.8/0.2 in `src/caffe/layers/base_conv_layer.cpp:548,727,752`).
SURVEY.md flags this as a wart; here the policy is an explicit, per-layer
configurable object threaded through op construction — no global mutable
state inside jit-traced code (mode choices are trace-time static).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class ConvMode(enum.IntEnum):
    """Convolution execution modes (reference `Caffe::ConvMode`,
    `include/caffe/common.hpp:112`). Same four capabilities:

    LOWERED_GEMM   — dense XLA convolution (`lax.conv_general_dilated`), the
                     dense baseline (reference: im2col + cuBLAS).
    LOWERED_SPARSE — im2col (patch extraction) + sparse weight SpMM
                     (reference: cuSPARSE csrmm2). ELL for unstructured CSR
                     semantics, BSR for block-skipping performance.
    SCONV          — direct sparse convolution, no materialized im2col:
                     per-kernel-offset block-sparse shifted dots over the
                     padded ifmap, image by image (reference:
                     `caffe_gpu_sconv` custom kernels).
    SCONV_PAR      — batch-parallel direct sparse conv: one weight-block fetch
                     amortized over the whole batch (reference:
                     `sconv_batch_tiled`, FMAP_BLOCK register blocking): the
                     batch folds into every dot's M dimension.
    """

    LOWERED_GEMM = 0
    LOWERED_SPARSE = 1
    SCONV = 2
    SCONV_PAR = 3


class SparseFormat(enum.Enum):
    CSR = "csr"  # interchange only
    ELL = "ell"  # unstructured, gather-FMA kernels
    BSR = "bsr"  # block-structured, block-skipping executors


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    """Per-layer (or net-default) execution policy.

    ``sparse_threshold`` / ``sconv_threshold``: minimum weight sparsity at
    which the sparse paths are profitable; below them the layer silently falls
    back to dense GEMM, mirroring the reference's density-based fallbacks
    (`base_conv_layer.cpp:548,727,752`) but configurable instead of hardcoded.
    """

    conv_mode: ConvMode = ConvMode.LOWERED_GEMM
    sparse_format: SparseFormat = SparseFormat.BSR
    block_shape: Tuple[int, int] = (8, 128)  # (cin-block, cout-block) tile
    sparse_threshold: float = 0.5  # LOWERED_SPARSE profitability
    sconv_threshold: float = 0.5  # SCONV/SCONV_PAR profitability
    fuse_relu: bool = True  # fold layer's ReLU into the sparse kernel epilogue
    compute_dtype: object = None  # e.g. jnp.bfloat16; None = input dtype
    # with compute_dtype set: True casts each conv layer's output back to
    # its input dtype (per-layer mixed precision); False keeps outputs in
    # compute_dtype so the whole net runs (and moves bytes) at that width —
    # the bf16 end-to-end inference deployment
    cast_back: bool = True
    # the Pallas SpMM kernel (kernels/bsc_pallas.py) for traced patterns:
    # None = auto (on a GPU backend only)
    use_pallas: Optional[bool] = None
    # run the Pallas kernel in interpreter mode: CPU tests only; a GPU
    # backend refuses it (the kernel compiles for the card there)
    interpret: bool = False
    # XLA-native static block-sparse unroll (kernels/xla_block_sparse.py) as
    # the primary sparse-conv executor; False forces the lowered SpMM path.
    use_xla_sparse: bool = True
    # XBSP formulation: "unroll" (per-block-column dot chains — wins on
    # compute-bound k>1 and reduce-1x1 shapes), "gathered" (single GEMM over
    # the union of live K-blocks, output written once — wins on
    # write-bound expand-1x1 shapes), or "auto" (per-shape heuristic from
    # profiling; the reference's per-shape kernel dispatch,
    # `math_functions.cu:589-694`, reborn as a policy rule).
    xbsp_arm: str = "auto"
    # Measured per-(shape, pattern) arm selection with a dense never-lose
    # floor (engine/autotune.py): at trace time each candidate arm —
    # including the dense bf16 conv — is device-timed once and the winner
    # cached. Supersedes the xbsp_arm="auto" heuristic when on. Off by
    # default: it compiles 3 candidates per unique conv shape on first
    # trace (the deployment/bench switch, not the unit-test one).
    autotune: bool = False
    autotune_cache: str = ""  # JSON file persisting the measured table
    # Native host direct sparse conv (csrc/sconv.cc via pure_callback) when
    # running on the CPU backend — the reference's AVX blocked-sconv product
    # path (`sconv.hpp:83-678`) rebuilt over the BSC layout. Opt-in: the
    # jnp executors remain the default CPU test target.
    native_cpu: bool = False

    def pallas_enabled(self) -> bool:
        """Whether traced patterns run the Pallas kernel: on a GPU backend,
        or where a test asks for it (``use_pallas`` / ``interpret``)."""
        import jax

        backend = jax.default_backend()
        if self.interpret and backend == "gpu":
            raise ValueError(
                "ExecutionPolicy(interpret=True) is for CPU tests; on a GPU "
                "backend the Pallas kernels compile for the card")
        if self.use_pallas is not None:
            return self.use_pallas
        return backend == "gpu" or self.interpret

    def replace(self, **kw) -> "ExecutionPolicy":
        return dataclasses.replace(self, **kw)


_DEFAULT = ExecutionPolicy()


def default_policy() -> ExecutionPolicy:
    return _DEFAULT


def set_default_conv_mode(mode: ConvMode) -> None:
    """Convenience for CLI parity with `caffe test -conv_mode N`. Only affects
    nets built afterwards (policies are captured at construction)."""
    global _DEFAULT
    _DEFAULT = _DEFAULT.replace(conv_mode=ConvMode(mode))

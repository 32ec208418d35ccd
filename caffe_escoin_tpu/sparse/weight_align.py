"""Weight alignment: the per-layer dense -> sparse "compile" pass.

A re-design of `BaseConvolutionLayer::WeightAlign`
(`src/caffe/layers/base_conv_layer.cpp:46-273`), invoked once after weights are
loaded (`src/caffe/net.cpp:819`). The reference builds CSR weights, stretches
column indices into padded-input offsets, and column-blocks the CSR for the
AVX kernel's cache. Here the pass builds, from a conv weight W[KH,KW,Cin,Cout]:

* the GEMM view Wmat[K = KH*KW*Cin, Cout] (rows ordered (kh, kw, cin) to match
  the im2col patch layout);
* a ``BSC`` of Wmat with a per-layer (bk, bn) block shape — bk is clipped to a
  divisor of Cin so every K-block decodes to one (kernel offset, cin-block),
  which is what lets the direct-conv kernel turn block indices into shifted
  ifmap slices (the stretch-transform, see formats.BSC docstring);
* an ``ELL`` of Wmat^T (rows = output channels — the reference's CSR row
  orientation) for unstructured sparsity semantics;
* sparsity statistics mirroring the reference's logging
  (`base_conv_layer.cpp:143-189`): global sparsity, per-offset nnz histogram,
  per-output-channel nnz.

Grouped convolution is expanded to a block-diagonal Wmat: group structure IS
structured sparsity, so the sparse kernels handle groups with zero extra code
(the reference needed per-group CSR slices and kernel launches,
`base_conv_layer.cpp:627,778,836`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import numpy as np

from caffe_escoin_tpu.engine.context import ExecutionPolicy
from caffe_escoin_tpu.sparse.formats import (
    BSC,
    ELL,
    _register,
    _static_field,
    dense_to_bsc,
    dense_to_ell,
)


def choose_cin_blocking(cin: int, target: int) -> Tuple[int, int]:
    """Pick (bk, cin_pad): the K-block depth and the padded channel count.

    Either the whole (padded) channel dim is one block, or bk == 128 with
    cin padded to a 128 multiple, so every K-block decodes to one (kernel
    offset, cin-block). Channel padding is the counterpart of the
    reference's explicit padded-input buffers (`base_conv_layer.cpp:248-259`).
    """
    if cin <= target:
        cin_pad = -(-cin // 8) * 8  # lane-sublane friendly
        return cin_pad, cin_pad
    bk = 128 if target >= 128 else target
    cin_pad = -(-cin // bk) * bk
    return bk, cin_pad


def gemm_view(w_hwio: np.ndarray, groups: int = 1, cin_pad: int | None = None
              ) -> np.ndarray:
    """[KH,KW,Cin/g,Cout] -> block-diagonal [KH*KW*cin_pad, Cout] (row order
    (kh, kw, cin), matching im2col's column order; channels zero-padded to
    cin_pad so K-blocks never straddle kernel offsets)."""
    w = np.asarray(w_hwio)
    kh, kw, cin_g, cout = w.shape
    cin = cin_g * groups
    if cin_pad is None:
        cin_pad = cin
    full = np.zeros((kh, kw, cin_pad, cout), w.dtype)
    if groups == 1:
        full[:, :, :cin, :] = w
    else:
        cout_g = cout // groups
        for g in range(groups):
            full[:, :, g * cin_g : (g + 1) * cin_g,
                 g * cout_g : (g + 1) * cout_g] = w[..., g * cout_g : (g + 1) * cout_g]
    return full.reshape(kh * kw * cin_pad, cout)


@dataclasses.dataclass(frozen=True)
class SparsityStats:
    """Mirror of the reference's WeightAlign sparsity logging."""

    sparsity: float
    nnz: int
    block_density: float
    nnz_per_offset: Tuple[int, ...]  # kernel-position histogram
    nnz_per_out_channel: Tuple[int, ...]


@_register
@dataclasses.dataclass(frozen=True)
class AlignedConvWeight:
    """All execution-ready representations of one conv layer's weight."""

    dense: jax.Array  # [KH,KW,Cin/g,Cout] as loaded
    bias: Optional[jax.Array]  # [Cout] or None
    bsc: Optional[BSC]  # GEMM-view block-sparse (None below threshold)
    ell_t: Optional[ELL]  # Wmat^T row-sparse (unstructured path)
    kernel_shape: Tuple[int, int] = _static_field(default=(0, 0))
    cin: int = _static_field(default=0)  # full Cin (groups expanded)
    cin_pad: int = _static_field(default=0)  # channel dim padded for blocking
    cout: int = _static_field(default=0)
    groups: int = _static_field(default=1)
    sparsity: float = _static_field(default=0.0)
    block_density: float = _static_field(default=1.0)
    stats: Optional[SparsityStats] = _static_field(default=None)

    @property
    def k(self) -> int:
        """GEMM K with channel padding (the sparse artifacts' row count)."""
        return self.kernel_shape[0] * self.kernel_shape[1] * self.cin_pad


def split_payloads(aligned_params):
    """Split an aligned-params map into (skeleton, payloads) so the big
    weight PAYLOADS can ride as jit ARGUMENTS while the sparsity PATTERN
    stays closed over (concrete at trace time — the XBSP requirement).

    Closing the payloads over as constants embeds them in the HLO (tens
    of MB of literals for ResNet-scale nets: slower serialization and
    compile-cache keys, and executions of constant-heavy executables can
    carry per-call staging costs that argument buffers never pay).

    Returns (graft, payloads): ``payloads`` is a plain pytree of arrays;
    ``graft(traced_payloads)`` rebuilds the aligned map inside a trace.
    Usage::

        graft, pl = split_payloads(aligned)
        fwd = jax.jit(lambda pl, x: net.apply(graft(pl), x))
        fwd(pl, x)
    """
    payloads = {}
    recipes = {}
    for name, obj in aligned_params.items():
        if isinstance(obj, AlignedConvWeight):
            pl = {"dense": obj.dense}
            if obj.bias is not None:
                pl["bias"] = obj.bias
            if obj.bsc is not None:
                pl["bsc_blocks"] = obj.bsc.blocks
                pl["bsc_flat"] = obj.bsc.flat_blocks
            if obj.ell_t is not None:
                pl["ell_values"] = obj.ell_t.values
            payloads[name] = pl
            recipes[name] = obj
        else:
            # plain param dicts (non-conv layers) ride whole
            payloads[name] = obj
            recipes[name] = None

    def graft(pl):
        out = {}
        for name, base in recipes.items():
            if base is None:
                out[name] = pl[name]
                continue
            q = pl[name]
            bsc = base.bsc
            if bsc is not None:
                bsc = dataclasses.replace(
                    bsc, blocks=q["bsc_blocks"], flat_blocks=q["bsc_flat"])
            ell = base.ell_t
            if ell is not None:
                ell = dataclasses.replace(ell, values=q["ell_values"])
            out[name] = dataclasses.replace(
                base, dense=q["dense"], bias=q.get("bias"), bsc=bsc,
                ell_t=ell)
        return out

    return graft, payloads


def weight_align(
    w_hwio,
    bias=None,
    *,
    groups: int = 1,
    policy: Optional[ExecutionPolicy] = None,
    with_stats: bool = True,
    with_ell: Optional[bool] = None,
) -> AlignedConvWeight:
    """Build the aligned sparse representations for one conv layer.

    The ELL (unstructured row-sparse) artifact is built only when the policy
    actually executes it (``sparse_format == ELL``) or ``with_ell=True`` —
    for fc-scale matrices it is a large host-memory cost the BSR path never
    reads."""
    policy = policy or ExecutionPolicy()
    w = np.asarray(jax.device_get(w_hwio))
    kh, kw, cin_g, cout = w.shape
    cin = cin_g * groups
    bk_target, bn_target = policy.block_shape
    bk, cin_pad = choose_cin_blocking(cin, bk_target)
    # adaptive output-block width: a 64-channel layer with bn=128 would write
    # (and zero-pad) twice the output traffic
    bn = min(bn_target, -(-cout // 8) * 8)
    wmat = gemm_view(w, groups, cin_pad)  # (K = KH*KW*cin_pad, Cout)
    nnz = int((wmat != 0).sum())
    # Sparsity accounting matches the reference: zeros of the *stored* weight,
    # not counting group-structural or padding zeros of the expanded matrix.
    stored = w.size
    sparsity = 1.0 - (int((w != 0).sum()) / max(1, stored))

    bsc = None
    ell_t = None
    stats = None
    from caffe_escoin_tpu.engine.context import SparseFormat

    if with_ell is None:
        with_ell = policy.sparse_format == SparseFormat.ELL
    if sparsity >= min(policy.sparse_threshold, policy.sconv_threshold):
        bsc = dense_to_bsc(wmat, (bk, bn))
        if with_ell:
            ell_t = dense_to_ell(wmat.T, lane_pad=8)
    if with_stats:
        per_offset = (wmat != 0).reshape(kh * kw, cin_pad, cout).sum(axis=(1, 2))
        per_oc = (wmat != 0).sum(axis=0)
        stats = SparsityStats(
            sparsity=sparsity,
            nnz=nnz,
            block_density=bsc.block_density if bsc is not None else 1.0,
            nnz_per_offset=tuple(int(x) for x in per_offset),
            nnz_per_out_channel=tuple(int(x) for x in per_oc),
        )
    return AlignedConvWeight(
        dense=jax.numpy.asarray(w),
        bias=None if bias is None else jax.numpy.asarray(bias),
        bsc=bsc,
        ell_t=ell_t,
        kernel_shape=(kh, kw),
        cin=cin,
        cin_pad=cin_pad,
        cout=cout,
        groups=groups,
        sparsity=sparsity,
        block_density=bsc.block_density if bsc is not None else 1.0,
        stats=stats,
    )

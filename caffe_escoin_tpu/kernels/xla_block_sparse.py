"""XLA-native static block-sparse convolution (the XBSP executor).

The sparsity pattern of an aligned weight is compile-time constant (it is
produced by WeightAlign, the reference's model-load-time sparse "compile",
`src/caffe/layers/base_conv_layer.cpp:46-273`). This executor exploits that
by UNROLLING the sparse conv at trace time into a sum of shifted dense
dot_generals — one per live (kernel-offset, cin-block, cout-block) weight
block:

    out[:, :, :, j] = sum_{live (off, cb) in column j}
        x_pad[:, khi : khi+Ho, kwi : kwi+Wo, cb*bk:(cb+1)*bk] @ W[j, s]

This is the direct-sparse-conv decomposition by kernel offset (the same
structure the reference's stretched CSR index encodes,
`math_functions.cu:706-727`) expressed entirely in XLA ops: XLA fuses the
pad/shift/slice into each dot's operand read and picks the dot kernels.
Compute scales with the number of live blocks — zero blocks are skipped at
trace time, so at 90% block sparsity the dots do ~10% of the dense work.

"Don't hand-schedule what the compiler already does": a traced pattern,
which cannot be unrolled, falls back to im2col + the Pallas SpMM kernel
(kernels/bsc_pallas.py; policy.use_xla_sparse = False forces that path).

Requires the BSC pattern to be concrete at trace time (host numpy — true
whenever the aligned weight is closed over by the jitted function, the
normal inference deployment shape). `supported()` checks this.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from caffe_escoin_tpu.sparse.weight_align import AlignedConvWeight


def _concrete(a) -> bool:
    return not isinstance(a, jax.core.Tracer)


def supported(aligned: AlignedConvWeight, policy) -> bool:
    if aligned.bsc is None:
        return False
    if not getattr(policy, "use_xla_sparse", True):
        return False
    return _concrete(aligned.bsc.block_row) and _concrete(aligned.bsc.bcol_nnz)


def union_live_fraction(aligned: AlignedConvWeight) -> float:
    """Fraction of K-blocks live in at least one output block-column — the
    gathered arm's read volume relative to dense."""
    block_row = np.asarray(jax.device_get(aligned.bsc.block_row))
    bcol_nnz = np.asarray(jax.device_get(aligned.bsc.bcol_nnz))
    live = {int(block_row[j, s]) for j in range(block_row.shape[0])
            for s in range(int(bcol_nnz[j]))}
    return len(live) / max(1, aligned.bsc.n_brows)


def best_arm(aligned: AlignedConvWeight, policy, *, x_shape=None,
             stride=(1, 1), padding=(0, 0), dilation=(1, 1),
             batch_parallel=True) -> str:
    """Per-shape executor choice: "unroll" | "gathered" | "dense".

    With ``policy.autotune`` on and a concrete input shape, the choice is
    MEASURED: each candidate arm (including the dense bf16 conv — the
    never-lose floor) is device-timed once per (shape, pattern) and cached
    (engine/autotune.py). Otherwise the heuristic below applies, with
    rules from profiling ResNet-50's stride-1 shapes at 70-95% block
    sparsity on an earlier accelerator, still to be re-derived on this
    one (the reference dispatches per shape among its 8 CUDA kernels the
    same hardcoded way, `math_functions.cu:589-694`):

    * k>1 and reduce-1x1 shapes are COMPUTE-bound on the dense baseline —
      the per-column unroll's trace-time block skipping wins.
    * expand-1x1 shapes (cout > cin) are OUTPUT-WRITE-bound — both arms
      write the same bytes, so the single-GEMM gathered form (one output
      write, fewer input reads) is the ceiling; when the union of live
      K-blocks covers ALL of K and cin fills a 128-wide block, XLA's own
      1x1-conv lowering beats any dot_general formulation — fall back to
      dense conv on the pruned weight (the reference's density fallback,
      `base_conv_layer.cpp:752`, driven by block structure instead of a
      scalar threshold).
    """
    arm = getattr(policy, "xbsp_arm", "auto")
    if arm != "auto":
        return arm
    # BLOCK-density profitability (the reference's element-density
    # fallback, `base_conv_layer.cpp:752`, at the granularity the
    # executors skip): a weight that is element-sparse but block-dense
    # (e.g. 90% UNSTRUCTURED pruning -> ~every 128x128 block live) would
    # make the unroll do ~dense FLOPs in a worse schedule than XLA's conv.
    # This gate runs BEFORE autotune: per-layer isolated measurement keeps
    # the weight blocks cache-warm, which flatters a many-small-dots
    # schedule that re-reads operands and composes to an end-to-end loss,
    # while the dense fallback matches dense by construction. At >=50%
    # live blocks no dot-chain schedule can beat one dense conv on cold
    # device memory, so don't let warm microbenchmarks vote.
    if aligned.block_density > 0.5:
        return "dense"
    if getattr(policy, "autotune", False) and x_shape is not None:
        from caffe_escoin_tpu.engine import autotune

        got = autotune.choose_arm(aligned, policy, x_shape, stride,
                                  padding, dilation)
        if got is not None:
            return got
    # Heuristic-path never-lose floor: the hand rules below are
    # calibrated on >=80% block sparsity; at ~30% live blocks they
    # composed to an end-to-end loss against dense bf16, because nothing
    # below measures. Without measurement the only safe choice in that
    # regime is the dense conv (dense speed by construction) — the
    # reference's density thresholds (`base_conv_layer.cpp:548,727,752`)
    # existed for exactly this. Autotune (the deployment default)
    # measures instead of gating.
    if aligned.block_density >= 0.25:
        return "dense"
    kh, kw = aligned.kernel_shape
    if not (kh == kw == 1 and aligned.cout > aligned.cin):
        return "unroll"
    if aligned.cin >= 128 and union_live_fraction(aligned) >= 1.0:
        return "dense"
    return "gathered"


def spmm_supported(bsc, policy=None) -> bool:
    """Static-unroll SpMM needs the BSC *pattern* concrete at trace time
    (payloads may be traced)."""
    if bsc is None:
        return False
    if policy is not None and not getattr(policy, "use_xla_sparse", True):
        return False
    return _concrete(bsc.block_row) and _concrete(bsc.bcol_nnz)


def spmm(x, bsc, *, bias=None, relu=False):
    """x[M, K] @ BSC[K, N] -> [M, N] via trace-time block unroll.

    The FC twin of `conv` below (reference: the fc bucket of
    `tools/caffe.cpp:338-367`; the reference never sparsified FC — this is
    the capability superset noted in ops/linear.py). One dot_general per
    live (K-block, N-block); zero blocks cost nothing; per-column bias/relu
    epilogues fuse into the final dot of each chain. Accepts x with K or
    K-padded columns (BSC edge blocks are zero-padded)."""
    bk, bn = bsc.block_shape
    kdim, ncols = bsc.shape
    m = x.shape[0]
    block_row = np.asarray(jax.device_get(bsc.block_row))
    bcol_nnz = np.asarray(jax.device_get(bsc.bcol_nnz))
    wblocks = bsc.blocks.astype(x.dtype)
    outs = []
    for j in range(block_row.shape[0]):
        acc = None
        for s in range(int(bcol_nnz[j])):
            kb = int(block_row[j, s])
            a = x[:, kb * bk : min((kb + 1) * bk, x.shape[1])]
            blk = wblocks[j, s]
            if a.shape[-1] < bk:  # K tail (x not padded to n_brows*bk)
                blk = blk[: a.shape[-1]]
            d = jax.lax.dot_general(
                a, blk, (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32)
            acc = d if acc is None else acc + d
        if acc is None:
            acc = jnp.zeros((m, bn), jnp.float32)
        if bias is not None:
            bcol = bias[j * bn:(j + 1) * bn]
            if bcol.shape[0] < bn:
                bcol = jnp.pad(bcol, (0, bn - bcol.shape[0]))
            acc = acc + bcol
        if relu:
            acc = jnp.maximum(acc, 0.0)
        outs.append(acc.astype(x.dtype))
    out = jnp.concatenate(outs, axis=-1) if len(outs) > 1 else outs[0]
    return out[:, :ncols]


def conv_gathered(x, aligned: AlignedConvWeight, *, stride=(1, 1),
                  padding=(0, 0), dilation=(1, 1), relu=False,
                  residual=None):
    """Block-sparse conv as ONE dense GEMM over gathered live K-blocks
    (the XBSP-G executor).

    Block-granular "sparse im2col": take the UNION of live (kernel-offset,
    cin-block) K-blocks across all output block-columns, concatenate only
    those shifted ifmap slices (the im2col restricted to live blocks —
    the reference's LOWERED_SPARSE path at block granularity,
    `base_conv_layer.cpp:727-736`), and run a single GEMM against the
    union-packed weight (rows for blocks dead in a given column are zero).

    vs the per-column unroll (`conv`): the output is written exactly ONCE
    (the unroll writes each column's accumulator and then concatenates —
    2x output bytes), and the GEMM's K dimension is U*bk instead of bk,
    which a matrix unit pipelines far better. The price is compute on the
    zero-padding inside the union (union_size x Cout instead of
    sum-of-live-per-column) — cheap while the layer is bandwidth-bound.
    The dispatcher (ops/conv.py) picks per layer (`best_arm`).
    """
    kh, kw = aligned.kernel_shape
    bk, bn = aligned.bsc.block_shape
    n_cin_b = aligned.cin_pad // bk
    ph, pw = padding
    sh, sw = stride
    dh, dw = dilation
    n, h, w, c = x.shape
    ho = (h + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    wo = (w + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1

    nopad = bool(os.environ.get("CESCOIN_XBSP_NOPAD"))
    xp = x
    if (ph or pw) and not nopad:
        xp = jnp.pad(x, ((0, 0), (ph, ph), (pw, pw), (0, 0)))

    block_row = np.asarray(jax.device_get(aligned.bsc.block_row))
    bcol_nnz = np.asarray(jax.device_get(aligned.bsc.bcol_nnz))
    ncols = block_row.shape[0]

    # union of live K-blocks across block-columns, in K order
    live = sorted({
        int(block_row[j, s])
        for j in range(ncols)
        for s in range(int(bcol_nnz[j]))
    })
    if not live:
        out = jnp.zeros((n, ho, wo, aligned.cout), jnp.float32)
        if aligned.bias is not None:
            out = out + aligned.bias
        if residual is not None:
            out = out + residual.astype(out.dtype)
        if relu:
            out = jnp.maximum(out, 0.0)
        return out.astype(x.dtype)
    upos = {kb: i for i, kb in enumerate(live)}

    # gathered activation: concat the live blocks' shifted slices.
    # Full-union 1x1 special case: the gather would just reassemble x —
    # skip the copy entirely (the no-op gather showed up as a full extra
    # read+write of the ifmap in profiles).
    if (kh == kw == 1 and live == list(range(n_cin_b))
            and c == aligned.cin_pad and not (nopad and (ph or pw))):
        xg = xp[:, ::sh, ::sw, :]
    else:
        slices = []
        for kb in live:
            off, cb = kb // n_cin_b, kb % n_cin_b
            khi, kwi = (off // kw) * dh, (off % kw) * dw
            if nopad:
                a, opad = _nopad_slab(x, khi, kwi, ph, pw, sh, sw, ho, wo,
                                      cb, bk, c)
                if a is None:
                    a = jnp.zeros((n, ho, wo, bk), x.dtype)
                elif opad != ((0, 0), (0, 0)):
                    a = jnp.pad(a, ((0, 0), opad[0], opad[1], (0, 0)))
            else:
                a = xp[:, khi:khi + sh * (ho - 1) + 1:sh,
                       kwi:kwi + sw * (wo - 1) + 1:sw,
                       cb * bk:min((cb + 1) * bk, c)]
            if a.shape[-1] < bk:  # channel tail (cin_pad > cin)
                a = jnp.pad(a,
                            ((0, 0), (0, 0), (0, 0), (0, bk - a.shape[-1])))
            slices.append(a)
        xg = jnp.concatenate(slices, axis=-1) if len(slices) > 1 else slices[0]

    # union-packed weight [U*bk, ncols*bn], assembled host-side when the
    # payload is concrete (the deployment shape), else via scatter-adds that
    # XLA constant-folds for closed-over weights
    blocks = aligned.bsc.blocks
    if _concrete(blocks):
        wg = np.zeros((len(live) * bk, ncols * bn),
                      np.asarray(jax.device_get(blocks)).dtype)
        bl = np.asarray(jax.device_get(blocks))
        for j in range(ncols):
            for s in range(int(bcol_nnz[j])):
                u = upos[int(block_row[j, s])]
                wg[u * bk:(u + 1) * bk, j * bn:(j + 1) * bn] = bl[j, s]
        wg = jnp.asarray(wg)
    else:
        wg = jnp.zeros((len(live) * bk, ncols * bn), blocks.dtype)
        for j in range(ncols):
            for s in range(int(bcol_nnz[j])):
                u = upos[int(block_row[j, s])]
                wg = wg.at[u * bk:(u + 1) * bk, j * bn:(j + 1) * bn].set(
                    blocks[j, s])
    wg = wg.astype(x.dtype)

    out = jax.lax.dot_general(
        xg, wg, (((3,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)
    if aligned.bias is not None:
        b = aligned.bias
        if b.shape[0] < ncols * bn:
            b = jnp.pad(b, (0, ncols * bn - b.shape[0]))
        out = out + b
    out = out[..., :aligned.cout]
    if residual is not None:
        out = out + residual.astype(out.dtype)
    if relu:
        out = jnp.maximum(out, 0.0)
    return out.astype(x.dtype)


def conv_gathered_cols(x, aligned: AlignedConvWeight, *, stride=(1, 1),
                       padding=(0, 0), dilation=(1, 1), relu=False,
                       residual=None):
    """Per-column gathered GEMM ("XBSP-GC"): for each output
    block-column, concatenate ONLY that column's live K-block slices and
    run ONE dot [M, s_j*bk] x [s_j*bk, bn].

    Middle ground between the per-block unroll (`conv`: one dot per live
    block — DOT-COUNT-bound on small feature maps, e.g. 7x7 512->512 k3 at
    90% runs ~14 tiny M=784 dots) and the global-union single GEMM
    (`conv_gathered`: K = union*bk, wasteful compute when columns share
    few K-blocks, as in k>1 patterns). Dot
    count drops from live_blocks to ncols; identical slab slices across
    columns are CSE'd by XLA so each (offset, cin-block) activation
    materializes once. Per-column f32 epilogue before the bf16 concat, as
    in `conv`. The autotuner (engine/autotune.py) picks it where it is
    measured fastest."""
    kh, kw = aligned.kernel_shape
    bk, bn = aligned.bsc.block_shape
    n_cin_b = aligned.cin_pad // bk
    ph, pw = padding
    sh, sw = stride
    dh, dw = dilation
    n, h, w, c = x.shape
    ho = (h + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    wo = (w + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1

    nopad = bool(os.environ.get("CESCOIN_XBSP_NOPAD"))
    xp = x
    if (ph or pw) and not nopad:
        xp = jnp.pad(x, ((0, 0), (ph, ph), (pw, pw), (0, 0)))

    block_row = np.asarray(jax.device_get(aligned.bsc.block_row))
    bcol_nnz = np.asarray(jax.device_get(aligned.bsc.bcol_nnz))
    wblocks = aligned.bsc.blocks.astype(x.dtype)

    def slab(kblk):
        off, cb = kblk // n_cin_b, kblk % n_cin_b
        khi, kwi = (off // kw) * dh, (off % kw) * dw
        if nopad:
            # pad-free: slice the valid interior of the UNPADDED x and
            # zero-pad the slab spatially — the pad fuses into the concat
            # write, while a padded-x copy with several slice consumers
            # gets materialized (see _nopad_slab)
            a, opad = _nopad_slab(x, khi, kwi, ph, pw, sh, sw, ho, wo,
                                  cb, bk, c)
            if a is None:  # offset reads only halo: zero contribution
                return jnp.zeros((n, ho, wo, bk), x.dtype)
            if opad != ((0, 0), (0, 0)):
                a = jnp.pad(a, ((0, 0), opad[0], opad[1], (0, 0)))
        else:
            a = xp[:, khi:khi + sh * (ho - 1) + 1:sh,
                   kwi:kwi + sw * (wo - 1) + 1:sw,
                   cb * bk:min((cb + 1) * bk, c)]
        if a.shape[-1] < bk:  # channel tail (cin_pad > cin)
            a = jnp.pad(a, ((0, 0), (0, 0), (0, 0), (0, bk - a.shape[-1])))
        return a

    outs = []
    for j in range(block_row.shape[0]):
        s_j = int(bcol_nnz[j])
        if s_j == 0:
            acc = jnp.zeros((n, ho, wo, bn), jnp.float32)
        else:
            ag = [slab(int(block_row[j, s])) for s in range(s_j)]
            ag = jnp.concatenate(ag, axis=-1) if s_j > 1 else ag[0]
            wcol = wblocks[j, :s_j].reshape(s_j * bk, bn)
            acc = jax.lax.dot_general(
                ag, wcol, (((3,), (0,)), ((), ())),
                preferred_element_type=jnp.float32)
        if aligned.bias is not None:
            bcol = aligned.bias[j * bn:(j + 1) * bn]
            if bcol.shape[0] < bn:
                bcol = jnp.pad(bcol, (0, bn - bcol.shape[0]))
            acc = acc + bcol
        if residual is not None:
            rcol = residual[..., j * bn:(j + 1) * bn]
            if rcol.shape[-1] < bn:
                rcol = jnp.pad(
                    rcol, ((0, 0),) * (rcol.ndim - 1)
                    + ((0, bn - rcol.shape[-1]),))
            acc = acc + rcol.astype(acc.dtype)
        if relu:
            acc = jnp.maximum(acc, 0.0)
        outs.append(acc.astype(x.dtype))
    out = jnp.concatenate(outs, axis=-1) if len(outs) > 1 else outs[0]
    return out[..., :aligned.cout]


def _nopad_slab(x, khi, kwi, ph, pw, sh, sw, ho, wo, cb, bk, c):
    """Shifted slab WITHOUT materializing a padded ifmap.

    Hypothesis: `jnp.pad(x)` consumed by several shifted-slice dots looks
    like a full extra ifmap read+write, so this form slices only the valid
    interior of the UNPADDED x and zero-pads the dot RESULT instead. On an
    earlier accelerator the padded-ifmap form won (XLA read the
    materialized padded buffer with aligned tiles, while the
    valid-interior slices forced unaligned strided operand reads). Kept as
    CESCOIN_XBSP_NOPAD=1 for measurement on hardware where the trade may
    flip; the default is the padded form.

    Returns (slab_or_None, ((top, bottom), (left, right)) output pad);
    None when the offset reads only halo (contribution is zero)."""
    n, h, w, _ = x.shape
    # output index j reads input row r = khi - ph + sh*j; valid 0 <= r < h
    j0 = max(0, -(-(ph - khi) // sh))
    j1 = min(ho - 1, (h - 1 - khi + ph) // sh)
    i0 = max(0, -(-(pw - kwi) // sw))
    i1 = min(wo - 1, (w - 1 - kwi + pw) // sw)
    if j0 > j1 or i0 > i1:
        return None, ((0, ho), (0, wo))
    r0 = khi - ph + sh * j0
    c0 = kwi - pw + sw * i0
    a = x[:, r0:r0 + sh * (j1 - j0) + 1:sh,
          c0:c0 + sw * (i1 - i0) + 1:sw,
          cb * bk:min((cb + 1) * bk, c)]
    return a, ((j0, ho - 1 - j1), (i0, wo - 1 - i1))


def conv(x, aligned: AlignedConvWeight, *, stride=(1, 1), padding=(0, 0),
         dilation=(1, 1), relu=False, residual=None):
    """Block-sparse conv via static XLA unroll. x: [N,H,W,Cin] (any float
    dtype; bf16 recommended) -> [N,Ho,Wo,Cout] in x.dtype. Supports any
    kernel size, stride and dilation (shifted slices subsample freely).
    ``residual`` [N,Ho,Wo,Cout] is a fused Eltwise-sum input added per
    block-column in f32 before the ReLU/cast (nn/fuse.py pass B).

    Spatial padding materializes a padded ifmap; CESCOIN_XBSP_NOPAD=1
    switches to the pad-free valid-slice form (see _nopad_slab)."""
    kh, kw = aligned.kernel_shape
    bk, bn = aligned.bsc.block_shape
    n_cin_b = aligned.cin_pad // bk
    ph, pw = padding
    sh, sw = stride
    dh, dw = dilation
    n, h, w, c = x.shape
    ho = (h + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    wo = (w + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1

    nopad = bool(os.environ.get("CESCOIN_XBSP_NOPAD"))
    xp = x
    if (ph or pw) and not nopad:
        xp = jnp.pad(x, ((0, 0), (ph, ph), (pw, pw), (0, 0)))

    block_row = np.asarray(jax.device_get(aligned.bsc.block_row))
    bcol_nnz = np.asarray(jax.device_get(aligned.bsc.bcol_nnz))
    wblocks = aligned.bsc.blocks.astype(x.dtype)

    outs = []
    for j in range(block_row.shape[0]):
        acc = None
        for s in range(int(bcol_nnz[j])):
            kblk = int(block_row[j, s])
            off, cb = kblk // n_cin_b, kblk % n_cin_b
            khi, kwi = (off // kw) * dh, (off % kw) * dw
            opad = None
            if nopad:
                a, opad = _nopad_slab(x, khi, kwi, ph, pw, sh, sw, ho, wo,
                                      cb, bk, c)
                if a is None:
                    continue
                if opad == ((0, 0), (0, 0)):
                    opad = None
            else:
                a = xp[:, khi:khi + sh * (ho - 1) + 1:sh,
                       kwi:kwi + sw * (wo - 1) + 1:sw,
                       cb * bk:min((cb + 1) * bk, c)]
            blk = wblocks[j, s]
            if a.shape[-1] < bk:  # channel tail (cin_pad > cin)
                blk = blk[:a.shape[-1]]
            d = jax.lax.dot_general(
                a, blk, (((3,), (0,)), ((), ())),
                preferred_element_type=jnp.float32)
            if opad is not None:
                d = jnp.pad(d, ((0, 0), opad[0], opad[1], (0, 0)))
            acc = d if acc is None else acc + d
        if acc is None:
            acc = jnp.zeros((n, ho, wo, bn), jnp.float32)
        # bias/relu/cast per block-column, in f32, BEFORE the concat: the
        # concat then moves bf16 (half the bytes) and the adds fuse into the
        # last dot of each column's chain
        if aligned.bias is not None:
            b = aligned.bias
            bcol = b[j * bn:(j + 1) * bn]
            if bcol.shape[0] < bn:
                bcol = jnp.pad(bcol, (0, bn - bcol.shape[0]))
            acc = acc + bcol
        if residual is not None:
            rcol = residual[..., j * bn:(j + 1) * bn]
            if rcol.shape[-1] < bn:
                rcol = jnp.pad(
                    rcol, ((0, 0),) * (rcol.ndim - 1)
                    + ((0, bn - rcol.shape[-1]),))
            acc = acc + rcol.astype(acc.dtype)
        if relu:
            acc = jnp.maximum(acc, 0.0)
        outs.append(acc.astype(x.dtype))
    out = jnp.concatenate(outs, axis=-1) if len(outs) > 1 else outs[0]
    return out[..., :aligned.cout]

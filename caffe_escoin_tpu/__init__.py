"""caffe-escoin-tpu: a sparse CNN inference/training framework for JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
chenxuhao/caffe-escoin (Escoin: efficient sparse convolutional neural network
inference, arXiv:1802.10280): CSR/ELL/BSR sparse weight representations,
dense->sparse "weight align" compilation, im2col+SpMM and direct sparse
convolution execution modes with fused bias/ReLU, a Caffe-style graph runtime
(Net), SGD-family solvers, a prefetching data pipeline, and multi-chip scaling
via jax.sharding meshes (data / tensor / spatial-halo parallelism).

Nothing here is a port: the reference is C++/CUDA (cuSPARSE, AVX intrinsics,
NCCL); this framework is built around sparsity patterns fixed at load time
and executed by XLA (128x128 block-sparse tiles), one Pallas kernel where
the pattern is only known at run time, XLA collectives, and functional
transforms (jit/grad/shard_map).

Reference layer map: see SURVEY.md section 1 (repo root).
"""

__version__ = "0.1.0"

from caffe_escoin_tpu.engine.context import (  # noqa: F401
    ConvMode,
    ExecutionPolicy,
    default_policy,
    set_default_conv_mode,
)

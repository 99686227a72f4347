"""The K-major copy of an int8 [in, out] weight, CUDA (``transpose_q8_kernel``
in ``csrc/gemm_mma_q8.cuh``), shared by the bf16 K15, K16, K17 and K18a
and by K18b.

Replaces no TPU kernel: the int8 TMA + ``wgmma`` core those five run reads
both operands K-major (``wgmma`` transposes from shared memory only for
16-bit types), while the parameters keep the JAX package's [in, out]
layout.  Each kernel's launch sequence first copies the weights it reads
into scratches its wrapper allocates (:func:`kmajor_q8_scratch`);
:func:`kmajor_q8` is the same kernel alone, for its exactness test and its
timing.  What bounds it on the H100: bytes (the weight read once and
written once: 1.8 MB for ViT-B/16's W_qkv, 2.4 MB for W1 or W2, 1.2 MB for
a tp 2 shard of either).
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.kernels import _build


def kmajor_q8_plain(w_q) -> torch.Tensor:
    """The K-major copy of an int8 [in, out] weight: its transpose, (out,
    in) row-major."""
    return w_q.t().contiguous()


def kmajor_q8(w_q) -> torch.Tensor:
    """The K-major copy that the int8 GEMMs of the bf16 K15-K17 and K18a and
    of K18b read, made by the kernel their launch sequences start with
    (``vt_transpose_q8``) on a CUDA tensor, by the plain twin on a CPU one."""
    if w_q.device.type == "cpu":
        return kmajor_q8_plain(w_q)
    name = "kmajor_q8"
    if w_q.dtype != torch.int8 or not w_q.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous int8 matrix, got {w_q.dtype}")
    _build.check_q8_matrices(name, w_q)
    out, = kmajor_q8_scratch(w_q)
    rows, cols = w_q.shape
    _build.check(_build.load_library().vt_transpose_q8(
        w_q.data_ptr(), out.data_ptr(), rows, cols, w_q.device.index, _build.stream_of(w_q)),
        name)
    return out


def kmajor_q8_scratch(*weights) -> list:
    """An uninitialised (out, in) int8 tensor for the K-major copy of each
    [in, out] weight, on its device."""
    return [torch.empty(w.shape[1], w.shape[0], dtype=torch.int8, device=w.device)
            for w in weights]

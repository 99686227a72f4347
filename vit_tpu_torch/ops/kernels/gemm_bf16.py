"""The bf16 GEMM core of K1 and K2 alone, CUDA (``csrc/gemm_bf16.cu`` over
``csrc/gemm_mma.cuh``): c = a @ b with a (M, K) and b (K, N) bf16
row-major, fp32 accumulation, c fp32 unrounded.

No path of the port calls it: K1 and K2 run the same core with their own
epilogues.  It exists so that the card tests can hold the core alone to
``torch.matmul`` at ragged M, N and K, and so that ``chip_smoke.py`` can
time it at the main path's four GEMM shapes beside ``torch.matmul``.

What bounds it on the H100: operations (2 M N K at 989 TFLOP/s bf16) at
the main path's shapes.  The design is the header's: a ring of three
shared-memory stages filled by 16-byte ``cp.async`` (zero past M, N and
K) in the 128-byte swizzle ``wgmma`` reads, two warpgroups issuing
``wgmma.mma_async`` m64n128k16 into fp32 registers, one barrier per
k-step, the tile staged through shared memory for a coalesced epilogue.
Widths must be multiples of 8 elements and rows 16-byte aligned
(``_build.check_tiles``).
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.kernels import _build


def gemm_bf16_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain twin: the fp32 product of the bf16 operands."""
    return a.float() @ b.float()


def gemm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) bf16 -> (M, N) fp32.  CPU tensors take the plain
    twin; CUDA tensors launch the kernel."""
    if a.device.type == "cpu":
        return gemm_bf16_plain(a, b)
    name = "gemm_bf16"
    _build.check_operands(name, a, b)
    if a.dtype != torch.bfloat16:
        raise TypeError(f"{name}: expected bfloat16 operands, got {a.dtype}")
    (m, k), n = a.shape, b.shape[-1]
    _build.check_shape(name, "b", b, (k, n))
    _build.check_tiles(name, a=a, b=b)
    c = torch.empty(m, n, dtype=torch.float32, device=a.device)
    lib = _build.load_library()
    _build.check(
        lib.vt_gemm_bf16(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, a.device.index,
                         _build.stream_of(a)),
        name,
    )
    gemm_bf16.launches += 1
    return c


gemm_bf16.launches = 0

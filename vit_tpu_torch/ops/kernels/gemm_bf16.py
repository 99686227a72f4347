"""The bf16 GEMM core of K1, K2, K8 and K12b alone, CUDA
(``csrc/gemm_bf16.cu`` over ``csrc/gemm_mma.cuh``): c = op(a) @ op(b) with
bf16 row-major operands, fp32 accumulation, c fp32 unrounded.  op(a) is a
(M, K), or with ``trans_a`` the transpose of a (K, M) (the core's MN-major
A: an activation read transposed, hᵀ of a weight gradient); op(b) is b (K,
N), or with ``trans_b`` the transpose of b (N, K) (its K-major B: an [in,
out] weight read transposed, dY Wᵀ); not both, as no kernel reads them so.
``splits`` 1 runs one pass; 0 splits the depth K over the grid as the
weight gradients do; n > 1 into n splits; each split writes an fp32
partial and a second pass adds them in split order.

No path of the port calls it: the kernels run the same core with their own
epilogues.  It exists so that the card tests can hold the core alone, in
each form, to ``torch.matmul`` at ragged M, N and K, and so that
``chip_smoke.py`` can time it at the main path's GEMM shapes beside
``torch.matmul``.

What bounds it on the H100: operations (2 M N K at 989 TFLOP/s bf16) at
the main path's shapes.  The design is the header's: TMA loads (2-D tensor
maps, 128-byte swizzle, zero fill past M, N and K) into a ring of three
shared-memory stages with a full and an empty mbarrier each, one thread
issuing the copies, two warpgroups issuing ``wgmma.mma_async`` m64n128k16
into fp32 registers with no block-wide barrier in the main loop, the tile
staged through shared memory for a coalesced epilogue.  The widths of the
operands as they lie in memory (the last axes) must be multiples of 8
elements and every row 16-byte aligned (``_build.check_tiles``); the outer
axes may be ragged.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.kernels import _build


def gemm_bf16_plain(a: torch.Tensor, b: torch.Tensor, trans_a: bool = False,
                    trans_b: bool = False, splits: int = 1) -> torch.Tensor:
    """Plain twin: the fp32 product of the bf16 operands, each transposed
    as asked (the split changes only the kernel's summation order)."""
    a, b = a.float(), b.float()
    return (a.T if trans_a else a) @ (b.T if trans_b else b)


def gemm_bf16(a: torch.Tensor, b: torch.Tensor, trans_a: bool = False, trans_b: bool = False,
              splits: int = 1) -> torch.Tensor:
    """op(a) @ op(b), bf16 -> (M, N) fp32.  CPU tensors take the plain twin;
    CUDA tensors launch the kernel."""
    if a.device.type == "cpu":
        return gemm_bf16_plain(a, b, trans_a, trans_b, splits)
    name = "gemm_bf16"
    _build.check_operands(name, a, b)
    if a.dtype != torch.bfloat16:
        raise TypeError(f"{name}: expected bfloat16 operands, got {a.dtype}")
    if trans_a and trans_b:
        raise ValueError(f"{name}: the core reads a transposed or b transposed, not both")
    if splits < 0:
        raise ValueError(f"{name}: splits must be 0 (the weight gradients' rule) or positive")
    k, m = a.shape if trans_a else a.shape[::-1]
    n = b.shape[0] if trans_b else b.shape[-1]
    _build.check_shape(name, "b", b, (n, k) if trans_b else (k, n))
    _build.check_tiles(name, a=a, b=b)
    c = torch.empty(m, n, dtype=torch.float32, device=a.device)
    part = _build.workspace("vt_gemm_bf16_workspace", a.device, m, n, k, splits)
    lib = _build.load_library()
    _build.check(
        lib.vt_gemm_bf16(a.data_ptr(), b.data_ptr(), c.data_ptr(), part.data_ptr(), m, n, k,
                         int(trans_a), int(trans_b), splits, a.device.index,
                         _build.stream_of(a)),
        name,
    )
    gemm_bf16.launches += 1
    return c


gemm_bf16.launches = 0

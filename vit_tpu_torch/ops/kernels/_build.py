"""Build the CUDA kernels at first use and bind them with ``ctypes``.

The sources in ``vit_tpu_torch/csrc`` (``*.cu``, ``*.cuh``) have a plain C
interface and include no PyTorch header.  One ``nvcc`` per ``.cu``, all
started together, compiles each to an object file; one more links them
into a shared library::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o <name>.o vit_tpu_torch/csrc/<name>.cu    # each
    nvcc -shared -o build/vit_tpu_torch/libvit_tpu_torch_<hash>.so *.o

The library's name carries a hash of the sources and flags, so an edit
rebuilds it and an unchanged tree reuses it.  A missing ``nvcc`` or a
failed build raises ``RuntimeError``; nothing falls back to another
implementation.

Every C entry point takes raw pointers (``tensor.data_ptr()``), the device
index and PyTorch's current stream, launches on that stream, and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero status.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "vit_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

# kernel-side dtype codes (csrc/common.cuh DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
_L3 = [ctypes.c_longlong] * 3  # a (batch, head, token, dh) view's element strides
# the regularized kernels' dropout arguments: seed, threshold, kept value,
# dropout on (fused_block.dropout_launch_args)
_DROP = [_U, _U, _F, _I]
SIGNATURES = {
    # x, scale, bias, out, rows, d, eps, vecs, dtype, device, stream
    "vt_layer_norm": [_P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _P],
    # x, ln_scale, ln_bias, wqkv, bqkv, stats, h, qkv, ctx, log_size, kmean,
    # batch, seq, d, heads, head_dim, eps, dtype, device, stream
    "vt_ln_qkv_attn": [_P] * 11 + [_I] * 5 + [_F, _I, _I, _P],
    # ctx, res, wo, bo, ln_scale, ln_bias, w1, b1, w2, b2, x1, stats, h, g,
    # out, rows, d_ctx, d, f, eps, gelu_variant, dtype, device, stream
    "vt_out_ln_mlp_residual": [_P] * 15 + [_I] * 4 + [_F, _I, _I, _I, _P],
    # a, b, c, partials, m, n, k, trans_a, trans_b, splits, device, stream
    "vt_gemm_bf16": [_P] * 4 + [_I] * 7 + [_P],
    # ctx, res, wo, bo, out, rows, d_ctx, d, dtype, device, stream
    "vt_out_residual": [_P] * 5 + [_I] * 5 + [_P],
    # x, ln_scale, ln_bias, w1, b1, w2, b2, stats, h, g, u, out,
    # rows, d, f, eps, gelu_variant, dtype, device, stream
    "vt_ln_mlp_residual": [_P] * 12 + [_I] * 3 + [_F, _I, _I, _I, _P],
    # x, ln_scale, ln_bias, w1, b1, w2, stats, h, g, u, out,
    # rows, d, f, eps, gelu_variant, dtype, device, stream
    "vt_ln_mlp_partial": [_P] * 11 + [_I] * 3 + [_F, _I, _I, _I, _P],
    # dy, x1, ctx, ln_scale, ln_bias, w1, b1, w2, wo, u, dx1, dctx, dgamma,
    # dbeta, dw1, db1, dw2, db2, dwo, dbo, workspace,
    # rows, d, f, d_ctx, eps, gelu_variant, u_dtype, dtype, device, stream
    "vt_ln_mlp_out_residual_bwd": [_P] * 21 + [_I] * 4 + [_F, _I, _I, _I, _I, _P],
    # dctx, dres, x, ln_scale, ln_bias, wqkv, bqkv, log_size, qkv, dx,
    # dgamma, dbeta, dwqkv, dbqkv, workspace, batch, seq, d, heads, head_dim,
    # eps, dtype, device, stream
    "vt_ln_qkv_attn_bwd": [_P] * 15 + [_I] * 5 + [_F, _I, _I, _P],
    # ctx, res, wo, bo, dp, out, rows, d_ctx, d, <dropout>, dtype, device, stream
    "vt_out_residual_train": [_P] * 6 + [_I] * 3 + _DROP + [_I, _I, _P],
    # x, ln_scale, ln_bias, w1, b1, w2, b2, dp, stats, h, g, out,
    # rows, d, f, eps, gelu_variant, <dropout>, dtype, device, stream
    "vt_ln_mlp_residual_train": [_P] * 12 + [_I] * 3 + [_F, _I] + _DROP + [_I, _I, _P],
    # dy, x1, ctx, ln_scale, ln_bias, w1, b1, w2, wo, dp_mlp, dp_attn, dx1,
    # dctx, dgamma, dbeta, dw1, db1, dw2, db2, dwo, dbo, workspace,
    # rows, d, f, d_ctx, eps, gelu_variant, <dropout>, dtype, device, stream
    "vt_ln_mlp_out_residual_bwd_train": [_P] * 22 + [_I] * 4 + [_F, _I] + _DROP + [_I, _I, _P],
    # dy, x1, ln_scale, ln_bias, w1, b1, w2, u, dx1, dgamma, dbeta, dw1, db1,
    # dw2, db2, workspace, rows, d, f, eps, gelu_variant, residual, u_dtype,
    # dtype, device, stream
    "vt_ln_mlp_residual_bwd": [_P] * 16 + [_I] * 3 + [_F, _I, _I, _I, _I, _I, _P],
    # dx1, ctx, wo, dctx, dwo, dbo, workspace, rows, d_ctx, d, dtype, device,
    # stream
    "vt_out_residual_bwd": [_P] * 7 + [_I] * 5 + [_P],
    # dy, x1, ln_scale, ln_bias, w1, b1, w2, dp_mlp, dx1, dgamma, dbeta, dw1,
    # db1, dw2, db2, workspace, rows, d, f, eps, gelu_variant, <dropout>,
    # dtype, device, stream
    "vt_ln_mlp_residual_bwd_train": [_P] * 16 + [_I] * 3 + [_F, _I] + _DROP + [_I, _I, _P],
    # dx1, ctx, wo, dp_attn, dctx, dwo, dbo, workspace, rows, d_ctx, d,
    # <dropout>, dtype, device, stream
    "vt_out_residual_bwd_train": [_P] * 8 + [_I] * 3 + _DROP + [_I, _I, _P],
    # q, k, v, <strides>, out, <strides>, lse, batch, heads, seq, head_dim,
    # dtype, device, stream
    "vt_flash_fwd": [_P] * 3 + _L3 + [_P] + _L3 + [_P] + [_I] * 6 + [_P],
    # q, k, v, <strides>, dout, <strides>, lse, delta, dq, dk, dv, <strides>,
    # batch, heads, seq, head_dim, dtype, device, stream
    "vt_flash_bwd": [_P] * 3 + _L3 + [_P] + _L3 + [_P] * 5 + _L3 + [_I] * 6 + [_P],
    # x, ln_scale, ln_bias, wq, ws, bqkv, wqt, hq, hs, qkv, rows, d, d3, eps,
    # dtype, device, stream
    "vt_ln_qkv_q8": [_P] * 10 + [_I] * 3 + [_F, _I, _I, _P],
    # x, ln_scale, ln_bias, wq, ws, bqkv, wqt, hq, hs, qkv, ctx, log_size,
    # kmean, batch, seq, d, heads, head_dim, eps, dtype, device, stream
    "vt_ln_qkv_attn_q8": [_P] * 13 + [_I] * 5 + [_F, _I, _I, _P],
    # ctx, res, wo, bo, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, w1t,
    # w2t, x1, hq, hs, mid, mq, ms, out, rows, d_ctx, d, f, eps, gelu_variant,
    # dtype, device, stream
    "vt_out_ln_mlp_residual_q8": [_P] * 21 + [_I] * 4 + [_F, _I, _I, _I, _P],
    # a, sa, bt, sb, out, m, n, k, device, stream
    "vt_gemm_q8_mma_dequant": [_P] * 5 + [_I] * 4 + [_P],
    # src, dst, rows, cols, device, stream
    "vt_transpose_q8": [_P] * 2 + [_I] * 3 + [_P],
    # x, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, w1t, w2t, hq, hs, mid,
    # mq, ms, out, rows, d, f, eps, gelu_variant, dtype, device, stream
    "vt_ln_mlp_residual_q8": [_P] * 17 + [_I] * 3 + [_F, _I, _I, _I, _P],
    # a, sa, b, sb, out, m, n, k, device, stream
    "vt_gemm_q8_dequant": [_P] * 5 + [_I] * 4 + [_P],
    # x, ln_scale, ln_bias, w1q, w1s, b1, w1t, hq, hs, mid, rows, d, f, eps,
    # gelu_variant, fast_erf, dtype, device, stream
    "vt_ln_fc1_gelu_q8": [_P] * 10 + [_I] * 3 + [_F] + [_I] * 4 + [_P],
    # mid, ms, w2q, w2t, mq, out, rows, f, d, device, stream
    "vt_fc2_q8_partial": [_P] * 6 + [_I] * 4 + [_P],
    # x, ln_scale, ln_bias, wq, ws, bqkv, wqt, hq, hs, qkv, q8, qs, k8, ks, v8,
    # vs, p8, ctx, batch, seq, d, heads, head_dim, quant_pv, eps, dtype,
    # device, stream
    "vt_ln_qkv_attn_q8a": [_P] * 18 + [_I] * 6 + [_F, _I, _I, _P],
    # q, <strides>, k, <strides>, v, <strides>, out, <strides>, batch, heads,
    # seq, head_dim, dtype, device, stream
    "vt_scaled_dot_product_attention": ([_P] + _L3) * 4 + [_I] * 6 + [_P],
    # x, w1, b1, w2, b2, g, out, rows, d, f, gelu_variant, dtype, device, stream
    "vt_mlp": [_P] * 7 + [_I] * 6 + [_P],
    # g[], p[], m[], v[], n[], aligned[], leaves, lr, b1, 1 - b1, b2, 1 - b2,
    # eps, weight_decay, bc1, bc2, p dtype, g dtype, device, stream
    "vt_adamw": [_P] * 6 + [_I] + [_F] * 9 + [_I] * 3 + [_P],
}

# workspace size queries (bytes) of the kernels that carve their scratch
# from one buffer the wrapper allocates
WORKSPACE_SIGNATURES = {
    # rows, d, f, d_ctx, dtype
    "vt_ln_mlp_out_residual_bwd_workspace": [_I] * 5,
    "vt_ln_mlp_out_residual_bwd_train_workspace": [_I] * 5,
    # batch, seq, d, heads, head_dim, dtype
    "vt_ln_qkv_attn_bwd_workspace": [_I] * 6,
    # rows, d, f, dtype
    "vt_ln_mlp_residual_bwd_workspace": [_I] * 4,
    "vt_ln_mlp_residual_bwd_train_workspace": [_I] * 4,
    # rows, d_ctx, d, dtype
    "vt_out_residual_bwd_workspace": [_I] * 4,
    # m, n, k, splits
    "vt_gemm_bf16_workspace": [_I] * 4,
    "vt_out_residual_bwd_train_workspace": [_I] * 4,
}


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` (default the toolkit's
    standard prefix, /usr/local/cuda)."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "cannot build the vit_tpu_torch CUDA kernels: nvcc not found on PATH "
        "or under $CUDA_HOME/bin (install the CUDA toolkit, or run on the "
        "CPU, where the kernels' plain PyTorch versions are used)"
    )


def sources():
    """(.cu translation units, .cuh headers), sorted."""
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cu, cuh = sources()
    for path in (*cu, *cuh):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libvit_tpu_torch_{source_hash()}.so"


def build() -> Path:
    """Compile the kernels unless a library for these exact sources exists;
    -> its path."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    cu, _ = sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in cu]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)] for o, src in zip(objs, cu)]
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        results = [(c, p.communicate()[0], p.returncode) for c, p in zip(cmds, procs)]
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        if all(rc == 0 for *_, rc in results):
            proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            results.append((link, proc.stdout, proc.returncode))
        failed = [(c, log, rc) for c, log, rc in results if rc != 0]
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                "nvcc failed building the vit_tpu_torch CUDA kernels:\n" + "\n".join(
                    f"(exit {rc}) {' '.join(c)}\n{log}" for c, log, rc in failed)
            )
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's signature."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, argtypes in WORKSPACE_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_size_t
    lib.vt_error_string.argtypes = [ctypes.c_int]
    lib.vt_error_string.restype = ctypes.c_char_p
    return lib


def check(status: int, kernel: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if status != 0:
        msg = load_library().vt_error_string(status).decode()
        raise RuntimeError(f"{kernel}: CUDA error {status} ({msg})")


def check_dtype_device(kernel: str, x: torch.Tensor, *others: torch.Tensor) -> None:
    """Every operand on x's CUDA device and in x's dtype (fp32 or bf16)."""
    if x.device.type != "cuda":
        raise ValueError(f"{kernel}: expected a CUDA or CPU tensor, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{kernel}: dtype {x.dtype} not supported (float32, bfloat16)")
    for t in (x, *others):
        if t.device != x.device:
            raise ValueError(f"{kernel}: operands on {t.device} and {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{kernel}: mixed dtypes {t.dtype} and {x.dtype}")


def check_operands(kernel: str, x: torch.Tensor, *others: torch.Tensor) -> None:
    """Every operand on x's CUDA device, in x's dtype (fp32 or bf16), and
    contiguous — what the kernels take; anything else raises."""
    check_dtype_device(kernel, x, *others)
    if not all(t.is_contiguous() for t in (x, *others)):
        raise ValueError(f"{kernel}: operands must be contiguous")


# int8 values per load of the int8 GEMM core (csrc/gemm_q8.cuh kQ8Vec)
Q8_VEC = 16


def check_q8_operands(kernel: str, x: torch.Tensor, like_x=(), int8=(), scales=()) -> None:
    """The W8A8 kernels' operands: ``like_x`` as :func:`check_operands`
    wants them; every ``int8`` matrix int8, both of its dimensions multiples
    of 16 and its memory 16-byte aligned (the int8 tiles fill with 16-byte
    loads); every ``scales`` vector float32; all contiguous, on x's device."""
    check_operands(kernel, x, *like_x)
    for t, dtype in (*((t, torch.int8) for t in int8), *((t, torch.float32) for t in scales)):
        if t.device != x.device:
            raise ValueError(f"{kernel}: operands on {t.device} and {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: expected a {dtype} operand, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: operands must be contiguous")
    check_q8_matrices(kernel, *int8)


def check_q8_matrices(kernel: str, *int8: torch.Tensor) -> None:
    """Each int8 matrix two-dimensional, both of its dimensions multiples of
    16 and its memory 16-byte aligned: the int8 cores' tiles fill with
    16-byte loads (``csrc/gemm_q8.cuh``) or TMA boxes over 16-byte row
    pitches (``csrc/gemm_mma_q8.cuh``).  Anything else raises
    ``ValueError``."""
    for t in int8:
        if t.dim() != 2 or t.shape[0] % Q8_VEC or t.shape[1] % Q8_VEC or t.data_ptr() % Q8_VEC:
            raise ValueError(
                f"{kernel}: an int8 matrix of shape {tuple(t.shape)} — both dimensions must "
                f"be multiples of {Q8_VEC} and the memory {Q8_VEC}-byte aligned"
            )


# bytes per lane of the tensor-core attention tiles' loads and stores
# (csrc/mma_bf16.cuh: cp.async and the output stores), and the base
# alignment of K20's vector path (csrc/adamw.cu)
VEC_BYTES = 16


def check_aligned(kernel: str, **views: torch.Tensor) -> None:
    """Each view's base address and its strides other than the last axis's
    (a (batch, head, token, dh) view's batch, head and token strides) are
    multiples of 16 bytes: K21, K13, K14 and K6's attention read and write
    16 bytes per lane, and the TMA tensor maps of the bf16 GEMM core (K1,
    K2, K4-K12c, K22 and K16's out_proj)
    take such bases and row pitches only.
    Axes of length 1 are never stepped, so their strides do not count.
    Anything else raises ``ValueError`` naming the operand."""
    for name, t in views.items():
        size = t.element_size()
        steps = [s * size for n, s in zip(t.shape[:-1], t.stride()[:-1]) if n > 1]
        if t.data_ptr() % VEC_BYTES or any(s % VEC_BYTES for s in steps):
            raise ValueError(
                f"{kernel}: {name} must start on a {VEC_BYTES}-byte boundary with strides of "
                f"whole {VEC_BYTES}-byte units; got address {t.data_ptr()} (mod {VEC_BYTES}: "
                f"{t.data_ptr() % VEC_BYTES}) and strides {tuple(t.stride())} of {size}-byte "
                "elements"
            )


# bf16 elements per 16-byte row step of the TMA + wgmma GEMM core of K1, K2,
# K4-K12c, K22 and K16's out_proj (csrc/gemm_mma.cuh)
TILE_VEC = 8


def check_tiles(kernel: str, widths=(), **mats: torch.Tensor) -> None:
    """The bf16 GEMM core's operands: each matrix in ``mats`` on the 16-byte
    grid (:func:`check_aligned`) and its last axis, like each ``(name,
    elements)`` of ``widths`` (the widths that set a scratch's row pitch), a
    multiple of 8 elements.  Anything else raises ``ValueError``."""
    for name, n in (*((name, t.shape[-1]) for name, t in mats.items()), *widths):
        if n % TILE_VEC:
            raise ValueError(f"{kernel}: {name} is {n} elements wide; the bf16 GEMM core "
                             f"takes widths in multiples of {TILE_VEC}")
    check_aligned(kernel, **mats)


def check_shape(kernel: str, name: str, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def check_row_scale(kernel: str, name: str, dp: torch.Tensor, x: torch.Tensor) -> None:
    """A stochastic-depth row scale: (rows,) fp32, contiguous, on x's device."""
    if dp.device != x.device or dp.dtype != torch.float32 or not dp.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous float32 on {x.device}")
    check_shape(kernel, name, dp, (x.shape[0],))


def ptr_or_null(t) -> int:
    """An optional operand's pointer: 0 (NULL) for None."""
    return 0 if t is None else t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def workspace(query: str, device: torch.device, *sizes: int) -> torch.Tensor:
    """A byte buffer as large as the kernel's ``<query>`` says it needs."""
    nbytes = getattr(load_library(), query)(*sizes)
    return torch.empty(nbytes, dtype=torch.uint8, device=device)

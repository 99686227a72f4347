"""K6: backward of LN1 -> packed QKV -> attention, joined with the first
residual's gradient, CUDA (``csrc/ln_qkv_attn_bwd.cu``).

Replaces ``vit_tpu/ops/pallas/backward.py:ln_qkv_attn_bwd`` (pallas_call at
:967; body ``_ln_qkv_attn_bwd_kernel`` :818), with or without ``dres`` and
with token merging's ``log_size`` and with or without the packed-QKV
stash ``qkv``.  ``log_size`` (B, T) fp32 is added to the recomputed key
logits before the row max, so the probs are the forward's
(``backward.py:861``); ``dres=None`` (the standalone VJP of K1) joins a
zero residual gradient, which adds exactly nothing.  ``qkv`` (B*T, 3D) in
the dtype, K1's ``return_qkv`` (round(LN1(x) W_qkv + b_qkv)), is read in
place of the QKV recompute, as the TPU kernel's ``qkv_ref``
(``backward.py:843-844``): a host-side branch skips the QKV GEMM and
points the attention backward at the stash; LN1's statistics and h1 are
still computed, because dW_qkv and dx read them.  K1's bf16 QKV is the
same core's output rounded the same way as the recompute, so the stash
gives the recompute's gradients bit for bit.

What bounds it on the H100: operations.  B/16 batch 64 (12,608 rows):
three GEMMs of 2 rows D 3D each (the QKV recompute, dh1 = dQKV Wᵀ and
dW_qkv; 134 GFLOP) and the attention backward's five T² dh products per
image and head (19.1 GFLOP), then ~0.3 GB of row traffic.  The TPU kernel
recomputes one image's QKV and probs in VMEM and holds dQKV in a VMEM
scratch; Hopper blocks run in no order, so this is a chain of launches with
device scratch between them, every reduction over rows a fixed-order pass:
no float atomics, two runs give the same bits.  bf16, the path's dtype:
LN1(x) once per row into a bf16 scratch; the QKV GEMM (K1's) and dh1 =
round(dQKV) W_qkvᵀ (W_qkv read K-major) and dW_qkv = h1ᵀ round(dQKV) (h1
read MN-major, the rows split) on the TMA + ``wgmma`` core
(``csrc/gemm_mma.cuh``); the attention backward on ``mma.sync`` register
tiles in three launches of one block per (image, head, 64-row tile) that
read q, k, v and dctx in place: the row statistics (lse and delta = Σₖ p
dp, two passes over the keys), then K14's dK/dV (keys outer) and dQ
(queries outer) bodies (``csrc/flash_bwd_mma.cuh``) with the key-bias hook
and a flush that writes each block's own rows of the fp32 dQKV and of
round(dQKV).  Every operand the core reads through a tensor map or 16-byte
copies (dctx, x, w_qkv) on the 16-byte grid, D a multiple of 8 elements
(``check_tile_operands``).  fp32 keeps the FMA core with LN1 in the tile
loads and a SIMT attention backward, one block per (head, image) looping
over 64-query tiles, adding dk/dv into dQKV rows only it owns.

Rounding points (the TPU kernel's): h1 rounded; qkv = round(h1 W + b);
q_s = round(q * round(scale)); p = e * (1 / sum e) fp32 (the bf16 kernel:
exp(s - lse), within |lse| 2⁻²⁴ of it), p_c = round(p);
dv = p_c^T dctx_h; dp = dctx_h v^T; ds = p (dp - rowsum(dp p)); dq =
(round(ds) k) * scale; dk = round(ds)^T q_s; dqkv fp32; dh1 = round(dqkv)
W^T; dx = dres + LN-bwd(dh1).
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.backward import _ln_bwd_dx, _ln_stats
from vit_tpu_torch.ops.kernels import _build
from vit_tpu_torch.ops.kernels.ln_qkv_attn import HEAD_DIMS, _check_log_size


def ln_qkv_attn_bwd_plain(
    dctx, dres, x2d, ln_scale, ln_bias, wqkv, bqkv, num_heads: int, seq_len: int, eps: float,
    log_size=None, qkv=None,
):
    """Plain twin: fp32 compute with casts at the TPU kernel's rounding
    points.  -> (dx, dgamma, dbeta, dwqkv, dbqkv); dx in the dtype, the
    rest fp32.  ``dres=None`` leaves out the residual join; ``qkv``, the
    packed-QKV stash, replaces the recompute."""
    cd = x2d.dtype
    rows, _ = x2d.shape
    d3 = wqkv.shape[-1]
    dh = d3 // (3 * num_heads)
    b = rows // seq_len
    gamma = ln_scale.float()
    xhat, inv = _ln_stats(x2d.float(), eps)
    h1 = (xhat * gamma + ln_bias.float()).to(cd)
    if qkv is None:
        qkv = (h1.float() @ wqkv.float() + bqkv.float()).to(cd)
    qkv = qkv.reshape(b, seq_len, num_heads, 3, dh).permute(3, 0, 2, 1, 4)
    q, k, v = qkv[0].float(), qkv[1].float(), qkv[2].float()  # (B, H, T, dh)
    scale = 1.0 / dh ** 0.5
    q_s = (q * torch.tensor(scale, dtype=cd).float()).to(cd).float()
    s = q_s @ k.transpose(-1, -2)
    if log_size is not None:
        s = s + log_size.float().reshape(b, 1, 1, seq_len)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e * (1.0 / e.sum(dim=-1, keepdim=True))
    g = dctx.reshape(b, seq_len, num_heads, dh).permute(0, 2, 1, 3).to(cd).float()
    dv = p.to(cd).float().transpose(-1, -2) @ g
    dp = g @ v.transpose(-1, -2)
    ds_c = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(cd).float()
    dq = (ds_c @ k) * scale
    dk = ds_c.transpose(-1, -2) @ q_s
    dqkv = torch.stack([dq, dk, dv], dim=3)  # (B, H, T, 3, dh)
    dqkv = dqkv.permute(0, 2, 1, 3, 4).reshape(rows, d3)
    dqkv_c = dqkv.to(cd).float()
    dh1 = dqkv_c @ wqkv.float().t()
    dx_ln = _ln_bwd_dx(dh1, xhat, inv, gamma)
    dx = (dx_ln if dres is None else dres.float() + dx_ln).to(cd)
    return dx, (dh1 * xhat).sum(0), dh1.sum(0), h1.float().t() @ dqkv_c, dqkv.sum(0)


def check_tile_operands(dctx, dres, x2d, ln_scale, ln_bias, wqkv, *_, **__) -> None:
    """bf16: dctx, x and w_qkv on the 16-byte grid, their widths (d_ctx, D,
    3D) multiples of 8 elements; the wrapper's arguments, raises
    ``ValueError`` otherwise."""
    _build.check_tiles("ln_qkv_attn_bwd", dctx=dctx, x=x2d, wqkv=wqkv)


def ln_qkv_attn_bwd(
    dctx, dres, x2d, ln_scale, ln_bias, wqkv, bqkv, num_heads: int, seq_len: int, eps: float,
    qkv=None, log_size=None,
):
    """VJP of ``ln_qkv_attn`` joined with the residual: dx = dres +
    d(LN1 + QKV + attention)/dx, or without the join when ``dres`` is None;
    ``log_size`` (B, T) fp32 when the forward had token merging's bias;
    ``qkv`` (B*T, 3D) in the dtype, the forward's packed QKV (K1's
    ``return_qkv``), replaces the recompute.  CPU tensors take the plain
    twin; CUDA tensors launch the kernel."""
    name = "ln_qkv_attn_bwd"
    if x2d.device.type == "cpu":
        return ln_qkv_attn_bwd_plain(
            dctx, dres, x2d, ln_scale, ln_bias, wqkv, bqkv, num_heads, seq_len, eps, log_size, qkv
        )
    if dres is None:
        dres = torch.zeros_like(x2d)
    _build.check_operands(name, x2d, dctx, dres, ln_scale, ln_bias, wqkv, bqkv)
    rows, d = x2d.shape
    d3 = wqkv.shape[-1]
    if d3 % (3 * num_heads) or rows % seq_len:
        raise ValueError(
            f"{name}: W_qkv width {d3} is not 3 x {num_heads} heads, or "
            f"{rows} rows are not whole sequences of {seq_len}"
        )
    dh = d3 // (3 * num_heads)
    if dh not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {dh} not in {HEAD_DIMS}")
    if seq_len > 1024:
        raise ValueError(f"{name}: seq_len {seq_len} > 1024 (the flash kernels' range)")
    _build.check_shape(name, "dctx", dctx, (rows, d3 // 3))
    _build.check_shape(name, "dres", dres, (rows, d))
    _build.check_shape(name, "ln_scale", ln_scale, (d,))
    _build.check_shape(name, "ln_bias", ln_bias, (d,))
    _build.check_shape(name, "wqkv", wqkv, (d, d3))
    _build.check_shape(name, "bqkv", bqkv, (d3,))
    _check_log_size(name, log_size, x2d, seq_len)
    if qkv is not None:
        if qkv.dtype != x2d.dtype or qkv.device != x2d.device or not qkv.is_contiguous():
            raise ValueError(f"{name}: qkv must be contiguous {x2d.dtype} on {x2d.device}")
        _build.check_shape(name, "qkv", qkv, (rows, d3))
    if x2d.dtype == torch.bfloat16:
        check_tile_operands(dctx, dres, x2d, ln_scale, ln_bias, wqkv)
        if qkv is not None:  # read in 16-byte copies, as the scratch it replaces
            _build.check_aligned(name, qkv=qkv)
    dev, code = x2d.device, _build.DTYPE_CODES[x2d.dtype]
    f32 = lambda *shape: torch.empty(*shape, dtype=torch.float32, device=dev)  # noqa: E731
    outs = (torch.empty(rows, d, dtype=x2d.dtype, device=dev), f32(d), f32(d), f32(d, d3), f32(d3))
    batch = rows // seq_len
    ws = _build.workspace("vt_ln_qkv_attn_bwd_workspace", dev, batch, seq_len, d, num_heads, dh,
                          code)
    lib = _build.load_library()
    _build.check(
        lib.vt_ln_qkv_attn_bwd(
            *(t.data_ptr() for t in (dctx, dres, x2d, ln_scale, ln_bias, wqkv, bqkv)),
            _build.ptr_or_null(log_size), _build.ptr_or_null(qkv), *(t.data_ptr() for t in outs), ws.data_ptr(), batch, seq_len, d, num_heads, dh,
            eps, code, dev.index, _build.stream_of(x2d),
        ),
        name,
    )
    ln_qkv_attn_bwd.launches += 1
    ln_qkv_attn_bwd.stash_launches += qkv is not None
    return outs


ln_qkv_attn_bwd.launches = 0
ln_qkv_attn_bwd.stash_launches = 0  # the launches given qkv=

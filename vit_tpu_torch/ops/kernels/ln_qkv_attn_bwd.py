"""K6: backward of LN1 -> packed QKV -> attention, joined with the first
residual's gradient, CUDA (``csrc/ln_qkv_attn_bwd.cu``).

Replaces ``vit_tpu/ops/pallas/backward.py:ln_qkv_attn_bwd`` (pallas_call at
:967; body ``_ln_qkv_attn_bwd_kernel`` :818), with or without ``dres`` and
with token merging's ``log_size``; the ``qkv`` stash has no caller and
raises.  ``log_size`` (B, T) fp32 is added to the recomputed key logits
before the row max, so the probs are the forward's (``backward.py:861``);
``dres=None`` (the standalone VJP of K1) joins a zero residual gradient,
which adds exactly nothing.

What bounds it on the H100: three GEMMs (B/16 batch 64: the QKV recompute,
dh1 = dQKV W^T and dW_qkv, 3 x 45 GFLOP) on the tensor cores, and the
attention backward (T = 197, dh = 64: about 7 T^2 dh multiply-adds per
image and head, in fp32 on the CUDA cores).  The TPU kernel recomputes one
image's QKV and probs in VMEM and holds dQKV in a VMEM scratch; here the
recomputed QKV is a dtype scratch and dQKV an fp32 one (116 MB at batch 64)
in device memory.  The attention backward runs one block per (head,
image) that loops over 64-query tiles; per tile it recomputes the softmax
statistics, then sum_k p dp, then per 64-key tile dq (registers) and dk/dv,
which it adds into the dQKV rows that only it owns.  So any T up to 1024
fits (one head's fp32 dK/dV at T = 1024 is 512 KB, past shared memory),
with no atomics: the sums run in a fixed order.  db, dgamma, dbeta and
dW_qkv are deterministic two-pass reductions over rows, as in K7.

Rounding points (the TPU kernel's): h1 rounded; qkv = round(h1 W + b);
q_s = round(q * round(scale)); p = e * (1 / sum e) fp32, p_c = round(p);
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
    log_size=None,
):
    """Plain twin: fp32 compute with casts at the TPU kernel's rounding
    points.  -> (dx, dgamma, dbeta, dwqkv, dbqkv); dx in the dtype, the
    rest fp32.  ``dres=None`` leaves out the residual join."""
    cd = x2d.dtype
    rows, _ = x2d.shape
    d3 = wqkv.shape[-1]
    dh = d3 // (3 * num_heads)
    b = rows // seq_len
    gamma = ln_scale.float()
    xhat, inv = _ln_stats(x2d.float(), eps)
    h1 = (xhat * gamma + ln_bias.float()).to(cd)
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


def ln_qkv_attn_bwd(
    dctx, dres, x2d, ln_scale, ln_bias, wqkv, bqkv, num_heads: int, seq_len: int, eps: float,
    qkv=None, log_size=None,
):
    """VJP of ``ln_qkv_attn`` joined with the residual: dx = dres +
    d(LN1 + QKV + attention)/dx, or without the join when ``dres`` is None;
    ``log_size`` (B, T) fp32 when the forward had token merging's bias.
    CPU tensors take the plain twin; CUDA tensors launch the kernel.  The
    ``qkv`` stash has no caller and raises."""
    name = "ln_qkv_attn_bwd"
    if qkv is not None:
        raise NotImplementedError(f"{name}: the qkv= stash is not ported (no caller; ROADMAP.md)")
    if x2d.device.type == "cpu":
        return ln_qkv_attn_bwd_plain(
            dctx, dres, x2d, ln_scale, ln_bias, wqkv, bqkv, num_heads, seq_len, eps, log_size
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
            _build.ptr_or_null(log_size), *(t.data_ptr() for t in outs), ws.data_ptr(), batch, seq_len, d, num_heads, dh,
            eps, code, dev.index, _build.stream_of(x2d),
        ),
        name,
    )
    ln_qkv_attn_bwd.launches += 1
    return outs


ln_qkv_attn_bwd.launches = 0

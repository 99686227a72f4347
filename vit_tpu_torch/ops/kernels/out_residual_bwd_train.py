"""K12c: split backward of the regularized [out_proj + residual], CUDA
(``csrc/out_residual_bwd_train.cu``).

Replaces ``vit_tpu/ops/pallas/backward.py:out_residual_bwd_train``
(pallas_call at :714; body ``_out_res_bwd_train_kernel`` :672).

Token merging's regularized training runs the encoder block's halves apart,
so the out_proj half's backward is a kernel of its own: K9 with the
forward's attention-out dropout mask and drop-path row scale on its input,
K12a's out_proj tail.  What bounds it on the H100: 4·rows·D·D_ctx
operations in two GEMMs (ViT-B/16 batch 64 at 197 tokens: 12,608 x 768 x
768, 29.7 GFLOP, 0.030 ms at 989 TFLOP/s), the weight gradient's depth the
ragged row axis.

  dz   = (dx1 * dp_attn) * m_attn   fp32; the mask a hash of (seed, site,
                                    absolute row, column), the rows this
                                    layer's B·t_l, as K10 hashed them
  dctx = round(round(dz) @ W_o^T), dW_o = ctx^T round(dz), db_o = sum dz

dz is written rounded once into a (rows, D) scratch the GEMMs read as plain
tiles, and summed in fp32 from a second hash for db_o, K9's deterministic
passes (no atomics).  The residual's gradient is dx1 itself, ungated; the
caller passes it on.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.fused_block import (
    DROP_SITE_ATTN_OUT,
    dropout_launch_args,
    dropout_mask,
)
from vit_tpu_torch.ops.kernels import _build


def out_residual_bwd_train_plain(dx1, ctx, wo, dp_attn, seed, dropout_p):
    """Plain twin -> (dctx in ctx's dtype, dwo fp32, dbo fp32).  ``dx1``
    may be fp32 (K12a's unrounded dx1) or in the dtype."""
    rows, d = dx1.shape
    dz = dx1.float() * dp_attn.float()[:, None]
    if dropout_p > 0:
        dz = dz * dropout_mask(seed, DROP_SITE_ATTN_OUT, 0, (rows, d), dropout_p, dx1.device)
    dz_c = dz.to(ctx.dtype)
    return ((dz_c.float() @ wo.float().t()).to(ctx.dtype), ctx.float().t() @ dz_c.float(),
            dz.sum(0))


def out_residual_bwd_train(dx1, ctx, wo, dp_attn, seed, dropout_p):
    """VJP of the regularized ``out_residual_train`` (K10) over (B*T, D)
    rows, from the upstream gradient ``dx1``, the saved ctx, the (rows,)
    fp32 drop-path scale and the layer's seed -> (dctx, dwo, dbo).  CPU
    tensors take the plain twin; CUDA tensors launch the kernel."""
    if dx1.device.type == "cpu":
        return out_residual_bwd_train_plain(dx1, ctx, wo, dp_attn, seed, dropout_p)
    name = "out_residual_bwd_train"
    _build.check_operands(name, dx1, ctx, wo)
    rows, d = dx1.shape
    d_ctx = ctx.shape[-1]
    _build.check_shape(name, "ctx", ctx, (rows, d_ctx))
    _build.check_shape(name, "wo", wo, (d_ctx, d))
    _build.check_row_scale(name, "dp_attn", dp_attn, dx1)
    dev, code = dx1.device, _build.DTYPE_CODES[dx1.dtype]
    outs = (torch.empty(rows, d_ctx, dtype=dx1.dtype, device=dev),
            torch.empty(d_ctx, d, dtype=torch.float32, device=dev),
            torch.empty(d, dtype=torch.float32, device=dev))
    ws = _build.workspace("vt_out_residual_bwd_train_workspace", dev, rows, d_ctx, d, code)
    lib = _build.load_library()
    _build.check(
        lib.vt_out_residual_bwd_train(
            dx1.data_ptr(), ctx.data_ptr(), wo.data_ptr(), dp_attn.data_ptr(),
            *(t.data_ptr() for t in outs), ws.data_ptr(), rows, d_ctx, d,
            *dropout_launch_args(seed, dropout_p), code, dev.index, _build.stream_of(dx1),
        ),
        name,
    )
    out_residual_bwd_train.launches += 1
    return outs


out_residual_bwd_train.launches = 0

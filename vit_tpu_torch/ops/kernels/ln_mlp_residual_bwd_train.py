"""K12b: split backward of the regularized [LN2 + MLP + residual], CUDA
(``csrc/ln_mlp_residual_bwd_train.cu``).

Replaces ``vit_tpu/ops/pallas/backward.py:ln_mlp_residual_bwd_train``
(pallas_call at :623; body ``_ln_mlp_bwd_train_kernel`` :562 with
``_mlp_bwd_core`` :111 and ``_mlp_grad_accum`` :159).

Token merging's regularized training runs the encoder block's halves apart
(the merge GEMM sits between out_proj and the MLP), so the MLP half's
backward is a kernel of its own: K12a's MLP half, cut from it as K8 is cut
from K7.  What bounds it on the H100: K8's five GEMMs, 10·rows·D·F
operations of tensor-core work (ViT-B/16 batch 64 at the first merged
layer's 171 tokens: 10,944 rows, 258 GFLOP).  The forward's masks are
regenerated from the seed, never stored:

  dy_m = (dy * dp_mlp) * m_out     FC2's backward reads round(dy_m)
  g    = round(gelu(u) * m_in)     dW2's operand
  du   = ((round(dy_m) @ W2^T) * m_in) * gelu'(u)
  dx1  = dy + LN-bwd(round(du) @ W1^T)        ungated residual path

Every mask is a hash of (seed, site, absolute row, column), and the rows
are this layer's merged B·t_l, so K11's forward masks come back bit for
bit.  dy_m is written rounded into K8's fp32 dh2 scratch while it is free
(twice: before the dh2 GEMM and after dh2's column sums), so no scratch is
added; the dropout gate is a template flag, so ``dropout_p == 0`` runs K8's
arithmetic on dy·dp_mlp.  bf16, the path's dtype, runs K8's chain on the
TMA + ``wgmma`` core with the gates compiled in (``csrc/mlp_bwd_mma.cuh``),
under K8's operand rule (``check_tile_operands``); fp32 keeps the FMA core.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.backward import _gelu_grad, _ln_bwd_dx, _ln_stats
from vit_tpu_torch.ops.fused_block import (
    DROP_SITE_MLP_INNER,
    DROP_SITE_MLP_OUT,
    _gelu,
    dropout_launch_args,
    dropout_mask,
    use_fast_erf,
)
from vit_tpu_torch.ops.kernels import _build
from vit_tpu_torch.ops.kernels.out_ln_mlp_residual import GELU_VARIANTS


def mlp_residual_bwd_train_plain(dy, x1, ln_scale, ln_bias, w1, b1, w2, dp_mlp, seed, dropout_p,
                                 eps, gelu_variant: str = "exact"):
    """The regularized MLP half's backward in fp32 with casts at the TPU
    kernel's rounding points.  -> (dx1, dgamma, dbeta, dw1, db1, dw2, db2),
    all fp32 (dx1 unrounded: K12a's out_proj tail gates it)."""
    cd, dev = dy.dtype, dy.device
    rows, d = dy.shape
    f = w1.shape[-1]
    fast = use_fast_erf(cd)
    dyf, gamma = dy.float(), ln_scale.float()
    dy_m = dyf * dp_mlp.float()[:, None]
    if dropout_p > 0:
        dy_m = dy_m * dropout_mask(seed, DROP_SITE_MLP_OUT, 0, (rows, d), dropout_p, dev)
    xhat, inv = _ln_stats(x1.float(), eps)
    h2 = (xhat * gamma + ln_bias.float()).to(cd)
    u = h2.float() @ w1.float() + b1.float()
    g = _gelu(u, gelu_variant, fast_erf=fast)
    dg = dy_m.to(cd).float() @ w2.float().t()
    if dropout_p > 0:
        m_in = dropout_mask(seed, DROP_SITE_MLP_INNER, 0, (rows, f), dropout_p, dev)
        g, dg = g * m_in, dg * m_in
    du = dg * _gelu_grad(u, gelu_variant, fast_erf=fast)
    du_c = du.to(cd)
    dh2 = du_c.float() @ w1.float().t()
    dx1 = dyf + _ln_bwd_dx(dh2, xhat, inv, gamma)
    return (
        dx1, (dh2 * xhat).sum(0), dh2.sum(0),
        h2.float().t() @ du_c.float(), du.sum(0),
        g.to(cd).float().t() @ dy_m.to(cd).float(), dy_m.sum(0),
    )


def ln_mlp_residual_bwd_train_plain(dy, x1, ln_scale, ln_bias, w1, b1, w2, dp_mlp, seed,
                                    dropout_p, eps, gelu_variant: str = "exact"):
    """Plain twin -> (dx1 in the dtype, dgamma, dbeta, dw1, db1, dw2, db2
    fp32)."""
    dx1, *grads = mlp_residual_bwd_train_plain(dy, x1, ln_scale, ln_bias, w1, b1, w2, dp_mlp,
                                               seed, dropout_p, eps, gelu_variant)
    return (dx1.to(dy.dtype), *grads)


def check_tile_operands(dy, x1, ln_scale, ln_bias, w1, b1, w2, *_, **__) -> None:
    """bf16: K8's operand rule (dy, x1, w1, w2 on the 16-byte grid, D and F
    multiples of 8 elements) on the wrapper's arguments; raises
    ``ValueError`` otherwise."""
    _build.check_tiles("ln_mlp_residual_bwd_train", dy=dy, x1=x1, w1=w1, w2=w2)


def ln_mlp_residual_bwd_train(dy, x1, ln_scale, ln_bias, w1, b1, w2, dp_mlp, seed, dropout_p,
                              eps, gelu_variant: str = "exact"):
    """VJP of the regularized ``ln_mlp_residual_train`` (K11) over (B*T, D)
    rows, from the upstream gradient ``dy``, the saved x1, the (rows,) fp32
    drop-path scale and the layer's seed -> (dx1, dgamma, dbeta, dw1, db1,
    dw2, db2).  CPU tensors take the plain twin; CUDA tensors launch the
    kernel."""
    if dy.device.type == "cpu":
        return ln_mlp_residual_bwd_train_plain(dy, x1, ln_scale, ln_bias, w1, b1, w2, dp_mlp,
                                               seed, dropout_p, eps, gelu_variant)
    name = "ln_mlp_residual_bwd_train"
    if gelu_variant not in GELU_VARIANTS:
        raise ValueError(f"{name}: gelu_variant {gelu_variant!r} not in {tuple(GELU_VARIANTS)}")
    _build.check_operands(name, dy, x1, ln_scale, ln_bias, w1, b1, w2)
    rows, d = dy.shape
    f = w1.shape[-1]
    _build.check_shape(name, "x1", x1, (rows, d))
    _build.check_shape(name, "ln_scale", ln_scale, (d,))
    _build.check_shape(name, "ln_bias", ln_bias, (d,))
    _build.check_shape(name, "w1", w1, (d, f))
    _build.check_shape(name, "b1", b1, (f,))
    _build.check_shape(name, "w2", w2, (f, d))
    _build.check_row_scale(name, "dp_mlp", dp_mlp, dy)
    if dy.dtype == torch.bfloat16:
        check_tile_operands(dy, x1, ln_scale, ln_bias, w1, b1, w2)
    dev, code = dy.device, _build.DTYPE_CODES[dy.dtype]
    f32 = lambda *shape: torch.empty(*shape, dtype=torch.float32, device=dev)  # noqa: E731
    outs = (torch.empty(rows, d, dtype=dy.dtype, device=dev),
            f32(d), f32(d), f32(d, f), f32(f), f32(f, d), f32(d))
    ws = _build.workspace("vt_ln_mlp_residual_bwd_train_workspace", dev, rows, d, f, code)
    lib = _build.load_library()
    _build.check(
        lib.vt_ln_mlp_residual_bwd_train(
            *(t.data_ptr() for t in (dy, x1, ln_scale, ln_bias, w1, b1, w2, dp_mlp)),
            *(t.data_ptr() for t in outs), ws.data_ptr(), rows, d, f, eps,
            GELU_VARIANTS[gelu_variant], *dropout_launch_args(seed, dropout_p), code, dev.index,
            _build.stream_of(dy),
        ),
        name,
    )
    ln_mlp_residual_bwd_train.launches += 1
    return outs


ln_mlp_residual_bwd_train.launches = 0

"""K7: merged backward of [LN2 + MLP + residual] and [out_proj + residual],
CUDA (``csrc/ln_mlp_out_residual_bwd.cu``).

Replaces ``vit_tpu/ops/pallas/backward.py:ln_mlp_out_residual_bwd``
(pallas_call at :380; body ``_ln_mlp_out_bwd_kernel`` :296 with
``_mlp_bwd_core`` :111 and ``_mlp_grad_accum`` :159), with or without the
pre-GELU stash ``u``.

The stash ``u=`` (rows, F), K5's ``return_u`` (round(h2 W1 + b1) in the
dtype) or any fp32 or dtype tensor of that shape, stands in for the FC1
recompute, as the TPU kernel's ``u_ref`` does (``backward.py:134-135``):
one pass widens it into the fp32 u/du scratch where the FC1 GEMM would
have written (``UStash``, ``csrc/ln_mlp_out_residual_bwd.cuh``), and the
chain goes on unchanged.  LN2's statistics and h2 are still computed: dW1,
dgamma and dx1 read them.  Given K5's rounded u, g and du differ from the
recompute by that rounding, as in the JAX package.

What bounds it on the H100: operations, 10·rows·D·F + 4·rows·D·d_ctx of
tensor-core work in seven GEMMs (ViT-B/16 @224 batch 64: 12,608 rows, D =
d_ctx = 768, F = 3,072; 327 GFLOP, 0.33 ms at 989 TFLOP/s), three of them
weight gradients whose depth is the ragged row axis.  The TPU kernel walks
row blocks in order and keeps W1, W2, W_o and the fp32 weight-gradient
accumulators in VMEM across grid steps.  Hopper blocks run in no order, so
the design is a chain of tiled GEMMs over all rows with device scratch
between them (the fp32 (rows, F) u/du buffer is 155 MB at batch 64), the
elementwise steps in their epilogues, and every reduction over rows as its
own fixed-order pass: weight gradients split their depth into fixed chunks
whose fp32 partials a second pass sums in order, and each column sum (db1,
db2, dgamma, dbeta, db_o) sums 128-row partials in order.  No float
atomics: two runs give bit-identical gradients.  bf16, the path's dtype,
runs K8's chain with the out_proj tail on the TMA + ``wgmma`` core
(``csrc/mlp_bwd_mma.cuh`` over ``csrc/gemm_mma.cuh``): LN2(x1) once per row
into a bf16 scratch, W2ᵀ, W1ᵀ and W_oᵀ read K-major, h2ᵀ, gᵀ and ctxᵀ read
MN-major, the weight gradients split over rows; every operand the core
reads through a tensor map (dy, ctx, w1, w2, wo) and x1 on the 16-byte
grid, D, F and d_ctx multiples of 8 elements (``check_tile_operands``).
fp32 keeps the FMA core (``csrc/ln_mlp_out_residual_bwd.cuh``), LN2 in the
tile loads.

Rounding points (the TPU kernel's): x-hat and 1/sigma from the rounded x1
in fp32; h2 rounded; u fp32, never rounded; g = GELU(u) fp32, rounded only
as dW2's operand; du = (dy W2ᵀ) gelu'(u) fp32, rounded to du_c; dh2 =
du_c W1ᵀ; dx1 = dy + LN-bwd(dh2) fp32, written in the dtype; dctx =
round(dx1) W_oᵀ, rounded; dW_o = ctxᵀ round(dx1); db_o sums the fp32 dx1.
bf16 differentiates the tanh-form erf, fp32 the A-S form.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.backward import _gelu_grad, _ln_bwd_dx, _ln_stats
from vit_tpu_torch.ops.fused_block import _gelu, use_fast_erf
from vit_tpu_torch.ops.kernels import _build
from vit_tpu_torch.ops.kernels.out_ln_mlp_residual import GELU_VARIANTS


def mlp_residual_bwd_plain(dy, x1, ln_scale, ln_bias, w1, b1, w2, eps, gelu_variant="exact",
                           residual: bool = True, u=None):
    """The MLP half of the twins of K7 and K8 (K8 is K7 without the
    out_proj tail): fp32 compute with casts at the TPU kernel's rounding
    points.  -> (dx1 fp32, dgamma, dbeta, dw1, db1, dw2, db2), all fp32.
    ``residual=False`` leaves dy's identity term out of dx1 (K8's
    tensor-parallel form); the rest is unchanged.  ``u``, the pre-GELU
    stash, widened to fp32, replaces the FC1 recompute."""
    cd = dy.dtype
    fast = use_fast_erf(cd)
    dyf, gamma = dy.float(), ln_scale.float()
    xhat, inv = _ln_stats(x1.float(), eps)
    h2 = (xhat * gamma + ln_bias.float()).to(cd)
    u = h2.float() @ w1.float() + b1.float() if u is None else u.float()
    g = _gelu(u, gelu_variant, fast_erf=fast)
    du = (dyf @ w2.float().t()) * _gelu_grad(u, gelu_variant, fast_erf=fast)
    du_c = du.to(cd)
    dh2 = du_c.float() @ w1.float().t()
    dx1 = _ln_bwd_dx(dh2, xhat, inv, gamma)
    if residual:
        dx1 = dyf + dx1
    return (
        dx1, (dh2 * xhat).sum(0), dh2.sum(0), h2.float().t() @ du_c.float(), du.sum(0),
        g.to(cd).float().t() @ dyf, dyf.sum(0),
    )


def ln_mlp_out_residual_bwd_plain(
    dy, x1, ctx, ln_scale, ln_bias, w1, b1, w2, wo, eps, gelu_variant: str = "exact", u=None,
):
    """Plain twin: fp32 compute with casts at the TPU kernel's rounding
    points.  -> (dx1, dctx, dgamma, dbeta, dw1, db1, dw2, db2, dwo, dbo);
    dx1 and dctx in the dtype, the rest fp32."""
    cd = dy.dtype
    dx1, dgamma, dbeta, dw1, db1, dw2, db2 = mlp_residual_bwd_plain(
        dy, x1, ln_scale, ln_bias, w1, b1, w2, eps, gelu_variant, u=u)
    dx1_c = dx1.to(cd)
    dctx = (dx1_c.float() @ wo.float().t()).to(cd)
    return (
        dx1_c, dctx, dgamma, dbeta, dw1, db1, dw2, db2,
        ctx.float().t() @ dx1_c.float(), dx1.sum(0),
    )


def check_stash(name: str, u, dy, f: int):
    """The pre-GELU stash of K7 and K8: (rows, F), fp32 or dy's dtype, on
    dy's device, contiguous; -> the dtype code the kernel widens from, or
    -1 without a stash.  Raises ``ValueError`` otherwise."""
    if u is None:
        return -1
    if u.dtype not in (torch.float32, dy.dtype) or u.device != dy.device \
            or not u.is_contiguous():
        raise ValueError(f"{name}: u must be contiguous float32 or {dy.dtype} on {dy.device}")
    _build.check_shape(name, "u", u, (dy.shape[0], f))
    return _build.DTYPE_CODES[u.dtype]


def check_tile_operands(dy, x1, ctx, ln_scale, ln_bias, w1, b1, w2, wo, *_, **__) -> None:
    """bf16: dy, x1, ctx and the three weights on the 16-byte grid, their
    widths (D, d_ctx through ctx, F through w1) multiples of 8 elements;
    the wrapper's arguments, raises ``ValueError`` otherwise."""
    _build.check_tiles("ln_mlp_out_residual_bwd", dy=dy, x1=x1, ctx=ctx, w1=w1, w2=w2, wo=wo)


def ln_mlp_out_residual_bwd(
    dy, x1, ctx, ln_scale, ln_bias, w1, b1, w2, wo, eps, gelu_variant: str = "exact",
    u=None,
):
    """VJP of [out_proj + residual] then [LN2 + MLP + residual] over (B*T, D)
    rows, from the upstream gradient ``dy`` and the saved x1 and ctx; ``u``
    (rows, F), the forward's pre-GELU stash, replaces the FC1 recompute.
    CPU tensors take the plain twin; CUDA tensors launch the kernel."""
    name = "ln_mlp_out_residual_bwd"
    if dy.device.type == "cpu":
        return ln_mlp_out_residual_bwd_plain(
            dy, x1, ctx, ln_scale, ln_bias, w1, b1, w2, wo, eps, gelu_variant, u
        )
    if gelu_variant not in GELU_VARIANTS:
        raise ValueError(f"{name}: gelu_variant {gelu_variant!r} not in {tuple(GELU_VARIANTS)}")
    _build.check_operands(name, dy, x1, ctx, ln_scale, ln_bias, w1, b1, w2, wo)
    rows, d = dy.shape
    d_ctx = ctx.shape[-1]
    f = w1.shape[-1]
    _build.check_shape(name, "x1", x1, (rows, d))
    _build.check_shape(name, "ctx", ctx, (rows, d_ctx))
    _build.check_shape(name, "ln_scale", ln_scale, (d,))
    _build.check_shape(name, "ln_bias", ln_bias, (d,))
    _build.check_shape(name, "w1", w1, (d, f))
    _build.check_shape(name, "b1", b1, (f,))
    _build.check_shape(name, "w2", w2, (f, d))
    _build.check_shape(name, "wo", wo, (d_ctx, d))
    u_code = check_stash(name, u, dy, f)
    if dy.dtype == torch.bfloat16:
        check_tile_operands(dy, x1, ctx, ln_scale, ln_bias, w1, b1, w2, wo)
    dev, code = dy.device, _build.DTYPE_CODES[dy.dtype]
    f32 = lambda *shape: torch.empty(*shape, dtype=torch.float32, device=dev)  # noqa: E731
    outs = (
        torch.empty(rows, d, dtype=dy.dtype, device=dev),
        torch.empty(rows, d_ctx, dtype=dy.dtype, device=dev),
        f32(d), f32(d), f32(d, f), f32(f), f32(f, d), f32(d), f32(d_ctx, d), f32(d),
    )
    ws = _build.workspace("vt_ln_mlp_out_residual_bwd_workspace", dev, rows, d, f, d_ctx, code)
    lib = _build.load_library()
    _build.check(
        lib.vt_ln_mlp_out_residual_bwd(
            *(t.data_ptr() for t in (dy, x1, ctx, ln_scale, ln_bias, w1, b1, w2, wo)),
            _build.ptr_or_null(u), *(t.data_ptr() for t in outs), ws.data_ptr(), rows, d, f,
            d_ctx, eps, GELU_VARIANTS[gelu_variant], u_code, code, dev.index,
            _build.stream_of(dy),
        ),
        name,
    )
    ln_mlp_out_residual_bwd.launches += 1
    ln_mlp_out_residual_bwd.stash_launches += u is not None
    return outs


ln_mlp_out_residual_bwd.launches = 0
ln_mlp_out_residual_bwd.stash_launches = 0  # the launches given u=

"""K5: LN2 -> FC1 -> GELU -> FC2 -> residual, CUDA
(``csrc/ln_mlp_residual.cu``).

Replaces ``vit_tpu/ops/pallas/fused_block.py:ln_mlp_residual`` (pallas_call
at :469; body ``_ln_mlp_kernel`` :422) in both its forms: the block's, and
``partial=True`` — tensor parallelism's (``parallel/tp_forward.py``):
W1/b1 hold this shard's hidden columns and W2 the matching rows, and the
kernel returns the fp32 partial ``g @ W2`` with no b2 and no residual
(``fused_block.py:435-436, :457``), which the shards sum.  Either form
takes ``return_u``, the pre-GELU stash ``u = round(h W1 + b1)``
(``fused_block.py:431-432``), and then returns ``(out, u)``.  The forms
are the same source with other epilogues (template arguments:
``StoreEpi<float>`` for FC2 in the partial form, ``BiasGeluStashEpi`` for
FC1 with the stash), so each compiles to kernels of its own; all count in
``ln_mlp_residual.launches``.

What bounds it on the H100: two GEMMs (B/16 batch 64: 12,608 rows, D = 768,
F = 3,072; 2 x 60 GFLOP) of tensor-core work.  The TPU kernel keeps W1 and
W2 resident in VMEM and never writes the hidden activation; a Hopper block
has 227 KB of shared memory, so the design is K2's MLP half.  bf16, the
main path: a row pass writes h = round(LN2(x)) once into a bf16 (rows, D)
scratch (19.4 MB at batch 64), then two GEMMs on the TMA + ``wgmma`` core
(``csrc/gemm_mma.cuh``): h @ W1 with an epilogue u + b1 -> GELU (fp32) ->
g rounded into a (rows, F) scratch (77 MB at batch 64), and g @ W2 whose
epilogue adds b2 and the residual x in fp32 and rounds, the residual rows
prefetched into L2 before it.  x, W1 and W2 must lie on the 16-byte grid
with D and F multiples of 8 elements (``check_tile_operands``).  fp32
keeps the first design: LN2 row statistics, then FMA GEMMs (never TF32)
with LN2 applied in FC1's A-tile load.  The residual is the rounded x1
that K4 wrote.  GELU: A-S erf in fp32, tanh-form erf in bf16.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.fused_block import _gelu, _ln, use_fast_erf
from vit_tpu_torch.ops.kernels import _build
from vit_tpu_torch.ops.kernels.out_ln_mlp_residual import GELU_VARIANTS


def ln_mlp_residual_plain(
    x2d, ln_scale, ln_bias, w1, b1, w2, b2, eps, gelu_variant: str = "exact",
) -> torch.Tensor:
    """Plain twin: fp32 compute with casts at the TPU kernel's rounding
    points."""
    dtype = x2d.dtype
    h = _ln(x2d, ln_scale, ln_bias, eps).to(dtype)
    u = h.float() @ w1.float() + b1.float()
    g = _gelu(u, gelu_variant, fast_erf=use_fast_erf(dtype)).to(dtype)
    return (g.float() @ w2.float() + b2.float() + x2d.float()).to(dtype)


def ln_mlp_partial_plain(x2d, ln_scale, ln_bias, w1, b1, w2, eps,
                         gelu_variant: str = "exact") -> torch.Tensor:
    """Plain twin of the partial form: fp32 ``g @ W2``, g rounded to the
    dtype as in the block's form."""
    dtype = x2d.dtype
    h = _ln(x2d, ln_scale, ln_bias, eps).to(dtype)
    u = h.float() @ w1.float() + b1.float()
    g = _gelu(u, gelu_variant, fast_erf=use_fast_erf(dtype)).to(dtype)
    return g.float() @ w2.float()


def ln_mlp_residual_u_plain(x2d, ln_scale, ln_bias, w1, b1, w2, b2, eps,
                            gelu_variant: str = "exact", partial: bool = False):
    """Plain twin of the ``return_u`` forms: ``(out, u)``, out the block's
    (or with ``partial`` the fp32 ``g @ W2``; b2 is then not read) and u
    the pre-GELU ``h W1 + b1`` rounded to the dtype."""
    dtype = x2d.dtype
    h = _ln(x2d, ln_scale, ln_bias, eps).to(dtype)
    u = h.float() @ w1.float() + b1.float()
    g = _gelu(u, gelu_variant, fast_erf=use_fast_erf(dtype)).to(dtype)
    acc = g.float() @ w2.float()
    return (acc if partial else (acc + b2.float() + x2d.float()).to(dtype)), u.to(dtype)


def check_tile_operands(x2d, ln_scale, ln_bias, w1, b1, w2, *_, **__) -> None:
    """bf16: the operands the GEMM core reads through TMA tensor maps — x
    (whose copy h the FC1 GEMM reads) and the two weights, whose widths D
    and F also set the scratches' pitches — on the 16-byte grid; the
    wrapper's arguments, raises ``ValueError`` otherwise."""
    _build.check_tiles("ln_mlp_residual", x=x2d, w1=w1, w2=w2)


def ln_mlp_residual(
    x2d, ln_scale, ln_bias, w1, b1, w2, b2, eps, gelu_variant: str = "exact",
    partial: bool = False, return_u: bool = False,
):
    """x + MLP(LN2(x)) over (B*T, D) rows; with ``partial`` the fp32
    ``MLP(LN2(x)) - b2`` of this shard's hidden columns (b2 is then not
    read); with ``return_u`` the pair ``(out, u)``, u the pre-GELU
    activation in x's dtype.  CPU tensors take the plain twins; CUDA
    tensors launch the kernel."""
    name = "ln_mlp_residual"
    if x2d.device.type == "cpu":
        if return_u:
            return ln_mlp_residual_u_plain(x2d, ln_scale, ln_bias, w1, b1, w2, b2, eps,
                                           gelu_variant, partial)
        if partial:
            return ln_mlp_partial_plain(x2d, ln_scale, ln_bias, w1, b1, w2, eps, gelu_variant)
        return ln_mlp_residual_plain(
            x2d, ln_scale, ln_bias, w1, b1, w2, b2, eps, gelu_variant
        )
    if gelu_variant not in GELU_VARIANTS:
        raise ValueError(f"{name}: gelu_variant {gelu_variant!r} not in {tuple(GELU_VARIANTS)}")
    _build.check_operands(name, x2d, ln_scale, ln_bias, w1, b1, w2, *(() if partial else (b2,)))
    rows, d = x2d.shape
    f = w1.shape[-1]
    for n, t in (("ln_scale", ln_scale), ("ln_bias", ln_bias), *(() if partial else (("b2", b2),))):
        _build.check_shape(name, n, t, (d,))
    _build.check_shape(name, "w1", w1, (d, f))
    _build.check_shape(name, "b1", b1, (f,))
    _build.check_shape(name, "w2", w2, (f, d))
    dev = x2d.device
    stats = h = None  # fp32's LN2 statistics, or bf16's LN2(x) rows
    if x2d.dtype == torch.bfloat16:
        check_tile_operands(x2d, ln_scale, ln_bias, w1, b1, w2)
        h = torch.empty(rows, d, dtype=x2d.dtype, device=dev)
    else:
        stats = torch.empty(2 * rows, dtype=torch.float32, device=dev)
    g = torch.empty(rows, f, dtype=x2d.dtype, device=dev)
    u = torch.empty(rows, f, dtype=x2d.dtype, device=dev) if return_u else None
    out = torch.empty(rows, d, dtype=torch.float32 if partial else x2d.dtype, device=dev)
    lib = _build.load_library()
    head = (x2d.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), *(() if partial else (b2.data_ptr(),)))
    entry = lib.vt_ln_mlp_partial if partial else lib.vt_ln_mlp_residual
    _build.check(
        entry(
            *head, _build.ptr_or_null(stats), _build.ptr_or_null(h), g.data_ptr(),
            _build.ptr_or_null(u), out.data_ptr(), rows, d, f, eps,
            GELU_VARIANTS[gelu_variant], _build.DTYPE_CODES[x2d.dtype], dev.index,
            _build.stream_of(x2d),
        ),
        name,
    )
    ln_mlp_residual.launches += 1
    ln_mlp_residual.stash_launches += return_u
    return (out, u) if return_u else out


ln_mlp_residual.launches = 0
ln_mlp_residual.stash_launches = 0  # the launches with return_u

"""MAE (masked-autoencoder) self-supervised pretraining (He et al. 2021) —
counterpart of ``vit_tpu.models.mae``.

  - The encoder uses the classifier's params layout exactly (cls_token /
    patch_embed / pos_embed / blocks / ln_final — ``vit.py``'s tree minus
    the head), so ``extract_backbone`` plus a fresh head gives a tree every
    classifier path loads.  Either package loads the other's ``.npz``: the
    decoder's names are the JAX package's too.
  - Masking is a per-image uniform-noise argsort (the paper's shuffle):
    ``len_keep`` is fixed by the config, and the keep/restore indices drive
    two ``torch.gather``\\ s.  ``masks_from_noise`` is the noise -> indices
    step alone, so that the JAX package's noise can be fed in.
  - The encoder runs on the visible tokens only (T 50 for B/16 @224 at the
    default 75% mask), through the op table: on ``fused_train`` the same
    kernels as supervised training, at that token count.
  - The decoder is a lightweight ViT (512 dim / 8 blocks / 16 heads by
    default) over the full token grid with mask tokens filled in; its
    blocks go through the same op table, its embed, LayerNorm and pred
    through the plain reference ops.  ``extract_backbone`` drops it.
  - Loss: per-patch MSE on the masked patches only, on (optionally
    per-patch normalized) channel-major pixel targets — ``patchify``
    flattens as ``reference.patch_embed`` does, so targets and the
    patch-embed GEMM's rows share one layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.models import vit
from vit_tpu_torch.ops import reference
from vit_tpu_torch.ops.dispatch import EAGER_OPS, OpsImpl

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MAEConfig:
    """Pretraining hyperparameters (paper defaults for ViT-B/16)."""

    mask_ratio: float = 0.75
    decoder_dim: int = 512
    decoder_depth: int = 8
    decoder_heads: int = 16
    norm_pix_loss: bool = True

    def decoder_cfg(self, cfg: ViTConfig) -> ViTConfig:
        """A ViTConfig view of the decoder (so the block and init machinery
        apply unchanged)."""
        # positivity first: a zero or negative geometry would otherwise pass
        # the divisibility check, or die in it with a ZeroDivisionError
        for field in ("decoder_dim", "decoder_depth", "decoder_heads"):
            v = getattr(self, field)
            if v <= 0:
                raise ValueError(f"{field} must be positive (got {v})")
        if self.decoder_dim % self.decoder_heads:
            raise ValueError(
                f"decoder_dim {self.decoder_dim} not divisible by "
                f"decoder_heads {self.decoder_heads}"
            )
        return dataclasses.replace(
            cfg,
            embed_dim=self.decoder_dim,
            depth=self.decoder_depth,
            num_heads=self.decoder_heads,
            distilled=False,
            name=f"{cfg.name}_mae_decoder",
        )

    def len_keep(self, cfg: ViTConfig) -> int:
        """Visible patches per image."""
        n = int(cfg.num_patches * (1.0 - self.mask_ratio))
        if not 0 < n < cfg.num_patches:
            # n == num_patches (mask_ratio ~ 0) would leave no masked patch:
            # the loss is identically zero and the run trains nothing
            raise ValueError(
                f"mask_ratio {self.mask_ratio} keeps {n} of "
                f"{cfg.num_patches} patches; need at least 1 visible and "
                "1 masked patch"
            )
        return n


def check_config(cfg: ViTConfig) -> None:
    if cfg.distilled:
        raise ValueError(
            "MAE pretraining targets the plain-ViT backbone family; "
            "distilled (DeiT) configs carry a distillation token whose "
            "pretraining recipe is distillation, not masking"
        )


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(..., C, H, W) -> (..., num_patches, C*p*p) pixel targets, in the
    patch-major / channel-major order of ``reference.patch_embed``'s GEMM
    rows."""
    *lead, c, h, w = images.shape
    p = patch_size
    gh, gw = h // p, w // p
    x = images.reshape(*lead, c, gh, p, gw, p)
    x = x.movedim((-5, -4, -3, -2, -1), (-3, -5, -2, -4, -1))
    return x.reshape(*lead, gh * gw, c * p * p)


def unpatchify(patches: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """Inverse of :func:`patchify`: (..., num_patches, C*p*p) ->
    (..., C, H, W)."""
    *lead, n, _ = patches.shape
    p, c, g = cfg.patch_size, cfg.in_channels, cfg.grid_size
    x = patches.reshape(*lead, g, g, c, p, p)
    x = x.movedim((-5, -4, -3, -2, -1), (-4, -2, -5, -3, -1))
    return x.reshape(*lead, c, g * p, g * p)


def masks_from_noise(
    noise: torch.Tensor, len_keep: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-image uniform noise (B, N) -> (keep, restore, mask): ``keep``
    (B, len_keep) int64 indices of the visible patches, ``restore`` (B, N)
    the inverse shuffle, ``mask`` (B, N) fp32 with 1 on MASKED patches (the
    loss weighting).  Stable sorts, as ``jnp.argsort``'s."""
    shuffle = torch.argsort(noise, dim=-1, stable=True)
    restore = torch.argsort(shuffle, dim=-1, stable=True)
    keep = shuffle[:, :len_keep]
    mask = (restore >= len_keep).float()
    return keep, restore, mask


def random_mask(
    gen: torch.Generator, batch: int, num_patches: int, len_keep: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-image random masking via uniform-noise argsort (He et al. §3.3),
    the noise drawn from ``gen`` on its own device: see
    :func:`masks_from_noise`."""
    noise = torch.rand((batch, num_patches), generator=gen, device=gen.device)
    return masks_from_noise(noise, len_keep)


def _run_blocks(
    x: torch.Tensor,
    blocks: Dict[str, torch.Tensor],
    cfg: ViTConfig,
    ops: OpsImpl,
    gelu_variant: str,
) -> torch.Tensor:
    """Every stacked block over x (B, T, D) — the two dispatch arms of
    ``vit.forward``: the op table's fused block on a flat (B*T, D)
    activation, with T read from the tensor, or the plain block loop."""
    per_layer = vit.layers(blocks)[: cfg.depth]
    if ops.encoder_block is not None:
        b, t, d = x.shape
        x2 = x.reshape(b * t, d)
        for blk in per_layer:
            x2 = ops.encoder_block(x2, blk, cfg.num_heads, t, cfg.layernorm_eps, gelu_variant)
        return x2.reshape(b, t, d)
    for blk in per_layer:
        x = vit.encoder_block(x, blk, cfg, ops, gelu_variant)
    return x


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, D), idx (B, K) -> x[b, idx[b, k], :] (B, K, D)."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def encode(
    params: Params,
    images: torch.Tensor,
    keep: torch.Tensor,
    cfg: ViTConfig,
    ops: OpsImpl = EAGER_OPS,
    gelu_variant: str = "exact",
) -> torch.Tensor:
    """Encoder over the visible patches only: (B, C, H, W) + keep (B, K) ->
    final-LN tokens (B, 1+K, D) — CLS first, then the K visible tokens in
    shuffled order."""
    compute_dtype = params["pos_embed"].dtype
    x = images.to(compute_dtype)
    x = ops.patch_embed(
        x, params["patch_embed"]["kernel"], params["patch_embed"]["bias"], cfg.patch_size
    )
    # position embedding BEFORE the gather (each token keeps its own
    # position); row 0 is the CLS position
    x = x + params["pos_embed"][1:]
    x = _gather_rows(x, keep)
    cls = (params["cls_token"] + params["pos_embed"][0]).to(compute_dtype)
    x = torch.cat([cls.expand(x.shape[0], 1, x.shape[-1]), x], dim=1)
    x = _run_blocks(x, params["blocks"], cfg, ops, gelu_variant)
    return ops.layer_norm(
        x, params["ln_final"]["scale"], params["ln_final"]["bias"], cfg.layernorm_eps
    )


def decode(
    params: Params,
    latent: torch.Tensor,
    restore: torch.Tensor,
    cfg: ViTConfig,
    mae_cfg: MAEConfig,
    gelu_variant: str = "exact",
    ops: OpsImpl = EAGER_OPS,
) -> torch.Tensor:
    """Decoder: latent (B, 1+K, D) + restore (B, N) -> per-patch pixel
    predictions (B, N, C*p*p) fp32.  Mask tokens fill the hidden positions;
    the full grid (plus CLS) runs through the decoder blocks, through the
    same op table as the encoder."""
    dec = params["decoder"]
    dcfg = mae_cfg.decoder_cfg(cfg)
    y = reference.linear(latent, dec["embed"]["kernel"], dec["embed"]["bias"])
    b, _, dd = y.shape
    n = restore.shape[-1]
    k = y.shape[1] - 1
    mask_tok = dec["mask_token"].to(y.dtype).expand(b, n - k, dd)
    # visible tokens (shuffled order) ++ mask tokens, then inverse-shuffle
    # back to grid order
    grid = torch.cat([y[:, 1:], mask_tok], dim=1)
    grid = _gather_rows(grid, restore)
    y = torch.cat([y[:, :1], grid], dim=1)
    y = y + dec["pos_embed"].to(y.dtype)
    y = _run_blocks(y, dec["blocks"], dcfg, ops, gelu_variant)
    y = reference.layer_norm(y, dec["ln"]["scale"], dec["ln"]["bias"], cfg.layernorm_eps)
    pred = reference.linear(y, dec["pred"]["kernel"], dec["pred"]["bias"])
    return pred[:, 1:].float()  # drop CLS


def forward_loss(
    params: Params,
    images: torch.Tensor,
    gen: Optional[torch.Generator],
    cfg: ViTConfig,
    mae_cfg: MAEConfig,
    ops: OpsImpl = EAGER_OPS,
    gelu_variant: str = "exact",
    return_pred: bool = False,
    noise: Optional[torch.Tensor] = None,
    decoder_ops: Optional[OpsImpl] = None,
):
    """One pretraining forward: masked-patch MSE (scalar fp32).  The masks
    come from ``gen`` (a generator on the images' device), or from
    ``noise`` (B, N) when given (a test seam: the JAX package's draw).
    ``decoder_ops``: the decoder's table, where it is not the encoder's
    (a tensor-parallel encoder's decoder stays whole).

    ``return_pred`` also returns (pred (B, N, C*p*p) fp32, mask (B, N) fp32
    — 1 on masked)."""
    check_config(cfg)
    b = images.shape[0]
    len_keep = mae_cfg.len_keep(cfg)
    if noise is None:
        keep, restore, mask = random_mask(gen, b, cfg.num_patches, len_keep)
    else:
        keep, restore, mask = masks_from_noise(noise, len_keep)
    latent = encode(params, images, keep, cfg, ops, gelu_variant)
    pred = decode(params, latent, restore, cfg, mae_cfg, gelu_variant,
                  ops if decoder_ops is None else decoder_ops)
    target = patchify(images.float(), cfg.patch_size)
    if mae_cfg.norm_pix_loss:
        mean = target.mean(dim=-1, keepdim=True)
        var = target.var(dim=-1, keepdim=True, unbiased=False)
        target = (target - mean) * torch.rsqrt(var + 1e-6)
    per_patch = (pred - target).square().mean(dim=-1)
    loss = (per_patch * mask).sum() / mask.sum().clamp(min=1.0)
    if return_pred:
        return loss, (pred, mask)
    return loss


def init_mae_params(
    gen: torch.Generator, cfg: ViTConfig, mae_cfg: MAEConfig, dtype=torch.float32
) -> Params:
    """Encoder (``vit.init_params`` minus the classifier head) + decoder,
    with the JAX package's shapes, scales and truncation, drawn from ``gen``
    on the CPU (the draws cannot match ``jax.random``'s)."""
    check_config(cfg)
    params = vit.init_params(gen, cfg, dtype)
    del params["head"]
    dcfg = mae_cfg.decoder_cfg(cfg)
    d, dd = cfg.embed_dim, mae_cfg.decoder_dim
    dec_full = vit.init_params(gen, dcfg, dtype)
    params["decoder"] = {
        "embed": {"kernel": vit._trunc(gen, (d, dd), d, dtype),
                  "bias": torch.zeros(dd, dtype=dtype)},
        "mask_token": (torch.randn(dd, generator=gen) * 0.02).to(dtype),
        "pos_embed": (torch.randn((cfg.num_patches + 1, dd), generator=gen) * 0.02).to(dtype),
        "blocks": dec_full["blocks"],
        "ln": dec_full["ln_final"],
        "pred": {"kernel": vit._trunc(gen, (dd, cfg.patch_dim), dd, dtype),
                 "bias": torch.zeros(cfg.patch_dim, dtype=dtype)},
    }
    return params


def is_mae_params(tree: Any) -> bool:
    return isinstance(tree, dict) and "decoder" in tree and "head" not in tree


def extract_backbone(
    mae_params: Params, gen: torch.Generator, cfg: ViTConfig, dtype=None
) -> Params:
    """Pretrained MAE tree -> the classifier tree with a fresh random head
    (drawn from ``gen``), the downstream fine-tuning entry.  The decoder is
    dropped: it exists only to make the pretraining task hard enough (He et
    al. §4)."""
    out = {k: v for k, v in mae_params.items() if k != "decoder"}
    out["head"] = vit.init_head(gen, cfg, dtype or mae_params["pos_embed"].dtype)
    return out

"""Model configuration — counterpart of ``vit_tpu.config``.

The same frozen dataclass and named variants (torchvision ``vit_*``, the
wide-head B/16, DeiT), kept in the port so that it and ``chip_smoke.py``
load nothing of the JAX package on their main paths.  Every named config
equals the JAX package's field for field (``tests/test_torch_config.py``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Hyperparameters for a ViT image classifier (torchvision ``vit_*`` family)."""

    image_size: int = 224
    patch_size: int = 16
    in_channels: int = 3
    num_classes: int = 1000
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    layernorm_eps: float = 1e-6
    dropout: float = 0.0
    drop_path: float = 0.0
    distilled: bool = False  # DeiT: a second prefix token with its own head
    native_checkpoints: bool = True  # False: no published checkpoint shares the QKV grouping
    name: str = "vit_b_16"

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def num_prefix_tokens(self) -> int:
        return 2 if self.distilled else 1

    @property
    def seq_len(self) -> int:
        return self.num_patches + self.num_prefix_tokens

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def mlp_dim(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.patch_size * self.patch_size

    def flops_per_image(self) -> int:
        """Forward-pass matmul FLOPs (2*MACs) for one image — roofline input."""
        t, d, h = self.seq_len, self.embed_dim, self.mlp_dim
        conv = 2 * self.num_patches * self.patch_dim * d
        qkv = 2 * t * d * 3 * d
        attn = 2 * 2 * t * t * d  # QK^T and S@V, summed over heads
        out_proj = 2 * t * d * d
        mlp = 2 * 2 * t * d * h
        head = 2 * d * self.num_classes
        return conv + self.depth * (qkv + attn + out_proj + mlp) + head

    def with_image_size(self, image_size: int) -> "ViTConfig":
        if image_size % self.patch_size != 0:
            raise ValueError(
                f"image_size {image_size} is not a multiple of "
                f"{self.name}'s patch_size {self.patch_size}"
            )
        return dataclasses.replace(self, image_size=image_size, name=f"{self.name}_{image_size}")


VIT_B_16 = ViTConfig(name="vit_b_16")
VIT_B_32 = ViTConfig(patch_size=32, name="vit_b_32")
VIT_L_16 = ViTConfig(embed_dim=1024, depth=24, num_heads=16, name="vit_l_16")
VIT_L_32 = ViTConfig(embed_dim=1024, depth=24, num_heads=16, patch_size=32, name="vit_l_32")
VIT_H_14 = ViTConfig(embed_dim=1280, depth=32, num_heads=16, patch_size=14, name="vit_h_14")
VIT_B_16_WIDE = ViTConfig(num_heads=6, native_checkpoints=False, name="vit_b_16_wide")
DEIT_T_16 = ViTConfig(embed_dim=192, depth=12, num_heads=3, distilled=True, name="deit_t_16")
DEIT_S_16 = ViTConfig(embed_dim=384, depth=12, num_heads=6, distilled=True, name="deit_s_16")
DEIT_B_16 = ViTConfig(distilled=True, name="deit_b_16")

CONFIGS = {
    c.name: c
    for c in (
        VIT_B_16, VIT_B_32, VIT_L_16, VIT_L_32, VIT_H_14, VIT_B_16_WIDE,
        VIT_B_16.with_image_size(384), VIT_L_16.with_image_size(384),
        DEIT_T_16, DEIT_S_16, DEIT_B_16, DEIT_B_16.with_image_size(384),
    )
}


def get_config(name: str) -> ViTConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; available: {sorted(CONFIGS)}")
    return CONFIGS[name]


def resolve_config(name: str, num_classes: int = 0) -> ViTConfig:
    """Named config, with the --num-classes head-width override applied
    (``vit_tpu.cli.common.resolve_config``)."""
    cfg = get_config(name)
    if num_classes:
        cfg = dataclasses.replace(cfg, num_classes=num_classes)
    return cfg

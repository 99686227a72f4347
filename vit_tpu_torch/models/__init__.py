"""Model definitions (functional forward on a params dict, plus ``ViT``)."""

from vit_tpu_torch.models.vit import ViT, forward

__all__ = ["ViT", "forward"]

"""Runtime: the batched inference engine."""

from vit_tpu_torch.runtime.engine import InferenceEngine

__all__ = ["InferenceEngine"]

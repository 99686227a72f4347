"""Batched inference engine — counterpart of ``vit_tpu.runtime.engine``.

Owns params residency on one device, the dtype policy and the forward.
Batches are padded to a multiple of ``batch_pad`` as in the JAX engine
(there it keeps the jit cache from fragmenting; here it keeps the kernel
shapes, and so their timings, stable across request sizes).

``device="cuda"`` needs a card and raises without one; it never runs on
the CPU instead.  Meshes (``mesh``) and token merging (``tome_r``) wait
for their slices of the port.
"""

from __future__ import annotations

import math
from typing import Any, Tuple

import numpy as np
import torch

from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.io.params import params_from_numpy
from vit_tpu_torch.models import vit
from vit_tpu_torch.ops import reference
from vit_tpu_torch.ops.dispatch import get_ops

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class InferenceEngine:
    """Args:
      cfg: model config.
      params: the JAX package's params pytree (numpy arrays, fp32 from the
        loader).
      dtype: compute dtype, 'bfloat16' (fast path) or 'float32'.  Logits
        and softmax are always fp32.
      ops: 'fused' (CUDA kernels; their plain twins on the CPU) or 'eager'.
      device: 'cuda', 'cuda:N' or 'cpu'.
      batch_pad: round batch sizes up to a multiple of this.
      gelu_variant: 'exact' (erf) or 'tanh'.
    """

    def __init__(
        self,
        cfg: ViTConfig,
        params: Any,
        dtype: str = "bfloat16",
        ops: str = "fused",
        device="cuda",
        batch_pad: int = 32,
        gelu_variant: str = "exact",
    ):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype {dtype!r} not in {tuple(_DTYPES)}")
        if batch_pad < 1:
            raise ValueError(f"batch_pad must be >= 1, got {batch_pad}")
        self.cfg = cfg
        self.batch_pad = batch_pad
        self.compute_dtype = _DTYPES[dtype]
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU"
            )
        self._ops = get_ops(ops)
        self._gelu_variant = gelu_variant
        self.params = self._prepare_params(params)

    def _prepare_params(self, params):
        """Loader-fresh pytree -> params on this engine's device, floating
        leaves in the compute dtype."""
        return params_from_numpy(params, self.device, self.compute_dtype)

    def swap_params(self, params) -> None:
        """Replace the weights with a checkpoint of the same config (same
        tree, shapes and dtypes); nothing is rebuilt."""
        new = self._prepare_params(params)
        new_leaves, old_leaves = _leaves(new), _leaves(self.params)
        if [k for k, _ in new_leaves] != [k for k, _ in old_leaves]:
            raise ValueError(
                "swap_params: new checkpoint's params tree differs from the "
                "loaded model (wrong config or source?)"
            )
        mismatch = [
            f"{k}: {tuple(a.shape)}/{a.dtype} vs {tuple(b.shape)}/{b.dtype}"
            for (k, a), (_, b) in zip(new_leaves, old_leaves)
            if a.shape != b.shape or a.dtype != b.dtype
        ]
        if mismatch:
            raise ValueError(
                "swap_params: new checkpoint's leaf shapes/dtypes differ from "
                f"the loaded model: {mismatch[:3]}"
            )
        self.params = new

    # -- core API ---------------------------------------------------------

    @torch.inference_mode()
    def logits(self, images) -> torch.Tensor:
        """(B, C, H, W) -> (B, num_classes) fp32 logits (unpadded)."""
        x, n = self._stage(images)
        out = vit.forward(
            self.params, x, self.cfg, self._ops, gelu_variant=self._gelu_variant
        )
        return out[:n]

    def probabilities(self, images) -> torch.Tensor:
        return reference.softmax(self.logits(images))

    @torch.inference_mode()
    def features(self, images) -> torch.Tensor:
        """(B, C, H, W) -> (B, D) final-LN CLS embeddings."""
        x, n = self._stage(images)
        out = vit.forward(
            self.params, x, self.cfg, self._ops,
            gelu_variant=self._gelu_variant, return_features=True,
        )
        return out[:n]

    def classify(self, images) -> Tuple[np.ndarray, np.ndarray]:
        """-> (labels, top_probs) as numpy arrays."""
        probs = self.probabilities(images).cpu().numpy()
        labels = probs.argmax(-1)
        return labels, probs[np.arange(len(labels)), labels]

    # -- internals --------------------------------------------------------

    def _stage(self, images) -> Tuple[torch.Tensor, int]:
        """Pad the batch up to a multiple of ``batch_pad`` and cast to the
        compute dtype on the engine's device.  Tensors already on the
        device are padded and cast there."""
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.ascontiguousarray(images))
        n = images.shape[0]
        grain = self.batch_pad
        padded = max(grain, math.ceil(n / grain) * grain)
        x = images.to(device=self.device, dtype=self.compute_dtype)
        if padded != n:
            pad = torch.zeros((padded - n, *x.shape[1:]), dtype=x.dtype, device=x.device)
            x = torch.cat([x, pad], dim=0)
        return x.contiguous(), n


def _leaves(tree, prefix=""):
    """[(path, tensor)] in a fixed order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _leaves(v, f"{prefix}{k}.")
        else:
            out.append((f"{prefix}{k}", v))
    return out

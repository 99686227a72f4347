"""Batched inference engine — counterpart of ``vit_tpu.runtime.engine``.

Owns params residency on one device, the dtype policy and the forward.
Batches are padded to a multiple of ``batch_pad`` as in the JAX engine
(there it keeps the jit cache from fragmenting; here it keeps the kernel
shapes, and so their timings, stable across request sizes).

``device="cuda"`` needs a card and raises without one; it never runs on
the CPU instead.  ``tome_r`` classifies through token merging
(``models/tome.py``) on ``fused``, ``quant`` or ``eager``.
``phase_report`` times the forward phase by phase through the op table's
per-op ``attention``/``mlp``; ``attention_maps`` is the interpretability
probe (per-layer attention probabilities, or their rollout).

``mesh`` (``parallel.make_mesh``) runs the forward SPMD over the ranks of
``torch.distributed``, one engine per rank, each given the whole batch: a
mesh with ``tp`` = 1 splits the batch over ``dp`` for any op table
(``parallel/shard_forward.py``); ``tp`` > 1 on ``fused`` or ``quant`` also
splits the heads and the MLP hidden axis over ``tp``
(``parallel/tp_forward.py``), each rank holding its shard of the prepared
weights.  Every rank returns the whole batch's logits.
"""

from __future__ import annotations

import math
from typing import Any, Tuple

import numpy as np
import torch

from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.io.params import device_or_raise, params_from_numpy
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
      ops: 'fused' (CUDA kernels; their plain twins on the CPU), 'quant'
        (the W8A8 kernels: the QKV and MLP weights are quantized to int8
        here, from the fp32 tree), 'per_op' (one kernel per layer op, the
        JAX package's 'pallas'), 'eager', or 'qat' (the fake-int8 plain
        ops a QAT run trains through).
      device: 'cuda', 'cuda:N' or 'cpu'.
      batch_pad: round batch sizes up to a multiple of this.
      gelu_variant: 'exact' (erf) or 'tanh'.
      tome_r: ToMe token merging — merge this many token pairs per layer
        on the default schedule (0: none, the plain forward).
      mesh: this rank's ``parallel.Mesh`` (None: one process, one device);
        the batch splits over 'dp', the weights over 'tp'.
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
        tome_r: int = 0,
        mesh=None,
    ):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype {dtype!r} not in {tuple(_DTYPES)}")
        if batch_pad < 1:
            raise ValueError(f"batch_pad must be >= 1, got {batch_pad}")
        self.cfg = cfg
        self.batch_pad = batch_pad
        self.compute_dtype = _DTYPES[dtype]
        self.device = device_or_raise(device)
        self._ops = get_ops(ops)
        self._gelu_variant = gelu_variant
        self.tome_r = int(tome_r)
        self.mesh = mesh
        self._tome_forward = None
        tp = mesh.size("tp") if mesh is not None else 1
        if self.tome_r:
            from vit_tpu_torch.models import tome

            tome.check_config(cfg, self.tome_r)  # r >= 0, the T ceiling
            forwards = {"fused": tome.forward_fused, "quant": tome.forward_quant,
                        "eager": tome.forward_eager}
            if self._ops.name not in forwards:
                raise ValueError("tome_r (token merging) supports ops='fused', 'quant' or 'eager'")
            if tp != 1:
                raise ValueError(
                    "tome_r shards data-parallel only (no tp): the merge "
                    "keeps whole tokens per device"
                )
            self._tome_forward = forwards[self._ops.name]
        self._tp_shard = False
        if tp > 1:
            # the kernel paths split heads and the MLP hidden axis over tp
            # with all-reduces (parallel/tp_forward.py) on 'fused' and
            # 'quant'; the JAX package's 'xla' tier gets tp from GSPMD,
            # which the port does not have
            if self._ops.name in ("fused", "quant"):
                if cfg.num_heads % tp or cfg.mlp_dim % tp:
                    raise ValueError(
                        f"tp={tp} must divide num_heads={cfg.num_heads} and "
                        f"mlp_dim={cfg.mlp_dim}"
                    )
                self._tp_shard = True
            elif self._ops.name == "eager":
                raise NotImplementedError(
                    "ops='eager' with tp > 1: the JAX package partitions its plain tier with "
                    "GSPMD, which the port does not have; tensor parallelism runs on "
                    "'fused' or 'quant' (ROADMAP.md item 14)"
                )
            else:
                raise ValueError(
                    f"ops={self._ops.name!r} shards data-parallel only "
                    "(the per-op pallas tier exists for kernel debugging, "
                    "not production); tensor-parallel meshes need "
                    "ops='xla' (GSPMD), 'fused', or 'quant' (shard_map "
                    "kernel TP)"
                )
        self.params = self._prepare_params(params)
        self._forward = self._sharded(return_features=False)
        # a lockstep server's forward: this rank's dp slice in, its logits
        # out (no join over dp; tp's all-reduces only)
        self._local_forward = self._sharded(return_features=False, split_dp=False)

    def _prepare_params(self, params):
        """Loader-fresh pytree -> params on this engine's device, floating
        leaves in the compute dtype.  On 'quant' the big GEMM weights are
        quantized from full precision first, then the remaining fp leaves
        are cast (int8 weights and their fp32 scales untouched)."""
        if self._ops.name == "quant":
            from vit_tpu_torch.ops import quant

            params = quant.quantize_params(params_from_numpy(params, self.device))
            params = quant.cast_quantized_params(params, self.compute_dtype)
        else:
            params = params_from_numpy(params, self.device, self.compute_dtype)
        if self._tp_shard:  # this rank's shard of the prepared tree
            from vit_tpu_torch.parallel.sharding import shard_params

            params = shard_params(params, self.mesh)
        return params

    def _sharded(self, return_features: bool, split_dp: bool = True):
        """-> forward(params, images) on this engine's op table and mesh
        (``split_dp=False``: on this rank's dp slice of the batch)."""
        cfg, gelu = self.cfg, self._gelu_variant
        if self._tp_shard:
            from vit_tpu_torch.parallel.tp_forward import shard_forward_tp

            return shard_forward_tp(cfg, self.mesh, self._ops.name, gelu,
                                    return_features=return_features, split_dp=split_dp)
        if self._tome_forward is not None:
            def fwd(p, x):
                return self._tome_forward(p, x, cfg, self.tome_r, gelu)
        else:
            def fwd(p, x):
                return vit.forward(p, x, cfg, self._ops, gelu_variant=gelu,
                                   return_features=return_features)
        if self.mesh is None or not split_dp:
            return fwd
        from vit_tpu_torch.parallel.shard_forward import shard_forward_dp

        return shard_forward_dp(fwd, self.mesh)

    def swap_params(self, params) -> None:
        """Replace the weights with a checkpoint of the same config (same
        tree, shapes and dtypes); nothing is rebuilt."""
        self.params = self._checked_params(params)

    def _checked_params(self, params):
        """``params`` prepared as ``swap_params`` would swap them in, or
        ValueError where their tree, shapes or dtypes differ from the
        loaded model's; the engine is left as it was."""
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
        return new

    # -- core API ---------------------------------------------------------

    @torch.inference_mode()
    def logits(self, images) -> torch.Tensor:
        """(B, C, H, W) -> (B, num_classes) fp32 logits (unpadded)."""
        x, n = self._stage(images)
        return self._forward(self.params, x)[:n]

    def probabilities(self, images) -> torch.Tensor:
        return reference.softmax(self.logits(images))

    @torch.inference_mode()
    def features(self, images) -> torch.Tensor:
        """(B, C, H, W) -> (B, D) final-LN CLS embeddings."""
        if self.tome_r:
            # the feature probe runs the full-token forward: on a merged
            # engine it would come from another model than classify()'s
            raise ValueError(
                "features() on a tome_r engine would use full tokens while "
                "classify() merges — build a tome_r=0 engine for embeddings"
            )
        x, n = self._stage(images)
        return self._sharded(return_features=True)(self.params, x)[:n]

    def classify(self, images) -> Tuple[np.ndarray, np.ndarray]:
        """-> (labels, top_probs) as numpy arrays."""
        probs = self.probabilities(images).cpu().numpy()
        labels = probs.argmax(-1)
        return labels, probs[np.arange(len(labels)), labels]

    @torch.inference_mode()
    def attention_maps(self, images, rollout: bool = False) -> torch.Tensor:
        """Interpretability probe: per-layer attention probabilities
        (depth, B, H, T, T) — or, with ``rollout``, the Abnar & Zuidema
        CLS->patch relevance (B, grid, grid).  Runs the plain reference ops
        (``models/vit.attention_maps``), not the kernels; on a dp mesh each
        rank probes its slice of the batch (the probabilities' axis 1)."""
        if self.tome_r:
            raise ValueError(
                "attention_maps() on a tome_r engine would probe the "
                "full-token model while classify() merges — build a "
                "tome_r=0 engine for interpretability"
            )
        if self._ops.name == "quant":
            raise ValueError(
                "attention_maps needs fp weights; build the engine with "
                "ops='eager'/'per_op'/'fused'"
            )
        if self._tp_shard:
            raise NotImplementedError(
                "attention_maps runs the whole weights; on a tp > 1 engine each rank holds a "
                "shard (the JAX package's GSPMD probe is not ported, ROADMAP.md item 14)"
            )
        cfg, gelu = self.cfg, self._gelu_variant

        def probe(p, x):
            return vit.attention_maps(p, x, cfg, gelu)

        if self.mesh is not None:
            from vit_tpu_torch.parallel.shard_forward import shard_forward_dp

            probe = shard_forward_dp(probe, self.mesh, batch_axis=1)
        # grain 1: the probabilities are O(B·T²) (605 MB an image at @512);
        # padding one image to a serving batch_pad would multiply that ~32x
        x, n = self._stage(images, grain=1)
        probs = probe(self.params, x)[:, :n]
        if rollout:
            g = cfg.grid_size
            return vit.attention_rollout(probs, cfg.num_prefix_tokens).reshape(n, g, g)
        return probs

    @torch.inference_mode()
    def phase_report(self, images, iters: int = 3) -> str:
        """Per-phase timing breakdown (patch embed, each encoder phase,
        head) over ``iters`` forwards, as the JAX engine's: the unfused op
        path — the reference LayerNorm, the table's per-op ``attention`` and
        ``mlp`` (K21 and K22 on ``per_op`` and ``fused``) — so the phases are
        separable, each ending in a device synchronize."""
        from vit_tpu_torch.runtime.profiler import PhaseTimer

        R = reference
        if self._ops.name == "quant":
            raise NotImplementedError(
                "phase_report needs separable fp ops; use ops='eager'/'per_op'/'fused'"
            )
        if self._tp_shard:
            raise NotImplementedError(
                "phase_report runs the whole weights; on a tp > 1 engine each rank holds a "
                "shard (the JAX package's GSPMD probe is not ported, ROADMAP.md item 14)"
            )
        timer = PhaseTimer()
        cfg = self.cfg
        x, _ = self._stage(images)
        p = self.params
        eps = cfg.layernorm_eps

        def sync(v):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return v

        for _ in range(iters):
            with timer.phase("patch_embed+pos"):
                h = sync(R.add_cls_and_pos(
                    self._ops.patch_embed(x, p["patch_embed"]["kernel"],
                                          p["patch_embed"]["bias"], cfg.patch_size),
                    vit.prefix_tokens(p), p["pos_embed"],
                ))
            for blk in vit.layers(p["blocks"])[: cfg.depth]:
                with timer.phase("layer_norm_1"):
                    ln1 = sync(R.layer_norm(h, blk["ln1_scale"], blk["ln1_bias"], eps))
                with timer.phase("attention"):
                    a = sync(self._ops.attention(ln1, blk["wqkv"], blk["bqkv"], blk["wo"],
                                                 blk["bo"], cfg.num_heads))
                h = h + a
                with timer.phase("layer_norm_2"):
                    ln2 = sync(R.layer_norm(h, blk["ln2_scale"], blk["ln2_bias"], eps))
                with timer.phase("mlp"):
                    m = sync(self._ops.mlp(ln2, blk["w1"], blk["b1"], blk["w2"], blk["b2"],
                                           gelu_variant=self._gelu_variant))
                h = h + m
            with timer.phase("final_ln+head"):
                hn = R.layer_norm(h, p["ln_final"]["scale"], p["ln_final"]["bias"], eps)
                sync(vit.apply_head(hn, p))
        return timer.report()

    # -- internals --------------------------------------------------------

    def _stage(self, images, grain=None) -> Tuple[torch.Tensor, int]:
        """Pad the batch up to a multiple of ``grain`` (default ``batch_pad``;
        and of the mesh's ``dp``) and cast to the compute dtype on the
        engine's device.  Tensors already on the device are padded and cast
        there.  One-off probes pass ``grain=1``."""
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.ascontiguousarray(images))
        n = images.shape[0]
        grain = self.batch_pad if grain is None else grain
        if self.mesh is not None:
            grain = math.lcm(grain, self.mesh.size("dp"))
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

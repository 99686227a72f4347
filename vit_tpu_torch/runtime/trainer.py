"""Training step: cross-entropy over a params dict, on one device.

Counterpart of ``vit_tpu.runtime.trainer`` (its single-device pieces; the
mesh, distillation, MAE and EMA paths wait for their slices of the port).
Params are a dict of leaf tensors with ``requires_grad``; a
``torch.optim`` optimizer over those leaves takes the place of an optax
transformation and its state, and updates them in place — the
counterpart of ``jax.jit(..., donate_argnums=(0, 1))``.  The step runs
eagerly: no ``torch.compile``.
"""

from __future__ import annotations

from typing import Callable, Iterator, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.models import vit
from vit_tpu_torch.ops.dispatch import EAGER_OPS, OpsImpl


def leaves(params) -> Iterator[torch.Tensor]:
    """The tensors of a nested params dict, in its insertion order."""
    for v in params.values():
        if isinstance(v, dict):
            yield from leaves(v)
        else:
            yield v


def cross_entropy_loss(
    logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.0
) -> torch.Tensor:
    """CE over int labels (B,) or soft target rows (B, K), in fp32.
    ``label_smoothing`` applies to int labels only (eps/K mass on every
    class, ``vit_tpu.runtime.augment.soft_targets``); soft rows are taken
    as already smoothed."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    if labels.dim() == logits.dim():  # soft targets
        return -(labels.float() * logp).sum(dim=-1).mean()
    labels = labels.long()
    if label_smoothing:
        eps = float(label_smoothing)
        y = F.one_hot(labels, logits.shape[-1]).float() * (1.0 - eps) + eps / logits.shape[-1]
        return -(y * logp).sum(dim=-1).mean()
    return -logp.gather(-1, labels[:, None])[:, 0].mean()


def _make_loss_fn(cfg: ViTConfig, ops: OpsImpl, remat: bool, compute_dtype=None,
                  label_smoothing: float = 0.0):
    """(params, images, labels) -> scalar loss.  With ``compute_dtype``
    (mixed precision) the params and images are cast inside the loss, so
    the gradients land in the fp32 master weights through the cast.
    ``remat`` recomputes the forward in the backward
    (``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``)."""

    def fwd(p, x):
        if compute_dtype is not None:
            p = vit.cast_params(p, compute_dtype)
            x = x.to(compute_dtype)
        return vit.forward(p, x, cfg, ops)

    def loss_fn(params, images, labels):
        if remat:
            logits = torch.utils.checkpoint.checkpoint(fwd, params, images, use_reentrant=False)
        else:
            logits = fwd(params, images)
        return cross_entropy_loss(logits, labels, label_smoothing)

    return loss_fn


def _value_and_grad_accum(loss_fn, params, images, labels, k: int) -> torch.Tensor:
    """The mean loss (detached), with the gradients of the mean in each
    leaf's ``.grad``.  ``k`` > 1 splits the batch into k equal microbatches
    whose gradients sum before one division by k — k x less activation
    memory, and the mean of the microbatch means is the full-batch mean."""
    if k <= 1:
        loss = loss_fn(params, images, labels)
        loss.backward()
        return loss.detach()
    b = images.shape[0]
    if b % k:
        raise ValueError(f"batch {b} must be divisible by grad_accum {k}")
    total = torch.zeros((), dtype=torch.float32, device=images.device)
    for x, y in zip(images.chunk(k), labels.chunk(k)):
        loss = loss_fn(params, x, y)
        loss.backward()
        total = total + loss.detach()
    with torch.no_grad():
        for t in leaves(params):
            if t.grad is not None:
                t.grad.div_(k)
    return total / k


def make_train_step(
    cfg: ViTConfig,
    optimizer: torch.optim.Optimizer,
    ops: OpsImpl = EAGER_OPS,
    remat: bool = True,
    compute_dtype=None,
    label_smoothing: float = 0.0,
    grad_accum: int = 1,
    grad_clip: float = 0.0,
):
    """Build ``(params, images, labels) -> loss``, one optimizer update per
    call on ``optimizer``'s leaves (which must be ``params``' leaves).

    ``compute_dtype`` (``torch.bfloat16``) is mixed precision: fp32 master
    weights and optimizer state, casts inside the loss.  ``grad_clip`` > 0
    clips the gradients' global L2 norm before the update
    (``clip_grad_norm_``, the counterpart of ``optax.clip_by_global_norm``).
    ``grad_accum`` as in :func:`_value_and_grad_accum`."""
    loss_fn = _make_loss_fn(cfg, ops, remat, compute_dtype, label_smoothing)

    def train_step(params, images, labels) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = _value_and_grad_accum(loss_fn, params, images, labels, grad_accum)
        if grad_clip:
            torch.nn.utils.clip_grad_norm_(list(leaves(params)), grad_clip)
        optimizer.step()
        return loss

    return train_step


def init_train_state(
    gen: torch.Generator,
    cfg: ViTConfig,
    make_optimizer: Callable,
    dtype=torch.float32,
    device="cpu",
) -> Tuple[dict, torch.optim.Optimizer]:
    """Random params (``vit.init_params``) as trainable leaves on
    ``device``, and ``make_optimizer(params)`` over them."""
    params = as_trainable(vit.init_params(gen, cfg, dtype), device)
    return params, make_optimizer(params)


def as_trainable(tree, device="cpu", dtype=None):
    """A nested dict of tensors as fresh leaf tensors on ``device`` that
    require grad (floating leaves cast to ``dtype`` when given)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = as_trainable(v, device, dtype)
        else:
            t = v.detach().to(device=device, dtype=dtype or v.dtype).clone()
            out[k] = t.requires_grad_(True)
    return out

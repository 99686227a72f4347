"""Training step: cross-entropy over a params dict, on one device.

Counterpart of ``vit_tpu.runtime.trainer`` (its single-device pieces; the
mesh, distillation, MAE and EMA paths wait for their slices of the port).
Params are a dict of leaf tensors with ``requires_grad``; a
``torch.optim`` optimizer over those leaves takes the place of an optax
transformation and its state, and updates them in place — the
counterpart of ``jax.jit(..., donate_argnums=(0, 1))``.  :class:`FusedAdamW`
is the fused AdamW step (K20, one kernel launch per leaf dtype), the
counterpart of ``make_train_step_fused_adamw``'s update.  The step runs
eagerly: no ``torch.compile``.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.io.params import device_or_raise
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
                  label_smoothing: float = 0.0, forward_fn=None):
    """(params, images, labels[, rng]) -> scalar loss.  With
    ``compute_dtype`` (mixed precision) the params and images are cast
    inside the loss, so the gradients land in the fp32 master weights
    through the cast.  ``remat`` recomputes the forward in the backward
    (``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``).
    ``rng``, a host generator, turns on dropout and drop-path: each call
    draws one seed from it, and the forward draws its masks from a
    generator made from that seed, so a recomputed forward draws the same
    masks.  ``forward_fn`` ``(params, images, dropout_rng) -> logits``
    overrides the model forward (the merged-token forward of token-merging
    training, ``models/tome.py``)."""

    def fwd(p, x, seed):
        if compute_dtype is not None:
            p = vit.cast_params(p, compute_dtype)
            x = x.to(compute_dtype)
        rng = None if seed is None else torch.Generator().manual_seed(seed)
        if forward_fn is not None:
            return forward_fn(p, x, rng)
        return vit.forward(p, x, cfg, ops, dropout_rng=rng)

    def loss_fn(params, images, labels, rng=None):
        seed = None if rng is None else int(torch.randint(0, 2 ** 62, (), generator=rng))
        if remat:
            logits = torch.utils.checkpoint.checkpoint(fwd, params, images, seed,
                                                       use_reentrant=False)
        else:
            logits = fwd(params, images, seed)
        return cross_entropy_loss(logits, labels, label_smoothing)

    return loss_fn


def _value_and_grad_accum(loss_fn, params, images, labels, k: int, rng=None) -> torch.Tensor:
    """The mean loss (detached), with the gradients of the mean in each
    leaf's ``.grad``.  ``k`` > 1 splits the batch into k equal microbatches
    whose gradients sum before one division by k — k x less activation
    memory, and the mean of the microbatch means is the full-batch mean.
    ``rng`` (dropout) is handed to every microbatch's loss, which advances
    it."""
    if k <= 1:
        loss = loss_fn(params, images, labels, rng)
        loss.backward()
        return loss.detach()
    b = images.shape[0]
    if b % k:
        raise ValueError(f"batch {b} must be divisible by grad_accum {k}")
    total = torch.zeros((), dtype=torch.float32, device=images.device)
    for x, y in zip(images.chunk(k), labels.chunk(k)):
        loss = loss_fn(params, x, y, rng)
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
    use_dropout: bool = False,
    rng: Optional[torch.Generator] = None,
    forward_fn: Optional[Callable] = None,
):
    """Build ``(params, images, labels) -> loss``, one optimizer update per
    call on ``optimizer``'s leaves (which must be ``params``' leaves).

    ``compute_dtype`` (``torch.bfloat16``) is mixed precision: fp32 master
    weights and optimizer state, casts inside the loss.  ``grad_clip`` > 0
    clips the gradients' global L2 norm before the update
    (``clip_grad_norm_``, the counterpart of ``optax.clip_by_global_norm``).
    ``grad_accum`` as in :func:`_value_and_grad_accum`.  ``use_dropout``
    applies cfg.dropout and cfg.drop_path in the forward, with a fresh
    generator per step drawn from ``rng`` (a host ``torch.Generator``, the
    counterpart of the JAX step's rng argument).  ``forward_fn`` as in
    :func:`_make_loss_fn`."""
    if use_dropout and rng is None:
        raise ValueError("use_dropout needs rng, a torch.Generator (e.g. seeded from --seed)")
    loss_fn = _make_loss_fn(cfg, ops, remat, compute_dtype, label_smoothing, forward_fn)

    def train_step(params, images, labels) -> torch.Tensor:
        step_rng = None
        if use_dropout:  # a fresh generator per step
            step_rng = torch.Generator().manual_seed(int(torch.randint(0, 2 ** 62, (), generator=rng)))
        optimizer.zero_grad(set_to_none=True)
        loss = _value_and_grad_accum(loss_fn, params, images, labels, grad_accum, step_rng)
        if grad_clip:
            torch.nn.utils.clip_grad_norm_(list(leaves(params)), grad_clip)
        optimizer.step()
        return loss

    return train_step


class FusedAdamW(torch.optim.Optimizer):
    """AdamW through the fused in-place kernel (K20,
    ``ops/kernels/adamw.adamw_update``), with the JAX package's fused state:
    one step count for every leaf (``count``) and fp32 moments ``mu``/``nu``
    per leaf.  ``lr`` is a number or a schedule ``count -> lr`` evaluated at
    count + 1, the 1-based step, as ``make_train_step_fused_adamw`` does in
    the JAX package (optax's adamw evaluates it at count).  Weight decay
    applies to every leaf of a group (no mask).  A leaf without a gradient
    is skipped, as torch's optimizers skip it."""

    def __init__(self, params, lr=1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, count: int = 0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay))
        self.count = int(count)

    def _moments(self, p: torch.Tensor):
        """(mu, nu) of leaf ``p``, fp32 zeros at first use."""
        st = self.state[p]
        if not st:
            st["mu"] = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            st["nu"] = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return st["mu"], st["nu"]

    @torch.no_grad()
    def step(self, closure=None):
        from vit_tpu_torch.ops.kernels.adamw import adamw_update

        loss = None if closure is None else closure()
        t = self.count + 1
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            mu, nu = zip(*map(self._moments, ps)) if ps else ((), ())
            lr = group["lr"](t) if callable(group["lr"]) else group["lr"]
            adamw_update([p.grad for p in ps], ps, list(mu), list(nu), t, lr, group["b1"],
                         group["b2"], group["eps"], group["weight_decay"])
        self.count = t
        return loss


def init_fused_adamw_state(params):
    """(count, mu, nu) state for :func:`make_train_step_fused_adamw`: count
    0 and fp32 zero moments shaped like ``params`` (a nested dict)."""
    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict)
                else torch.zeros(v.shape, dtype=torch.float32, device=v.device)
                for k, v in tree.items()}

    return 0, zeros(params), zeros(params)


def make_train_step_fused_adamw(
    cfg: ViTConfig,
    lr,
    ops: OpsImpl = EAGER_OPS,
    remat: bool = False,
    compute_dtype=None,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
):
    """Train step with the fused in-place AdamW (:class:`FusedAdamW`, K20)
    in place of an optimizer object, as the JAX function's: ``(params,
    opt_state, images, labels) -> (params, opt_state, loss)`` with
    ``opt_state = (count, mu, nu)`` from :func:`init_fused_adamw_state`,
    built on :func:`make_train_step`.  params, mu and nu are updated in
    place.  ``lr`` is a number or a schedule evaluated at count + 1."""

    def train_step(params, opt_state, images, labels):
        count, mu, nu = opt_state
        opt = FusedAdamW(list(leaves(params)), lr, b1, b2, eps, weight_decay, count)
        for p, m, v in zip(leaves(params), leaves(mu), leaves(nu)):
            opt.state[p].update(mu=m, nu=v)
        step = make_train_step(cfg, opt, ops, remat, compute_dtype)
        loss = step(params, images, labels)
        return params, (opt.count, mu, nu), loss

    return train_step


def init_train_state(
    gen: torch.Generator,
    cfg: ViTConfig,
    make_optimizer: Callable,
    dtype=torch.float32,
    device="cuda",
) -> Tuple[dict, torch.optim.Optimizer]:
    """Random params (``vit.init_params``) as trainable leaves on
    ``device`` (the card unless the caller asks for the CPU), and
    ``make_optimizer(params)`` over them."""
    params = as_trainable(vit.init_params(gen, cfg, dtype), device)
    return params, make_optimizer(params)


def as_trainable(tree, device="cuda", dtype=None):
    """A nested dict of tensors as fresh leaf tensors on ``device`` that
    require grad (floating leaves cast to ``dtype`` when given).  A CUDA
    device without a card raises."""
    device = device_or_raise(device)
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = as_trainable(v, device, dtype)
        else:
            t = v.detach().to(device=device, dtype=dtype or v.dtype).clone()
            out[k] = t.requires_grad_(True)
    return out

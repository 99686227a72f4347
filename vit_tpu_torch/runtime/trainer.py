"""Training steps over a params dict, on one device: cross-entropy, DeiT
distillation against a frozen teacher, and MAE pretraining.

Counterpart of ``vit_tpu.runtime.trainer`` (its single-device pieces; the
mesh and EMA paths wait for their slices of the port).
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


def distillation_loss(
    cls_logits: torch.Tensor,
    dist_logits: torch.Tensor,
    labels: torch.Tensor,
    teacher_logits: torch.Tensor,
    alpha: float = 0.5,
    hard: bool = True,
    tau: float = 1.0,
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    """DeiT distillation objective (Touvron et al. 2021): the CLS head
    trains on the true labels, the distillation head on the teacher.

    ``hard`` (the paper's best variant) takes the teacher's argmax as a hard
    label: L = (1-alpha)*CE(cls, y) + alpha*CE(dist, argmax(teacher)), the
    first maximum on a tie (``torch.argmax``'s rule, and ``jnp.argmax``'s).
    ``hard=False`` is soft KD:
    alpha * tau^2 * KL(teacher_tau || dist_tau), in fp32.  The teacher
    logits carry no graph (the teacher is frozen)."""
    ce = cross_entropy_loss(cls_logits, labels, label_smoothing)
    if hard:
        kd = cross_entropy_loss(dist_logits, teacher_logits.argmax(dim=-1))
    else:
        t = torch.log_softmax(teacher_logits.float() / tau, dim=-1)
        s = torch.log_softmax(dist_logits.float() / tau, dim=-1)
        kd = (tau * tau) * (t.exp() * (t - s)).sum(dim=-1).mean()
    return (1.0 - alpha) * ce + alpha * kd


def make_distill_train_step(
    cfg: ViTConfig,
    optimizer: torch.optim.Optimizer,
    teacher_fwd: Callable,
    ops: OpsImpl = EAGER_OPS,
    remat: bool = True,
    compute_dtype=None,
    alpha: float = 0.5,
    hard: bool = True,
    tau: float = 1.0,
    label_smoothing: float = 0.0,
    grad_clip: float = 0.0,
):
    """Build ``(params, images, labels) -> loss`` training a DeiT-distilled
    student against a frozen teacher, one optimizer update per call
    (``grad_clip`` as in :func:`make_train_step`).

    ``teacher_fwd``: ``images -> logits`` over the frozen teacher (any
    config and op table, typically ``vit.forward`` over a loaded tree on
    ``fused`` or ``quant``); it runs under ``torch.no_grad``, so it records
    no graph.  The student runs ``vit.forward(..., separate_heads=True)``
    on ``ops``; it must be a distilled config (dual heads)."""
    if not cfg.distilled:
        raise ValueError(
            f"distillation training needs a distilled student config "
            f"(got {cfg.name}; use deit_*)"
        )

    def fwd(p, x):
        if compute_dtype is not None:
            p = vit.cast_params(p, compute_dtype)
            x = x.to(compute_dtype)
        return vit.forward(p, x, cfg, ops, separate_heads=True)

    def loss_fn(params, images, labels):
        with torch.no_grad():
            t_logits = teacher_fwd(images)
        if remat:
            cls_logits, dist_logits = torch.utils.checkpoint.checkpoint(
                fwd, params, images, use_reentrant=False)
        else:
            cls_logits, dist_logits = fwd(params, images)
        return distillation_loss(cls_logits, dist_logits, labels, t_logits, alpha=alpha,
                                 hard=hard, tau=tau, label_smoothing=label_smoothing)

    def train_step(params, images, labels) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, images, labels)
        loss.backward()
        _update(params, optimizer, grad_clip)
        return loss.detach()

    return train_step


def make_mae_train_step(
    cfg: ViTConfig,
    mae_cfg,
    optimizer: torch.optim.Optimizer,
    gen: torch.Generator,
    ops: OpsImpl = EAGER_OPS,
    compute_dtype=None,
    grad_clip: float = 0.0,
):
    """Build the MAE pretraining step ``(params, images, labels) -> loss``
    (``models/mae.py``), the loop's calling shape; the labels are ignored,
    the targets being the images' own masked pixels.  Each step draws its
    masks from ``gen``, a generator on the images' device.  ``grad_clip``
    as in :func:`make_train_step`.

    No remat: at the default 75% mask the encoder runs on a quarter of the
    tokens, and the ``fused_train`` backward kernels recompute from their
    stashed inputs already.  With ``compute_dtype`` the params are cast
    inside the loss (the encoder casts the images)."""
    from vit_tpu_torch.models import mae

    def train_step(params, images, labels=None) -> torch.Tensor:
        del labels
        optimizer.zero_grad(set_to_none=True)
        p = params if compute_dtype is None else vit.cast_params(params, compute_dtype)
        loss = mae.forward_loss(p, images, gen, cfg, mae_cfg, ops)
        loss.backward()
        _update(params, optimizer, grad_clip)
        return loss.detach()

    return train_step


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
        _update(params, optimizer, grad_clip)
        return loss

    return train_step


def _update(params, optimizer: torch.optim.Optimizer, grad_clip: float) -> None:
    """One optimizer update from the leaves' gradients, clipped first to
    the global L2 norm ``grad_clip`` when it is > 0."""
    if grad_clip:
        torch.nn.utils.clip_grad_norm_(list(leaves(params)), grad_clip)
    optimizer.step()


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

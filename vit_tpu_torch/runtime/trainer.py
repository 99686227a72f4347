"""Training steps over a params dict: cross-entropy, DeiT distillation
against a frozen teacher, and MAE pretraining, on one device or over a
rank mesh (``parallel/mesh.py``).

Counterpart of ``vit_tpu.runtime.trainer``.  On a mesh every rank runs
the step SPMD on its own slice of the batch: the loss and the gradients
are averaged over ``dp`` in one all-reduce (``pmean``), and with ``tp``
the forward is the tensor-parallel kernel path (``parallel/tp_forward.py``),
each rank's optimizer updating its own shards
(:func:`make_train_step_kernel_tp`).
Params are a dict of leaf tensors with ``requires_grad``; a
``torch.optim`` optimizer over those leaves takes the place of an optax
transformation and its state, and updates them in place — the
counterpart of ``jax.jit(..., donate_argnums=(0, 1))``.  :class:`FusedAdamW`
is the fused AdamW step (K20, one kernel launch per leaf dtype), the
counterpart of ``make_train_step_fused_adamw``'s update.  The step runs
eagerly: no ``torch.compile``.

Each step draws its randomness (augmentation, dropout, MAE's masks) from
seeds that are a function of (seed, step number, dp index) alone
(:func:`fold_in`), as the JAX loop folds the step into its key: a run
resumed at step k draws what the uninterrupted run drew.  The optimizer
state lays out as optax's leaves for a train-state archive
(:func:`opt_state_layout`).
"""

from __future__ import annotations

import itertools
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.io.params import device_or_raise
from vit_tpu_torch.models import vit
from vit_tpu_torch.ops.dispatch import EAGER_OPS, OpsImpl
from vit_tpu_torch.parallel.mesh import Mesh


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


def _make_distill_loss_fn(cfg: ViTConfig, ops: OpsImpl, remat: bool, compute_dtype,
                          teacher_fwd: Callable, alpha: float, hard: bool, tau: float,
                          label_smoothing: float = 0.0):
    """(params, images, labels[, rng]) -> the distillation loss: the frozen
    teacher under ``torch.no_grad`` (no graph), the student's
    separate-head forward on ``ops`` (``_make_distill_loss_fn`` in the JAX
    package).  ``rng`` is ignored: distillation composes with no dropout."""

    def fwd(p, x):
        if compute_dtype is not None:
            p = vit.cast_params(p, compute_dtype)
            x = x.to(compute_dtype)
        return vit.forward(p, x, cfg, ops, separate_heads=True)

    def loss_fn(params, images, labels, rng=None):
        with torch.no_grad():
            t_logits = teacher_fwd(images)
        if remat:
            cls_logits, dist_logits = torch.utils.checkpoint.checkpoint(
                fwd, params, images, use_reentrant=False)
        else:
            cls_logits, dist_logits = fwd(params, images)
        return distillation_loss(cls_logits, dist_logits, labels, t_logits, alpha=alpha,
                                 hard=hard, tau=tau, label_smoothing=label_smoothing)

    return loss_fn


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
    mesh: Optional[Mesh] = None,
    guard: Optional["NonFiniteGuard"] = None,
    trained: Optional[dict] = None,
):
    """Build ``(params, images, labels) -> loss`` training a DeiT-distilled
    student against a frozen teacher, one optimizer update per call
    (``grad_clip``, ``guard`` and ``trained`` as in :func:`make_train_step`).

    ``teacher_fwd``: ``images -> logits`` over the frozen teacher (any
    config and op table, typically ``vit.forward`` over a loaded tree on
    ``fused`` or ``quant``); it runs under ``torch.no_grad``, so it records
    no graph.  The student runs ``vit.forward(..., separate_heads=True)``
    on ``ops``; it must be a distilled config (dual heads).  ``mesh``: the
    data-parallel step (:func:`make_train_step_dp`), the teacher on each
    rank's own images."""
    return make_train_step_dp(
        cfg, optimizer, mesh, ops, remat=remat, compute_dtype=compute_dtype,
        label_smoothing=label_smoothing, grad_clip=grad_clip,
        distill=dict(teacher_fwd=teacher_fwd, alpha=alpha, hard=hard, tau=tau), guard=guard,
        trained=trained,
    )


def make_mae_train_step(
    cfg: ViTConfig,
    mae_cfg,
    optimizer: torch.optim.Optimizer,
    gen: torch.Generator,
    ops: OpsImpl = EAGER_OPS,
    compute_dtype=None,
    grad_clip: float = 0.0,
    mesh: Optional[Mesh] = None,
    guard: Optional["NonFiniteGuard"] = None,
    trained: Optional[dict] = None,
):
    """Build the MAE pretraining step ``(params, images, labels) -> loss``
    (``models/mae.py``), the loop's calling shape; the labels are ignored,
    the targets being the images' own masked pixels.  Step ``step`` draws
    its masks from a generator on ``gen``'s device seeded with
    ``fold_in(gen.initial_seed(), step)`` (the calls counted from 0 when
    no step is given).  ``grad_clip``, ``guard`` and ``trained`` as in
    :func:`make_train_step`.  ``mesh``: data parallel, each rank on its own
    images with that seed folded with its ``dp`` index
    (``jit_mae_step_dp_shard_map``), the loss and gradients averaged over
    ``dp``.

    No remat: at the default 75% mask the encoder runs on a quarter of the
    tokens, and the ``fused_train`` backward kernels recompute from their
    stashed inputs already.  With ``compute_dtype`` the params are cast
    inside the loss (the encoder casts the images)."""
    from vit_tpu_torch.models import mae

    calls = itertools.count()

    def train_step(params, images, labels=None, step: Optional[int] = None) -> torch.Tensor:
        del labels
        seed = _step_seed(gen.initial_seed(), next(calls) if step is None else step, mesh)
        _clear_grads(params)
        p = params if compute_dtype is None else vit.cast_params(params, compute_dtype)
        loss = mae.forward_loss(p, images, torch.Generator(device=gen.device).manual_seed(seed),
                                cfg, mae_cfg, ops)
        loss.backward()
        return _finish(params, loss.detach(), optimizer, grad_clip, mesh, guard, trained)

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


_M64 = 2 ** 64 - 1


def _mix64(z: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit ints that scatters
    nearby inputs."""
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def fold_in(seed: int, i: int) -> int:
    """A seed for index ``i`` (a step number, a mesh axis index) from
    ``seed``, in [0, 2^62): the counterpart of ``jax.random.fold_in``,
    deterministic in (seed, i) and O(1) in i."""
    return _mix64((_mix64(seed & _M64) + (i + 1) * 0x9E3779B97F4A7C15) & _M64) >> 2


def _step_seed(seed: int, step: int, mesh: Optional[Mesh]) -> int:
    """Step ``step``'s seed from the run's ``seed``, folded with the rank's
    ``dp`` index on a mesh of more than one dp rank."""
    seed = fold_in(seed, step)
    if mesh is not None and mesh.size("dp") > 1:
        seed = fold_in(seed, mesh.index("dp"))
    return seed


def _clear_grads(params) -> None:
    """Every leaf's gradient to None, those the optimizer does not update
    too (a frozen leaf's would pile up over the steps otherwise)."""
    for t in leaves(params):
        t.grad = None


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
    augment_fn: Optional[Callable] = None,
    guard: Optional["NonFiniteGuard"] = None,
    trained: Optional[dict] = None,
):
    """Build ``(params, images, labels, step=None) -> loss``, one optimizer
    update per call on ``optimizer``'s leaves: ``params``' leaves, or the
    part of them that ``trained`` is (the same leaves in ``params``' shape:
    the others get no update, and ``grad_clip``'s norm covers ``trained``
    alone, as ``multi_transform(chain(clip, adamw))`` clips).

    ``compute_dtype`` (``torch.bfloat16``) is mixed precision: fp32 master
    weights and optimizer state, casts inside the loss.  ``grad_clip`` > 0
    clips the gradients' global L2 norm before the update
    (``clip_grad_norm_``, the counterpart of ``optax.clip_by_global_norm``).
    ``grad_accum`` as in :func:`_value_and_grad_accum`.  ``use_dropout``
    applies cfg.dropout and cfg.drop_path in the forward; ``augment_fn``
    (``runtime/augment.make_augment_fn``) augments the batch before any
    microbatch split and hands the loss soft targets (so the loss smooths
    nothing itself).  Both draw from ``rng`` (a host ``torch.Generator``,
    the counterpart of the JAX step's rng argument): step ``step`` from
    ``fold_in(rng.initial_seed(), step)`` (the calls counted from 0 when no
    step is given), split in two by :func:`fold_in` when both are on.
    ``guard`` (:class:`NonFiniteGuard`) skips the update of a step whose
    gradients are not finite.  ``forward_fn`` as in :func:`_make_loss_fn`."""
    return make_train_step_dp(cfg, optimizer, None, ops, remat, compute_dtype, label_smoothing,
                              grad_accum, grad_clip, use_dropout, rng, forward_fn,
                              augment_fn=augment_fn, guard=guard, trained=trained)


def make_train_step_dp(
    cfg: ViTConfig,
    optimizer: torch.optim.Optimizer,
    mesh: Optional[Mesh],
    ops: OpsImpl = EAGER_OPS,
    remat: bool = True,
    compute_dtype=None,
    label_smoothing: float = 0.0,
    grad_accum: int = 1,
    grad_clip: float = 0.0,
    use_dropout: bool = False,
    rng: Optional[torch.Generator] = None,
    forward_fn: Optional[Callable] = None,
    distill: Optional[dict] = None,
    augment_fn: Optional[Callable] = None,
    guard: Optional["NonFiniteGuard"] = None,
    trained: Optional[dict] = None,
):
    """The data-parallel step, ``(params, local images, local labels,
    step=None) -> loss``: the counterpart of ``jit_train_step_dp_shard_map``
    (and, on the plain tables, of ``jit_train_step_for_mesh`` on a dp-only
    mesh).  Each
    rank takes value and grad on its own slice of the batch (``grad_accum``
    microbatches of it); the loss and every gradient are averaged over
    ``dp`` in one all-reduce, and each rank's optimizer then applies the
    same update, so the params stay equal on every rank.  With
    ``use_dropout`` or ``augment_fn`` the per-step seed is folded with the
    rank's ``dp`` index (:func:`fold_in`): each rank draws its own masks
    and augments its own images (mixup's and cutmix's partners come from
    its own rows).  ``distill`` (teacher_fwd, alpha, hard, tau) swaps the
    loss for DeiT distillation.
    ``mesh`` None is the single-device step (:func:`make_train_step`).
    The other arguments as in :func:`make_train_step`."""
    if (use_dropout or augment_fn is not None) and rng is None:
        raise ValueError("use_dropout and augment_fn need rng, a torch.Generator (e.g. seeded "
                         "from --seed)")
    if distill is not None:
        if not cfg.distilled:
            raise ValueError(
                f"distillation training needs a distilled student config "
                f"(got {cfg.name}; use deit_*)"
            )
        if use_dropout or forward_fn is not None or augment_fn is not None:
            raise ValueError("distillation composes with none of dropout, forward_fn and "
                             "augment_fn")
        loss_fn = _make_distill_loss_fn(cfg, ops, remat, compute_dtype, label_smoothing=
                                        label_smoothing, **distill)
    else:
        # augmented targets are soft rows, smoothed once by the augmentation
        loss_fn = _make_loss_fn(cfg, ops, remat, compute_dtype,
                                0.0 if augment_fn is not None else label_smoothing, forward_fn)
    calls = itertools.count()

    def train_step(params, images, labels, step: Optional[int] = None) -> torch.Tensor:
        step_rng = None
        if rng is not None:  # seeds of (seed, step), one stream per dp rank
            seed = _step_seed(rng.initial_seed(), next(calls) if step is None else step, mesh)
            aug_seed, drop_seed = ((fold_in(seed, 0), fold_in(seed, 1))
                                   if use_dropout and augment_fn is not None else (seed, seed))
            if augment_fn is not None:
                images, labels = augment_fn(torch.Generator().manual_seed(aug_seed), images,
                                            labels)
            if use_dropout:
                step_rng = torch.Generator().manual_seed(drop_seed)
        _clear_grads(params)
        loss = _value_and_grad_accum(loss_fn, params, images, labels, grad_accum, step_rng)
        return _finish(params, loss, optimizer, grad_clip, mesh, guard, trained)

    return train_step


def make_train_step_kernel_tp(
    cfg: ViTConfig,
    optimizer: torch.optim.Optimizer,
    mesh: Mesh,
    remat: bool = False,
    compute_dtype=None,
    gelu_variant: str = "exact",
    label_smoothing: float = 0.0,
    grad_clip: float = 0.0,
    guard: Optional["NonFiniteGuard"] = None,
    trained: Optional[dict] = None,
):
    """Tensor-parallel training through the fused kernels, ``(local params,
    local images, local labels) -> loss``: the counterpart of
    ``jit_train_step_kernel_tp``.  The forward is
    ``tp_forward.train_forward_tp`` over this rank's shard
    (``sharding.shard_params``; K1/K6 at the local heads, K5 partial/K8
    ``residual=False`` over the local hidden columns, K13/K14 past the
    switch); ``dp`` composes over it.  After the backward the partial
    LayerNorm gradients are summed over ``tp``, everything is averaged
    over ``dp``, ``grad_clip`` takes the global norm over the shards, and
    each rank's optimizer updates its own shards.  ``remat`` recomputes the
    forward (its all-reduces too) in the backward."""
    from vit_tpu_torch.parallel.tp_forward import train_forward_tp

    forward = train_forward_tp(cfg, mesh, gelu_variant)
    return make_train_step_dp(cfg, optimizer, mesh, remat=remat, compute_dtype=compute_dtype,
                              label_smoothing=label_smoothing, grad_clip=grad_clip,
                              forward_fn=lambda p, x, _rng: forward(p, x), guard=guard,
                              trained=trained)


def _pmean_dp(params, loss: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The loss and every gradient averaged over ``dp`` in place, in one
    all-reduce of one flat fp32 buffer (``pmean``).  -> the loss."""
    n = mesh.size("dp")
    if n == 1:
        return loss
    grads = [t.grad for t in leaves(params) if t.grad is not None]
    flat = torch.cat([loss.float().reshape(1), *(g.float().reshape(-1) for g in grads)])
    flat = mesh.all_reduce(flat, "dp").div_(n)
    for g, part in zip(grads, flat[1:].split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))
    return flat[0].clone()


def _finish(params, loss: torch.Tensor, optimizer: torch.optim.Optimizer, grad_clip: float,
            mesh: Optional[Mesh], guard: Optional["NonFiniteGuard"] = None,
            trained: Optional[dict] = None) -> torch.Tensor:
    """After the backward: on a mesh, the ``dp`` mean of the loss and the
    gradients and the sums of the partial ones (``sharding.sum_partial_grads``:
    over ``tp``, ``pp`` or ``sp``); then the update.  -> the loss."""
    if mesh is not None:
        from vit_tpu_torch.parallel.sharding import sum_partial_grads

        loss = _pmean_dp(params, loss, mesh)
        sum_partial_grads(params, mesh)
    _update(params, optimizer, grad_clip, mesh, guard, trained)
    return loss


def _update(params, optimizer: torch.optim.Optimizer, grad_clip: float,
            mesh: Optional[Mesh] = None, guard: Optional["NonFiniteGuard"] = None,
            trained: Optional[dict] = None) -> None:
    """One optimizer update from the leaves' gradients: none when ``guard``
    refuses them (optax's ``apply_if_finite`` outside everything, so it
    tests every leaf's gradient, frozen ones too); else clipped first to
    the global L2 norm ``grad_clip`` when it is > 0, the norm over
    ``trained`` (the leaves the optimizer updates; None: all of
    ``params``), over tp or pp shards the whole tree's
    (``sharding.global_grad_norm``), clipped as ``clip_grad_norm_`` clips."""
    if guard is not None and not guard.admit(
            [t.grad for t in leaves(params) if t.grad is not None], mesh):
        return
    if grad_clip:
        trained = params if trained is None else trained
        from vit_tpu_torch.parallel.sharding import global_grad_norm, splits_params

        if not splits_params(mesh):
            torch.nn.utils.clip_grad_norm_(list(leaves(trained)), grad_clip)
        else:
            coef = torch.clamp(grad_clip / (global_grad_norm(trained, mesh) + 1e-6), max=1.0)
            for t in leaves(trained):
                if t.grad is not None:
                    t.grad.mul_(coef)
    optimizer.step()


# --skip-nonfinite's optax.apply_if_finite(..., max_consecutive_errors=8)
MAX_CONSECUTIVE_ERRORS = 8


class NonFiniteGuard:
    """``optax.apply_if_finite(inner, MAX_CONSECUTIVE_ERRORS)``'s rule and
    counters: a step whose gradients hold a NaN or an infinity gets no
    update (no decay, no moment or count change), unless it is past
    MAX_CONSECUTIVE_ERRORS such steps in a row, which is applied anyway.
    ``notfinite_count`` (consecutive), ``last_finite`` and
    ``total_notfinite`` are the three leaves its state puts before the
    inner optimizer's in a train-state archive."""

    def __init__(self):
        self.notfinite_count, self.last_finite, self.total_notfinite = 0, True, 0

    def admit(self, grads: Sequence[torch.Tensor], mesh: Optional[Mesh] = None) -> bool:
        """Count this step's gradients; -> whether its update applies.  Over
        ``tp`` and ``pp`` the ranks' shards decide together (an all-reduce an
        axis)."""
        bad = torch.stack([~torch.isfinite(g).all() for g in grads]).sum().float().reshape(1)
        for axis in ("tp", "pp"):
            if mesh is not None and mesh.size(axis) > 1:
                bad = mesh.all_reduce(bad, axis)
        finite = bool(bad.item() == 0)  # the one host read of the guard
        self.last_finite = finite
        if finite:
            self.notfinite_count = 0
        else:
            self.notfinite_count += 1
            self.total_notfinite += 1
        return finite or self.notfinite_count > MAX_CONSECUTIVE_ERRORS


def make_ema_update(decay: float = 0.999) -> Callable:
    """``(ema, params) -> ema``: the exponential moving average of the
    params, ``ema = decay * ema + (1 - decay) * params`` per leaf, in place
    (one ``torch._foreach_lerp_`` pass, ``ema + (1 - decay) * (params -
    ema)``).  ``ema`` is a tree of detached copies in ``params``' shape."""

    @torch.no_grad()
    def update(ema, params):
        torch._foreach_lerp_(list(leaves(ema)), [t.detach() for t in leaves(params)],
                             1.0 - decay)
        return ema

    return update


def applied_updates(optimizer: torch.optim.Optimizer) -> int:
    """The updates ``optimizer`` has applied (optax's adam ``count``, which
    a schedule reads: a skipped step moves it not)."""
    if isinstance(optimizer, FusedAdamW):
        return optimizer.count
    for st in optimizer.state.values():
        if "step" in st:
            return int(st["step"])
    return 0


# the optimizer state's scalar leaves and their dtypes in an archive
_SCALARS = {"notfinite_count": np.int32, "last_finite": np.bool_, "total_notfinite": np.int32,
            "count": np.int32, "schedule_count": np.int32}


def opt_state_layout(trained, schedule: bool = False,
                     guard: bool = False) -> List[Tuple[str, Optional[str]]]:
    """optax's leaf order of the optimizer state over a ``trained`` tree,
    as (what, path) pairs, path None for a scalar (``_SCALARS``):

    - ``guard`` (``apply_if_finite``): notfinite_count (int32), last_finite
      (bool), total_notfinite (int32) first;
    - the adam ``count`` (int32), then ``mu`` over ``trained``'s leaves in
      sorted path order, then ``nu`` (fp32): ``optax.adamw``'s
      ``ScaleByAdamState``, the only leaves of its chain with a clip, a
      decay mask, or ``multi_transform``'s frozen branch; and
      :class:`FusedAdamW`'s ``(count, mu, nu)``;
    - ``schedule`` (a learning-rate schedule): its ``count`` (int32) last,
      always the adam count.

    :func:`opt_state_shapes`, :func:`opt_state_leaves` and
    :func:`restore_opt_state` all walk it."""
    from vit_tpu_torch.utils import flatten_tree

    paths = list(flatten_tree(trained))
    head = ["notfinite_count", "last_finite", "total_notfinite"] if guard else []
    return ([(k, None) for k in head] + [("count", None)] + [("mu", p) for p in paths]
            + [("nu", p) for p in paths] + ([("schedule_count", None)] if schedule else []))


def opt_state_shapes(trained, schedule: bool = False,
                     guard: Optional[NonFiniteGuard] = None) -> List[tuple]:
    """The shapes of :func:`opt_state_leaves` for a ``trained`` tree of
    whole (unsharded) leaves: the template ``io/checkpoint.load_train_state``
    holds an archive against."""
    from vit_tpu_torch.utils import flatten_tree

    flat = flatten_tree(trained)
    return [() if path is None else tuple(flat[path].shape)
            for _, path in opt_state_layout(trained, schedule, guard is not None)]


def opt_state_leaves(optimizer: torch.optim.Optimizer, trained, mesh: Optional[Mesh] = None,
                     schedule: bool = False,
                     guard: Optional[NonFiniteGuard] = None) -> List[np.ndarray]:
    """``optimizer``'s state as optax's leaves (:func:`opt_state_layout`),
    whole (under tp or pp every rank gathers the moments: a collective), for
    ``io/checkpoint``.  ``trained`` is the part of the params that
    ``optimizer`` updates."""
    from vit_tpu_torch.utils import flatten_tree

    fused = isinstance(optimizer, FusedAdamW)

    def moment(p, k):
        if fused:
            return optimizer._moments(p)[k]
        st = optimizer.state.get(p, {})
        return st["exp_avg" if k == 0 else "exp_avg_sq"] if st else torch.zeros_like(p)

    flat = flatten_tree(trained)
    trees = {what: {path: moment(p, k).detach() for path, p in flat.items()}
             for k, what in enumerate(("mu", "nu"))}
    from vit_tpu_torch.parallel.sharding import splits_params

    if splits_params(mesh):
        from vit_tpu_torch.parallel.sharding import unshard_params
        from vit_tpu_torch.utils import unflatten_tree

        trees = {what: flatten_tree(unshard_params(unflatten_tree(t), mesh))
                 for what, t in trees.items()}
    count = applied_updates(optimizer)
    scalars = {"count": count, "schedule_count": count}
    if guard is not None:
        scalars.update(notfinite_count=guard.notfinite_count, last_finite=guard.last_finite,
                       total_notfinite=guard.total_notfinite)
    return [_SCALARS[what](scalars[what]) if path is None
            else trees[what][path].float().cpu().numpy()
            for what, path in opt_state_layout(trained, schedule, guard is not None)]


def restore_opt_state(optimizer: torch.optim.Optimizer, trained, opt_leaves: Sequence,
                      mesh: Optional[Mesh] = None, schedule: bool = False,
                      guard: Optional[NonFiniteGuard] = None) -> None:
    """Load :func:`opt_state_layout`'s leaves (``io/checkpoint.load_train_state``'s,
    checked against :func:`opt_state_shapes`) into ``optimizer`` and
    ``guard``; under tp or pp each rank keeps its shards of the moments.  A
    trailing schedule count is the adam count and is not read."""
    from vit_tpu_torch.utils import flatten_tree, unflatten_tree

    scalars, trees = {}, {"mu": {}, "nu": {}}
    for (what, path), a in zip(opt_state_layout(trained, schedule, guard is not None),
                               opt_leaves):
        if path is None:
            scalars[what] = a
        else:
            trees[what][path] = torch.from_numpy(np.asarray(a, np.float32))
    if guard is not None:
        guard.notfinite_count = int(scalars["notfinite_count"])
        guard.last_finite = bool(scalars["last_finite"])
        guard.total_notfinite = int(scalars["total_notfinite"])
    count = int(scalars["count"])
    trees = {what: unflatten_tree(t) for what, t in trees.items()}
    from vit_tpu_torch.parallel.sharding import splits_params

    if splits_params(mesh):
        from vit_tpu_torch.parallel.sharding import shard_params

        trees = {what: shard_params(t, mesh) for what, t in trees.items()}
    mu, nu = (flatten_tree(trees[what]) for what in ("mu", "nu"))
    fused = isinstance(optimizer, FusedAdamW)
    for path, p in flatten_tree(trained).items():
        m, v = (x[path].to(p.device).contiguous() for x in (mu, nu))
        optimizer.state[p] = ({"mu": m, "nu": v} if fused else
                              {"step": torch.tensor(float(count), dtype=torch.float32),
                               "exp_avg": m, "exp_avg_sq": v})
    if fused:
        optimizer.count = count


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

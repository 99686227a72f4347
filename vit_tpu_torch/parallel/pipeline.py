"""Pipeline parallelism over the stacked-layer axis (GPipe) — counterpart of
``vit_tpu.parallel.pipeline``.

The layer stack splits over a ``pp`` mesh axis, L/pp layers a stage
(``sharding.pp_param_pspecs``: every block leaf cut on its layer axis), the
batch splits into microbatches, and activations flow stage to stage by a
cyclic shift (``mesh.shift``, the JAX package's ``ppermute``) in the
M + P - 1 step schedule: at step t stage p runs microbatch t - p.  A stage
with no microbatch at a step (the bubble) computes nothing, as the JAX
package's masked compute discards, but still takes part in the step's
shift: every rank enters every collective together.

Embeddings, the final LayerNorm (plain torch, as in the JAX package) and
the heads are whole on every stage.  Stage 0 alone embeds; the last
stage's outputs are broadcast to every stage (``mesh.broadcast_from``),
which then runs the final LayerNorm and the head on the same rows.

Each stage's body runs the port's kernels: ``eager`` the plain blocks (with
dropout and drop-path when asked), ``fused`` K1 + K2, ``fused_train`` K1,
K4, K5 forward with K7, K6 backward, regularized ``fused_train`` K1, K10,
K11 forward with K12a, K6 backward; with ``tp`` in the mesh, the
tensor-parallel fused block (``tp_forward.fused_block_tp``) on ``fused``,
``fused_train`` and ``quant``.

Training (:func:`make_pp_train_step`) runs the schedule forward with each
stage's graph kept per microbatch, then backward in reverse step order:
the last stage starts each microbatch from the loss's gradient of its rows,
every other stage from the gradient the next stage shifts back, and a stage
hands its input's gradient one stage back.  ``shard_map``'s transpose
places the gradient sums for the JAX package; here they are placed by hand:
a block leaf belongs to one stage (no sum), the heads and the final
LayerNorm are differentiated whole on every stage (no sum), and the
embeddings' gradients, which stage 0 alone computes, are summed over ``pp``
(``sharding.sum_partial_grads``).
"""

from __future__ import annotations

import itertools
from typing import Optional

import torch

from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.models import vit
from vit_tpu_torch.ops import reference
from vit_tpu_torch.ops.dispatch import EAGER_OPS
from vit_tpu_torch.parallel.mesh import Mesh, broadcast_from, shift
from vit_tpu_torch.parallel.sharding import pp_param_pspecs

__all__ = ["pp_param_pspecs", "shard_forward_pp", "make_pp_train_step"]

# the uint32 offset of a microbatch's regularizer seeds (the JAX package's
# hash-stream decorrelation); zero at one microbatch, so a one-microbatch
# pipeline regenerates the single-device step's masks
_MB_SEED = 0x9E3779B9
_U32 = 0xFFFFFFFF


def _check(cfg: ViTConfig, mesh: Mesh, ops_name: str, use_dropout: bool):
    """The JAX package's refusals, in its words -> the local head count
    under tp (None without it)."""
    if "pp" not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no 'pp' axis")
    use_tp = "tp" in mesh.axis_names
    if use_dropout and (use_tp or ops_name not in ("eager", "fused_train")):
        raise ValueError(
            "pp dropout/drop-path needs ops 'eager' or 'fused_train' on a mesh without 'tp' "
            "(the tensor-parallel fused block has no regularized train variant)"
        )
    if ops_name not in (("fused", "fused_train", "quant") if use_tp
                        else ("eager", "fused", "fused_train")):
        raise ValueError(
            f"pp ops {ops_name!r} not supported on mesh axes {mesh.axis_names} "
            "(tp composition needs 'fused'/'fused_train'/'quant'; without a 'tp' axis use "
            "'eager'/'fused'/'fused_train')"
        )
    if cfg.depth % mesh.shape["pp"]:
        raise ValueError(f"pp={mesh.shape['pp']} must divide depth={cfg.depth}")
    if not use_tp:
        return None
    from vit_tpu_torch.parallel.tp_forward import _check_tp

    return cfg.num_heads // _check_tp(cfg, mesh)


class _Pipeline:
    """One rank's stage of the schedule (module docstring)."""

    def __init__(self, cfg: ViTConfig, mesh: Mesh, num_microbatches: int, gelu_variant: str,
                 ops_name: str, use_dropout: bool):
        self.heads_local = _check(cfg, mesh, ops_name, use_dropout)
        self.cfg, self.mesh, self.m = cfg, mesh, num_microbatches
        self.gelu, self.ops_name, self.use_dropout = gelu_variant, ops_name, use_dropout
        self.n, self.stage = mesh.shape["pp"], mesh.index("pp")
        self.per_stage = cfg.depth // self.n

    def _draws(self, dropout_rng, device):
        """(the input dropout's generator or None, this stage's layer seeds,
        this stage's drop-path rates): every stage draws every layer's seed
        in ``vit.forward``'s order, so the seeds of a layer are those of the
        same layer on one device."""
        cfg = self.cfg
        pos_gen = vit.device_generator(dropout_rng, device) if cfg.dropout > 0 else None
        if self.ops_name == "fused_train":
            seeds = vit.layer_seeds(dropout_rng, cfg.depth)
        else:  # eager: one device generator's seed a layer
            seeds = [int(torch.randint(0, 2 ** 62, (), generator=dropout_rng))
                     for _ in range(cfg.depth)]
        lo, hi = self.stage * self.per_stage, (self.stage + 1) * self.per_stage
        return pos_gen, seeds[lo:hi], vit._dp_rates(cfg)[lo:hi]

    def _embed(self, params, images, pos_gen):
        cfg = self.cfg
        x = images.to(params["pos_embed"].dtype)
        x = reference.patch_embed(x, params["patch_embed"]["kernel"],
                                  params["patch_embed"]["bias"], cfg.patch_size)
        x = reference.add_cls_and_pos(x, vit.prefix_tokens(params), params["pos_embed"])
        if pos_gen is not None:  # torchvision's input + pos_embedding site
            x = vit._dropout(x, cfg.dropout, pos_gen)
        return x

    def _run_stage(self, x, blocks, mb: int, seeds, rates):
        """This stage's layers over one microbatch (b, T, D)."""
        cfg, m = self.cfg, self.m
        b, t, d = x.shape
        eps = cfg.layernorm_eps
        per_layer = vit.layers(blocks)
        if self.heads_local is not None:
            from vit_tpu_torch.parallel.tp_forward import fused_block_tp

            x2 = x.reshape(b * t, d)
            for blk in per_layer:
                x2 = fused_block_tp(x2, blk, self.heads_local, t, eps, self.gelu, self.mesh,
                                    self.ops_name == "quant")
            return x2.reshape(b, t, d)
        if self.ops_name in ("fused", "fused_train"):
            from vit_tpu_torch.ops.dispatch import get_ops

            ops = get_ops(self.ops_name)
            x2 = x.reshape(b * t, d)
            if seeds is not None:
                off = (mb * _MB_SEED) & _U32 if m > 1 else 0
                for blk, seed, rate in zip(per_layer, seeds, rates):
                    x2 = ops.encoder_block_train(x2, blk, cfg.num_heads, t, eps, self.gelu,
                                                 (seed + off) & _U32, cfg.dropout, rate)
            else:
                for blk in per_layer:
                    x2 = ops.encoder_block(x2, blk, cfg.num_heads, t, eps, self.gelu)
            return x2.reshape(b, t, d)
        if seeds is not None:
            from vit_tpu_torch.runtime.trainer import fold_in

            for blk, seed, rate in zip(per_layer, seeds, rates):
                gen = torch.Generator(device=x.device).manual_seed(
                    fold_in(seed, mb) if m > 1 else seed)
                x = vit.encoder_block(x, blk, cfg, EAGER_OPS, self.gelu, gen, rate)
            return x
        for blk in per_layer:
            x = vit.encoder_block(x, blk, cfg, EAGER_OPS, self.gelu)
        return x

    def forward(self, params, images, dropout_rng=None, train: bool = False):
        """The schedule forward -> (the last stage's (B, T, D) output on every
        stage, detached; the state :meth:`backward` reads when ``train``)."""
        cfg, m, n, s = self.cfg, self.m, self.n, self.stage
        b = images.shape[0]
        if b % m:
            raise ValueError(f"num_microbatches {m} must divide the per-dp-shard batch {b}")
        if self.use_dropout != (dropout_rng is not None):
            raise ValueError("a dropout rng is given exactly when use_dropout is on")
        pos_gen, seeds, rates = (self._draws(dropout_rng, images.device) if self.use_dropout
                                 else (None, None, None))
        dtype, bm, t, d = params["pos_embed"].dtype, b // m, cfg.seq_len, cfg.embed_dim
        emb = x0 = None
        if s == 0:
            emb = self._embed(params, images, pos_gen)
            x0 = emb.detach().requires_grad_(train)
        inps, outs, buf = {}, {}, None
        for step in range(m + n - 1):
            mb = step - s
            if 0 <= mb < m:
                inp = x0[mb * bm:(mb + 1) * bm] if s == 0 else buf.detach().requires_grad_(train)
                out = self._run_stage(inp, params["blocks"], mb, seeds, rates)
                inps[mb], outs[mb] = inp, out
                send = out.detach()
            else:
                send = torch.zeros((bm, t, d), dtype=dtype, device=images.device)
            if step < m + n - 2:  # the last step's shift has no reader
                buf = shift(send.contiguous(), self.mesh, "pp", 1)
        last = s == n - 1
        rows = (torch.cat([outs[i].detach() for i in range(m)]) if last
                else torch.zeros((b, t, d), dtype=dtype, device=images.device))
        x_all = broadcast_from(rows, self.mesh, "pp", n - 1)
        return x_all, ((emb, x0, inps, outs) if train else None)

    def backward(self, state, grad_all: torch.Tensor) -> None:
        """The schedule backward from the gradient of the broadcast output
        (every stage's own: each runs the same loss on the same rows)."""
        emb, x0, inps, outs = state
        m, n, s = self.m, self.n, self.stage
        bm = grad_all.shape[0] // m
        recv = None
        for step in reversed(range(m + n - 1)):
            mb = step - s
            send = None
            if 0 <= mb < m:
                g = grad_all[mb * bm:(mb + 1) * bm] if s == n - 1 else recv
                torch.autograd.backward(outs[mb], g)
                if s > 0:
                    send = inps[mb].grad
            if step > 0:  # step 0's gradient has no reader
                if send is None:
                    send = torch.zeros_like(grad_all[:bm])
                recv = shift(send.contiguous(), self.mesh, "pp", -1)
        if s == 0:
            emb.backward(x0.grad)

    def head(self, params, x):
        x = reference.layer_norm(x, params["ln_final"]["scale"], params["ln_final"]["bias"],
                                 self.cfg.layernorm_eps)
        return vit.apply_head(x, params)


def shard_forward_pp(cfg: ViTConfig, mesh: Mesh, num_microbatches: int,
                     gelu_variant: str = "exact", ops_name: str = "eager",
                     use_dropout: bool = False):
    """Build ``forward(local params, images) -> logits`` pipelined over
    ``pp`` (inference: no graph).  ``local params`` are this rank's part of
    the tree (``sharding.shard_params`` on the mesh: the block stack split
    over ``pp``, and over ``tp`` by its rules); ``images`` the whole batch
    on every rank, split over ``dp`` when the mesh has it; the whole
    batch's logits out on every rank.  ``num_microbatches`` must divide
    each dp rank's batch.  ``use_dropout`` (``eager``/``fused_train``, no
    ``tp``) returns ``forward(params, images, dropout_rng)`` with dropout
    and drop-path in the stages, each layer's seed that of the same layer
    in ``vit.forward``.  Training is :func:`make_pp_train_step`."""
    from vit_tpu_torch.parallel.shard_forward import shard_forward_dp

    pipe = _Pipeline(cfg, mesh, num_microbatches, gelu_variant, ops_name, use_dropout)

    def local(params, images, dropout_rng=None):
        with torch.no_grad():
            x, _ = pipe.forward(params, images, dropout_rng)
            return pipe.head(params, x)

    def fn(params, images, *dropout_rng):
        return shard_forward_dp(lambda p, x: local(p, x, *dropout_rng), mesh)(params, images)

    return fn


def make_pp_train_step(
    cfg: ViTConfig,
    optimizer: torch.optim.Optimizer,
    mesh: Mesh,
    num_microbatches: int,
    gelu_variant: str = "exact",
    ops_name: str = "eager",
    label_smoothing: float = 0.0,
    use_dropout: bool = False,
    rng: Optional[torch.Generator] = None,
    grad_clip: float = 0.0,
    guard=None,
    trained: Optional[dict] = None,
):
    """Pipeline-parallel training, ``(local params, local images, local
    labels, step=None) -> loss``: the counterpart of the JAX package's
    ``make_pp_train_step``.  ``local params`` as :func:`shard_forward_pp`
    takes them, the batch this rank's ``dp`` slice; the schedule forward and
    backward (module docstring), then the embeddings' gradients summed over
    ``pp``, the ``tp`` sums and the ``dp`` mean (``trainer._finish``) and
    each rank's optimizer on its own stage's leaves.  ``use_dropout`` draws
    step ``step``'s masks from ``rng`` as ``trainer.make_train_step`` does,
    so one microbatch regenerates the single-device step's masks.
    ``grad_clip``, ``guard`` and ``trained`` as in ``make_train_step`` (the
    norm over every stage's leaves)."""
    from vit_tpu_torch.runtime import trainer

    if ops_name in ("fused", "quant"):
        raise ValueError("pp training needs 'eager' or 'fused_train' (differentiable)")
    if use_dropout and rng is None:
        raise ValueError("use_dropout needs rng, a torch.Generator (e.g. seeded from --seed)")
    pipe = _Pipeline(cfg, mesh, num_microbatches, gelu_variant, ops_name, use_dropout)
    calls = itertools.count()

    def train_step(params, images, labels, step: Optional[int] = None) -> torch.Tensor:
        dropout_rng = None
        if use_dropout:
            seed = trainer._step_seed(rng.initial_seed(), next(calls) if step is None else step,
                                      mesh)
            # the single-device loss's derivation: one draw seeds the forward
            draw = int(torch.randint(0, 2 ** 62, (), generator=torch.Generator().manual_seed(seed)))
            dropout_rng = torch.Generator().manual_seed(draw)
        trainer._clear_grads(params)
        x, state = pipe.forward(params, images, dropout_rng, train=True)
        x.requires_grad_(True)
        loss = trainer.cross_entropy_loss(pipe.head(params, x), labels, label_smoothing)
        loss.backward()
        pipe.backward(state, x.grad)
        return trainer._finish(params, loss.detach(), optimizer, grad_clip, mesh, guard, trained)

    return train_step

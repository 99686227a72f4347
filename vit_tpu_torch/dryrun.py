"""One training step of every mesh leg on tiny shapes over ``n`` ranks —
counterpart of ``__graft_entry__.dryrun_multichip``.

Run under ``torch.distributed.run``, one process per rank::

    python -m torch.distributed.run --standalone --nproc-per-node N \
        -m vit_tpu_torch.dryrun [--device cpu]

On the card every rank takes card LOCAL_RANK modulo the cards (ranks that
share one card talk over gloo, the default backend).  The config is the
JAX dryrun's (ViT-B/16 cut to depth 2, D 128, 4 heads, 64 px, 16 classes)
and so are the legs, in its order, each skipped at the ``n`` where the JAX
package skips it:

  - the plain tier (``eager``) train step over the dp x tp mesh (tp 2 where
    n is even), ``parallel/tp_forward.plain_tp_ops``;
  - tp >= 2: the ``fused`` and ``quant`` engines on that mesh against the
    ``eager`` one (fused within 1e-4), a DeiT config likewise, and a
    ``fused_train`` step through the kernels (``make_train_step_kernel_tp``);
  - n >= 2: a pp 2 forward on the first two ranks against the one-rank
    forward (1e-5);
  - n >= 8: a dp 2 x pp 2 x tp 2 ``fused_train`` step, the sp ring's
    forward (dp 2 x sp 4, 1e-4) and its ``eager`` and ``fused_train`` steps;
  - MAE, ZeRO-1 and FSDP steps over the dp x tp mesh;
  - regularized ``fused_train`` and three ToMe train steps over ``dp``;
  - n >= 2: a regularized pp 2 step.

Rank 0 prints the last line, ``dryrun_multichip OK: ...`` with the JAX
line's keys.  A failed leg raises.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import math
from typing import Optional

import torch
import torch.distributed as dist

from vit_tpu_torch.parallel.mesh import Mesh


def _mesh_of_first(axes: dict) -> Optional[Mesh]:
    """``make_mesh(axes)`` over the first prod(axes) ranks (the JAX
    dryrun's ``jax.devices()[:k]``): every rank makes the groups, the others
    get None."""
    from vit_tpu_torch.parallel import make_mesh
    from vit_tpu_torch.parallel.mesh import world

    rank, n = world()
    names, sizes = tuple(axes), [axes[a] for a in axes]
    size = math.prod(sizes)
    if size == n:
        return make_mesh(axes)
    grid = list(itertools.product(*(range(s) for s in sizes)))
    groups = {}
    for i, axis in enumerate(names):
        groups[axis] = None
        if sizes[i] == 1:
            continue
        for rest in sorted({c[:i] + c[i + 1:] for c in grid}):
            ranks = [grid.index(rest[:i] + (k,) + rest[i:]) for k in range(sizes[i])]
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = group
    return Mesh(dict(axes), rank, groups) if rank < size else None


def _local(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's dp slice of a global batch."""
    n = t.shape[0] // mesh.size("dp")
    return t[mesh.index("dp") * n:(mesh.index("dp") + 1) * n]


def _finite(loss, what: str) -> float:
    loss = float(loss)
    assert loss == loss and loss > 0, f"bad {what} loss {loss}"
    return loss


def dryrun_multichip(n_devices: int, device: str = "cuda") -> str:
    """One sharded training step of each leg over this ``torchrun`` world of
    ``n_devices`` ranks (module docstring).  -> the ``dryrun_multichip OK``
    line (rank 0 prints it)."""
    import numpy as np

    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.params import params_to_numpy
    from vit_tpu_torch.models import mae as mae_mod
    from vit_tpu_torch.models import tome as tome_model
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.dispatch import EAGER_OPS, get_ops
    from vit_tpu_torch.parallel import make_mesh, mesh_shape_for
    from vit_tpu_torch.parallel.mesh import world
    from vit_tpu_torch.parallel.sharding import DpShards, shard_params, unshard_params
    from vit_tpu_torch.parallel.tp_forward import plain_tp_ops
    from vit_tpu_torch.runtime import trainer
    from vit_tpu_torch.runtime.engine import InferenceEngine

    rank, n = world()
    assert n == n_devices, f"need {n_devices} ranks, have {n}"
    dev = torch.device(device)
    cfg = dataclasses.replace(VIT_B_16, depth=2, embed_dim=128, num_heads=4, image_size=64,
                              patch_size=16, num_classes=16, name="vit_dryrun")
    tp = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(mesh_shape_for(n_devices, tp=tp))
    # the dp ranks alone (a tp group's ranks step on the same rows), the
    # placement of the JAX dryrun's dp shard_map legs
    dp_mesh = Mesh({"dp": mesh.size("dp")}, mesh.index("dp"), {"dp": mesh.groups["dp"]})

    def adamw(params):
        # optax.adamw(1e-3)'s defaults
        return torch.optim.AdamW(list(trainer.leaves(params)), lr=1e-3, weight_decay=1e-4)

    def trainable(tree):
        return trainer.as_trainable(tree, dev)

    plain = plain_tp_ops(EAGER_OPS, mesh) if tp > 1 else EAGER_OPS
    whole0 = vit.init_params(torch.Generator().manual_seed(0), cfg)
    params = trainable(shard_params(whole0, mesh))
    step = trainer.make_train_step_dp(cfg, adamw(params), mesh, plain)

    batch = max(2 * mesh.size("dp"), 4)
    images = torch.ones((batch, cfg.in_channels, cfg.image_size, cfg.image_size), device=dev)
    labels = torch.zeros((batch,), dtype=torch.long, device=dev)
    x, y = _local(images, mesh), _local(labels, mesh)
    loss = _finite(step(params, x, y), "dp x tp")

    # the kernel paths under the same mesh, against the plain tier's engine
    infer = params_to_numpy(unshard_params(params, mesh))
    imgs_np = images.cpu().numpy()

    def engine(tree, ops, c=cfg):
        return InferenceEngine(c, tree, dtype="float32", ops=ops, device=dev, mesh=mesh,
                               batch_pad=batch)

    eager_logits = engine(infer, "eager").logits(imgs_np).cpu().numpy()
    fused_tp = quant_tp = deit_status = ktp_status = "skipped"
    if tp >= 2:
        fused = engine(infer, "fused").logits(imgs_np).cpu().numpy()
        dev_f = float(np.abs(fused - eager_logits).max())
        assert np.isfinite(fused).all() and dev_f < 1e-4, (
            f"fused-tp={tp} deviates {dev_f} from the plain tier")
        fused_tp = "ok"
        assert np.isfinite(engine(infer, "quant").logits(imgs_np).cpu().numpy()).all()
        quant_tp = "ok"
        deit_cfg = dataclasses.replace(cfg, distilled=True, name="deit_dryrun")
        deit = params_to_numpy(vit.init_params(torch.Generator().manual_seed(7), deit_cfg))
        d_dev = float(np.abs(engine(deit, "fused", deit_cfg).logits(imgs_np).cpu().numpy()
                             - engine(deit, "eager", deit_cfg).logits(imgs_np).cpu().numpy()
                             ).max())
        assert d_dev < 1e-4, f"distilled fused-tp deviates {d_dev} from the plain tier"
        deit_status = "ok"
        p_tp = trainable(shard_params(_tree(infer), mesh))
        ktp = trainer.make_train_step_kernel_tp(cfg, adamw(p_tp), mesh)
        _finite(ktp(p_tp, x, y), "kernel-tp")
        ktp_status = "ok"

    # pipeline parallelism: pp 2 on the first two ranks against one rank
    pp_status = "skipped"
    pp_mesh = _mesh_of_first({"pp": 2}) if n_devices >= 2 else None
    from vit_tpu_torch.parallel.pipeline import make_pp_train_step, shard_forward_pp

    with torch.no_grad():
        tree = _on(_tree(infer), dev)
        want = vit.forward(tree, images, cfg).cpu().numpy()
    if pp_mesh is not None:
        with torch.no_grad():
            got = shard_forward_pp(cfg, pp_mesh, 2)(shard_params(tree, pp_mesh),
                                                     images).cpu().numpy()
        pp_dev = float(np.abs(got - want).max())
        assert pp_dev < 1e-5, f"pp=2 deviates {pp_dev} from the one-rank forward"
    if n_devices >= 2:
        pp_status = "ok"

    pp3d_status = sp_status = sp_fused_status = "skipped"
    mesh3d = _mesh_of_first({"dp": 2, "pp": 2, "tp": 2}) if n_devices >= 8 else None
    sp_mesh = _mesh_of_first({"dp": 2, "sp": 4}) if n_devices >= 8 else None
    if mesh3d is not None:
        p3 = trainable(shard_params(_tree(infer), mesh3d))
        step3 = make_pp_train_step(cfg, adamw(p3), mesh3d, 2, ops_name="fused_train")
        _finite(step3(p3, _local(images, mesh3d), _local(labels, mesh3d)), "3d")
    if sp_mesh is not None:
        from vit_tpu_torch.parallel.sequence import make_sp_train_step, shard_forward_sp

        with torch.no_grad():
            got = shard_forward_sp(cfg, sp_mesh)(_on(_tree(infer), dev), images).cpu().numpy()
        sp_dev = float(np.abs(got - want).max())
        assert sp_dev < 1e-4, f"dp2xsp4 deviates {sp_dev} from the one-rank forward"
        for ops_name in ("eager", "fused_train"):
            p_sp = trainable(_tree(infer))
            sp_step = make_sp_train_step(cfg, adamw(p_sp), sp_mesh, ops_name=ops_name)
            _finite(sp_step(p_sp, _local(images, sp_mesh), _local(labels, sp_mesh)), "sp")
    if n_devices >= 8:
        pp3d_status = sp_status = sp_fused_status = "ok"

    # MAE over the dp x tp mesh: the encoder tensor-parallel, the decoder whole
    mcfg = mae_mod.MAEConfig(mask_ratio=0.5, decoder_dim=64, decoder_depth=1, decoder_heads=2)
    p_mae = trainable(shard_params(
        mae_mod.init_mae_params(torch.Generator().manual_seed(1), cfg, mcfg), mesh))
    mae_step = trainer.make_mae_train_step(cfg, mcfg, adamw(p_mae),
                                           torch.Generator(device=dev).manual_seed(2), plain,
                                           mesh=mesh, decoder_ops=EAGER_OPS)
    _finite(mae_step(p_mae, x), "mae")

    # ZeRO-1: the moments sliced over dp; FSDP: the params too
    p_z = trainable(shard_params(_tree(infer), mesh))
    zero1 = trainer.Zero1(p_z, mesh)
    z_step = trainer.make_train_step_dp(cfg, adamw(zero1.slices), mesh, plain, zero1=zero1)
    _finite(z_step(p_z, x, y), "zero1")
    p_f = shard_params(_tree(infer), mesh)
    fsdp = DpShards(p_f, mesh)
    p_f = trainable(fsdp.slice(p_f))
    f_step = trainer.make_train_step_dp(cfg, adamw(p_f), mesh, plain, fsdp=fsdp)
    _finite(f_step(p_f, x, y), "fsdp")

    # the regularized and token-merging fused_train steps over dp
    fused_train = get_ops("fused_train")
    xd, yd = _local(images, dp_mesh), _local(labels, dp_mesh)
    reg_cfg = dataclasses.replace(cfg, dropout=0.1, drop_path=0.1)
    p_rep = trainable(_tree(infer))
    reg_step = trainer.make_train_step_dp(reg_cfg, adamw(p_rep), dp_mesh, fused_train,
                                          remat=False, use_dropout=True,
                                          rng=torch.Generator().manual_seed(3))
    _finite(reg_step(p_rep, xd, yd), "reg")
    tm_cfg = dataclasses.replace(cfg, patch_size=8, name="vit_dryrun_tome")
    p_tm = trainable(vit.init_params(torch.Generator().manual_seed(4), tm_cfg))
    opt_tm = adamw(p_tm)
    tome_step = trainer.make_train_step_dp(
        tm_cfg, opt_tm, dp_mesh, fused_train, remat=False,
        forward_fn=lambda p, im, rng: tome_model.forward_train(p, im, tm_cfg, 4))
    _finite(tome_step(p_tm, xd, yd), "tome-train")
    for seed, (p_drop, what) in ((5, (0.1, "tome-reg-train")),
                                 (8, (0.0, "tome-droppath-train"))):
        c = dataclasses.replace(tm_cfg, dropout=p_drop, drop_path=0.1)
        reg = trainer.make_train_step_dp(
            c, opt_tm, dp_mesh, fused_train, remat=False, use_dropout=True,
            rng=torch.Generator().manual_seed(seed),
            forward_fn=lambda p, im, rng, _c=c: tome_model.forward_train(p, im, _c, 4,
                                                                        dropout_rng=rng))
        _finite(reg(p_tm, xd, yd), what)

    # regularized pipeline training: dropout and drop-path inside the stages
    pp_reg_status = "skipped"
    if pp_mesh is not None:
        p_ppr = trainable(shard_params(_tree(infer), pp_mesh))
        ppr_step = make_pp_train_step(reg_cfg, adamw(p_ppr), pp_mesh, 2, ops_name="fused_train",
                                      use_dropout=True, rng=torch.Generator().manual_seed(6))
        _finite(ppr_step(p_ppr, images, labels), "pp-dropout")
    if n_devices >= 2:
        pp_reg_status = "ok"

    line = (
        f"dryrun_multichip OK: mesh={dict(mesh.shape)} batch={batch} "
        f"loss={loss:.4f} fused_tp={fused_tp} quant_tp={quant_tp} "
        f"deit_tp={deit_status} kernel_tp_train={ktp_status} pp2={pp_status} "
        f"pp3d_train_dp2xpp2xtp2={pp3d_status} sp_ring_dp2xsp4={sp_status} "
        f"sp_fused_train={sp_fused_status} "
        f"mae_dpxtp=ok zero1_dpxtp=ok fsdp_dpxtp=ok regularized_train_dp=ok "
        f"tome_train_dp=ok tome_dropout_train_dp=ok "
        f"tome_droppath_lerp_train_dp=ok "
        f"pp_dropout_train={pp_reg_status}"
    )
    if rank == 0:
        print(line, flush=True)
    return line


def _tree(flat_numpy: dict) -> dict:
    """A fresh torch tree of a numpy params tree (fp32, on the CPU)."""
    from vit_tpu_torch.io.params import params_from_numpy

    return params_from_numpy(flat_numpy, "cpu", torch.float32)


def _on(tree: dict, dev) -> dict:
    return {k: _on(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


def main(argv=None) -> int:
    from vit_tpu_torch.io.params import device_or_raise
    from vit_tpu_torch.runtime import distributed

    p = argparse.ArgumentParser(description="one training step of every mesh leg on tiny "
                                "shapes, over the ranks of torchrun")
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    p.add_argument("--dist-backend", default="gloo", choices=["nccl", "gloo"],
                   help="gloo (the default) lets ranks share one card")
    args = p.parse_args(argv)
    device = args.device
    if device == "cuda":
        device_or_raise(device)
        device = f"cuda:{distributed.local_rank() % torch.cuda.device_count()}"
        torch.cuda.set_device(device)
    distributed.initialize(backend=args.dist_backend, device_type=torch.device(device).type)
    from vit_tpu_torch.parallel.mesh import world

    dryrun_multichip(world()[1], device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

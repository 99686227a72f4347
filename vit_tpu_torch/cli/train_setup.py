"""Training-run construction for the vit-tpu-torch-train CLI: mesh,
device, op table, params, optimizer, resume, step, data and EMA.
Counterpart of ``vit_tpu.cli.train_setup``; ``prepare(args)`` returns a
:class:`TrainSetup`, and invalid flags raise :class:`SetupError` (the CLI
prints the message and exits 2), in the JAX package's order and words.
``--pp`` trains pipelined over the layer stack (``parallel/pipeline.py``,
composing with ``--dp`` and ``--tp``), ``--sp`` over a ring of token shards
(``parallel/sequence.py``, composing with ``--dp``); ``--multihost`` over a
dp mesh of every process, each streaming its rows of the global batch, as a
``--dp`` rank does.  What the JAX package runs through GSPMD tensor
parallelism (``--tp`` on ``eager`` or ``qat``, and so distillation and MAE
with ``--tp``) raises ``NotImplementedError`` (ROADMAP.md item 14).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from vit_tpu_torch.ops import fused_block
from vit_tpu_torch.parallel.mesh import Mesh


class SetupError(Exception):
    """Invalid flag combination; exit code in ``code``."""

    def __init__(self, message: str, code: int = 2):
        super().__init__(message)
        self.code = code


@dataclasses.dataclass
class TrainSetup:
    """Everything the step loop (cli/train_loop.py) needs."""

    cfg: object
    device: torch.device
    ops_name: str
    step: Callable
    params: dict
    optimizer: torch.optim.Optimizer
    # the part of params that the optimizer updates (all of it, or the
    # head(s) under --freeze-backbone), in params' shape
    trained: dict
    # step -> lr for the loop to set, None when constant or when the
    # optimizer evaluates its own schedule (FusedAdamW)
    lr_at: Optional[Callable[[int], float]]
    images: Optional[np.ndarray]  # static data (None when streaming)
    labels: Optional[np.ndarray]
    n_static: int  # len(images) after ragged-batch truncation (0 when streaming)
    # --data-dir/--image-dir: the prefetched (images, labels) of this
    # rank's rows of each global batch, on the device (else None)
    stream: Optional[Iterator] = None
    # --eval-data-dir: params -> held-out top-1 (else None)
    run_eval: Optional[Callable] = None
    # this rank's place under --tp/--dp/--pp/--sp (None: one device); the
    # params are its part (its tp shards, its pp stage's layers), and each
    # step takes its dp slice of the global batch
    mesh: Optional[Mesh] = None
    start_step: int = 0  # the first step's number (--resume: the archive's step)
    # --skip-nonfinite: apply_if_finite's rule and counters (else None)
    guard: Optional[object] = None
    # --ema-decay: the averaged params (this rank's shards) and their
    # in-place update (else None)
    ema: Optional[dict] = None
    ema_update: Optional[Callable] = None
    # the optimizer state holds a schedule count (optax.adamw with a
    # schedule): a train-state archive has it as its last leaf
    schedule: bool = False


_DECAY_KEYS = {"kernel", "wqkv", "wo", "w1", "w2"}


def decay_mask(params):
    """True where weight decay applies (the GEMM weights); False for
    LayerNorm scales/biases, every bias, and the cls/pos embeddings — the
    standard ViT recipe (``vit_tpu.cli.train_setup.decay_mask``)."""
    return {
        k: decay_mask(v) if isinstance(v, dict) else k in _DECAY_KEYS
        for k, v in params.items()
    }


def adamw_param_groups(params, weight_decay: float, exempt_norm_bias: bool):
    """AdamW param groups: one with ``weight_decay`` for every leaf, or,
    with ``exempt_norm_bias``, the ``decay_mask`` leaves at
    ``weight_decay`` and the rest at 0."""
    from vit_tpu_torch.runtime.trainer import leaves

    if not exempt_norm_bias:
        return [{"params": list(leaves(params)), "weight_decay": weight_decay}]
    flags = list(leaves(decay_mask(params)))
    tensors = list(leaves(params))
    return [
        {"params": [t for t, f in zip(tensors, flags) if f], "weight_decay": weight_decay},
        {"params": [t for t, f in zip(tensors, flags) if not f], "weight_decay": 0.0},
    ]


def warmup_cosine(lr: float, steps: int) -> Callable[[int], float]:
    """step -> learning rate, equal to
    ``optax.warmup_cosine_decay_schedule(0, lr, max(steps // 10, 1), steps)``:
    linear from 0 to ``lr`` over the warmup, then a cosine to 0."""
    warm = max(steps // 10, 1)
    decay = steps - warm
    if decay <= 0:
        raise SetupError(f"error: --schedule warmup_cosine needs --steps > {warm} (got {steps})")

    def lr_at(count: int) -> float:
        if count < warm:
            return lr * count / warm
        c = min(count - warm, decay)
        return lr * 0.5 * (1.0 + math.cos(math.pi * c / decay))

    return lr_at


def _trained(params, freeze_backbone: bool) -> dict:
    """The leaves the optimizer updates: all, or under --freeze-backbone the
    classification head(s) alone (``head``, and ``head_dist`` of a distilled
    tree, which ``apply_head`` averages with it)."""
    if not freeze_backbone:
        return params
    return {k: params[k] for k in ("head", "head_dist") if k in params}


def _augment(args, cfg, dp_only: bool):
    """--augment and its alphas -> ``runtime/augment.make_augment_fn``'s
    function, or None without --augment."""
    if (args.augment or args.grad_accum > 1) and not dp_only:
        raise SetupError(
            "error: --augment/--grad-accum support the dp paths only (no --pp/--tp/--sp)")
    if not args.augment:
        return None
    from vit_tpu_torch.runtime.augment import make_augment_fn

    try:
        fn = make_augment_fn([a.strip() for a in args.augment.split(",") if a.strip()],
                             cfg.num_classes, label_smoothing=args.label_smoothing,
                             mixup_alpha=args.mixup_alpha, cutmix_alpha=args.cutmix_alpha)
    except ValueError as e:
        raise SetupError(f"error: {e}") from e
    print(f"augment: {args.augment} (on the device, inside the step)")
    return fn


def _detached(tree) -> dict:
    """Detached copies of a tree's tensors (the EMA's start)."""
    return {k: _detached(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


def _load_data(args, cfg):
    """-> (images, labels): --input/--labels, or synthetic images and
    random labels made exactly as the JAX CLI makes them."""
    from vit_tpu_torch.io import images as iio

    rng = np.random.default_rng(args.seed)
    if not args.input:
        images = iio.synth_images(args.batch, cfg, seed=args.seed)
        return images, rng.integers(0, cfg.num_classes, args.batch).astype(np.int32)
    images = iio.load_image_bin(args.input)
    if not args.labels:
        print("warning: --input given without --labels; pairing real images with "
              "RANDOM labels (smoke-test only)", file=sys.stderr)
        return images, rng.integers(0, cfg.num_classes, len(images)).astype(np.int32)
    labels = np.fromfile(args.labels, dtype="<i4")
    if len(labels) < len(images):
        raise SetupError(f"error: {len(labels)} labels < {len(images)} images in {args.labels}")
    labels = labels[: len(images)]
    if labels.size and (labels.min() < 0 or labels.max() >= cfg.num_classes):
        raise SetupError(f"error: labels outside [0, {cfg.num_classes}) in {args.labels}")
    return images, labels


def _build_data(args, cfg, mesh: Optional[Mesh], device, start_step: int):
    """--data-dir/--image-dir -> a prefetch stream of this rank's rows of
    each global batch, on ``device``: the batches a one-device run with the
    same seed draws (``EpochStream.batch_indices`` from ``start_step`` on),
    each rank reading only its dp rows (tp, pp and sp ranks the same rows).  None
    without either flag."""
    if not (args.data_dir or args.image_dir):
        return None
    from vit_tpu_torch.io import native
    from vit_tpu_torch.io.dataset import BinShardDataset, ImageFolderDataset
    from vit_tpu_torch.runtime.prefetch import prefetch_to_device

    if args.data_dir:
        ds = BinShardDataset(args.data_dir, require_labels=True, threads=args.data_threads,
                             num_classes=cfg.num_classes)
        data_desc = (f"{len(ds)} images in {len(ds.paths)} shard(s), "
                     f"{'native' if native.gather_available() else 'numpy'} reader")
    else:
        # mode='train': the full frame, no center crop
        ds = ImageFolderDataset(args.image_dir, cfg.image_size, threads=args.data_threads,
                                mode="train")
        if len(ds.class_names) > cfg.num_classes:
            raise SetupError(f"error: {len(ds.class_names)} class folders > "
                             f"{cfg.num_classes} model classes ({cfg.name})")
        data_desc = f"{len(ds)} raw images in {len(ds.class_names)} class folders, PIL decoder"
    if len(ds) < args.batch:
        raise SetupError(f"error: {len(ds)} image(s) < --batch {args.batch}; "
                         "reduce --batch or provide more data")
    print(f"data: {data_desc}, {args.data_threads} threads")
    local = args.batch // (mesh.size("dp") if mesh is not None else 1)
    lo = mesh.index("dp") * local if mesh is not None else 0
    labels = ds.labels()

    def rows():
        for take in ds.batch_indices(args.batch, shuffle=True, seed=args.seed,
                                     skip_batches=start_step):
            mine = take[lo : lo + local]
            yield ds.read(mine), labels[mine]

    return prefetch_to_device(rows(), size=2, device=device)


@contextlib.contextmanager
def _fp32_matmuls():
    """fp32 matmuls in full fp32 on the card (TF32 off), restored after."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _build_eval(args, cfg, mesh: Optional[Mesh], device):
    """--eval-data-dir -> ``run_eval(params) -> top-1``: the first n_eval
    images of the held-out shards (whole batches, at most --eval-batches),
    scored by the fp32 eager forward with TF32 off, as the JAX package
    scores them with its fp32 ``xla``-tier forward.  Under --tp or --pp every
    rank gathers the whole tree first (a collective: every rank evaluates)."""
    if not args.eval_every:
        raise SetupError("error: --eval-data-dir requires --eval-every N")
    from vit_tpu_torch.io.dataset import BinShardDataset
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.dispatch import get_ops
    from vit_tpu_torch.parallel.sharding import splits_params, unshard_params

    eval_ds = BinShardDataset(args.eval_data_dir, require_labels=True,
                              num_classes=cfg.num_classes)
    n_eval = min(len(eval_ds), args.eval_batches * args.batch)
    n_eval -= n_eval % args.batch
    if n_eval == 0:
        raise SetupError(f"error: {len(eval_ds)} eval image(s) < --batch {args.batch}")
    eval_x = eval_ds.read(range(n_eval))
    eval_y = eval_ds.labels()[:n_eval]
    eager = get_ops("eager")

    def run_eval(params) -> float:
        if splits_params(mesh):
            params = unshard_params(params, mesh)
        correct = 0
        with torch.no_grad(), _fp32_matmuls():
            for i in range(0, n_eval, args.batch):
                x = torch.from_numpy(eval_x[i : i + args.batch]).to(device)
                logits = vit.forward(params, x, cfg, eager).cpu().numpy()
                correct += int((logits.argmax(-1) == eval_y[i : i + args.batch]).sum())
        return correct / n_eval

    print(f"eval: {n_eval} held-out images every {args.eval_every} steps")
    return run_eval


def _tome_forward(args, cfg, ops_name: str, dp_only: bool = True):
    """--tome/--tome-chunk -> the merged-token forward ``(params, images,
    dropout_rng) -> logits`` for the trainer, or None without --tome."""
    if args.tome_chunk is not None and not args.tome:
        # tell "--tome absent" from an explicit "--tome 0"
        raise SetupError(
            "error: --tome-chunk requires --tome > 0"
            if args.tome is not None
            else "error: --tome-chunk requires --tome"
        )
    if not args.tome:
        return None
    from vit_tpu_torch.models import tome

    if ops_name not in ("fused_train", "eager") or not dp_only:
        raise SetupError("error: --tome training requires --ops fused_train or eager on a dp mesh")
    if args.mae or args.distill_teacher:
        raise SetupError(
            "error: --tome training does not compose with --mae/--distill-teacher (the "
            "merged-token forward has no hooks for them)"
        )
    chunk = tome.TRAIN_MERGE_CHUNK if args.tome_chunk is None else args.tome_chunk
    if chunk < 1:
        raise SetupError("error: --tome-chunk must be >= 1")
    try:
        counts = tome.schedule(cfg, args.tome, chunk)
    except ValueError as e:
        raise SetupError(f"error: {e}") from e
    impl = tome.forward_train if ops_name == "fused_train" else tome.forward_eager
    print(f"tome training: r={args.tome} (chunk {chunk}, final {cfg.seq_len - sum(counts)} "
          "tokens)")

    def forward(params, images, dropout_rng):
        return impl(params, images, cfg, args.tome, counts=counts, dropout_rng=dropout_rng)

    return forward


def _mae_config(args, cfg, ops_name: str, tp: int = 1):
    """--mae and its flags -> an ``MAEConfig``, or None without --mae (the
    MAE-only flags are then refused, not ignored)."""
    if not args.mae:
        if args.save_backbone:
            raise SetupError("error: --save-backbone requires --mae")
        mae_only = [name for name, off in (
            ("--mask-ratio", args.mask_ratio == 0.75),
            ("--mae-decoder", args.mae_decoder == "512,8,16"),
            ("--no-norm-pix", not args.no_norm_pix),
        ) if not off]
        if mae_only:
            raise SetupError(f"error: {'/'.join(mae_only)} require --mae")
        return None
    from vit_tpu_torch.models import mae

    if (args.distill_teacher or args.augment or args.label_smoothing or args.dropout
            or args.drop_path or args.pp > 1 or args.sp > 1 or args.grad_accum > 1
            or args.num_classes
            or args.freeze_backbone or args.eval_data_dir or args.init_weights
            or args.save_reference or args.optimizer == "fused_adamw"):
        raise SetupError(
            "error: --mae is self-supervised pretraining — it excludes the label-dependent "
            "and layout-specific flags (--distill-teacher/--augment/--label-smoothing/"
            "--dropout/--drop-path/--pp/--sp/--grad-accum/--num-classes/--freeze-backbone/"
            "--eval-data-dir/--init-weights/--save-reference/--optimizer fused_adamw); use "
            "--resume for warm starts and --save-backbone + --init-weights for downstream "
            "fine-tuning"
        )
    if ops_name not in ("eager", "fused_train"):
        raise SetupError(f"error: --mae supports --ops eager or fused_train (got {ops_name})")
    if ops_name == "fused_train" and tp > 1:
        raise SetupError(
            "error: --mae with --tp>1 requires --ops eager (the MAE kernel path is dp-only)"
        )
    try:
        dim, depth, heads = (int(v) for v in args.mae_decoder.split(","))
    except ValueError:
        raise SetupError(
            f"error: --mae-decoder must be DIM,DEPTH,HEADS (got {args.mae_decoder!r})"
        ) from None
    mae_cfg = mae.MAEConfig(mask_ratio=args.mask_ratio, decoder_dim=dim, decoder_depth=depth,
                            decoder_heads=heads, norm_pix_loss=not args.no_norm_pix)
    try:
        mae.check_config(cfg)
        keep = mae_cfg.len_keep(cfg)
        mae_cfg.decoder_cfg(cfg)
    except ValueError as e:
        raise SetupError(f"error: {e}") from e
    print(f"mae: mask_ratio {args.mask_ratio} ({keep}/{cfg.num_patches} patches visible), "
          f"decoder {dim}x{depth} ({heads} heads), norm_pix {not args.no_norm_pix}")
    return mae_cfg


def _teacher(args, cfg, ops_name: str, device, compute_dtype, tp: int = 1):
    """--distill-teacher and its flags -> the frozen teacher's ``images ->
    logits``, or None without --distill-teacher.  The teacher runs on
    ``fused`` under ``fused_train``, on ``quant`` with
    --distill-teacher-int8 (quantized from fp32 first, then cast, as the
    engine prepares it), else on ``eager``."""
    if args.distill_teacher_int8 and not args.distill_teacher:
        raise SetupError(
            "error: --distill-teacher-int8 modifies the teacher path — pass "
            "--distill-teacher WEIGHTS too"
        )
    if not args.distill_teacher:
        return None
    from vit_tpu_torch.config import get_config
    from vit_tpu_torch.io.load_any import load_params_any
    from vit_tpu_torch.io.params import params_from_numpy
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops import quant
    from vit_tpu_torch.ops.dispatch import get_ops

    if not cfg.distilled:
        raise SetupError(
            f"error: --distill-teacher needs a distilled student --config (deit_*), got "
            f"{cfg.name}"
        )
    if ops_name not in ("eager", "qat", "fused_train"):
        raise SetupError("error: --distill-teacher requires --ops eager, qat, or fused_train")
    if ops_name == "fused_train" and tp > 1:
        raise SetupError(
            "error: --distill-teacher with --tp > 1 requires --ops eager or qat (the kernel-TP "
            "train step has no teacher leg); fused_train distillation runs on a dp mesh"
        )
    if args.multihost:
        raise SetupError(
            "error: --distill-teacher composes with --dp/--tp only (no --pp/--sp/--multihost/"
            "--augment/--grad-accum/--dropout)"
        )
    if args.pp > 1 or args.sp > 1:
        raise SetupError("error: --distill-teacher composes with --dp/--tp only (no --pp/--sp)")
    if args.grad_accum > 1 or args.dropout or args.drop_path or args.augment:
        raise SetupError(
            "error: --distill-teacher composes with none of --grad-accum/--dropout/--drop-path/"
            "--augment"
        )
    t_cfg = (get_config(args.distill_config) if args.distill_config
             else dataclasses.replace(cfg, distilled=False, name=f"{cfg.name}_teacher"))
    if t_cfg.num_classes != cfg.num_classes:
        t_cfg = dataclasses.replace(t_cfg, num_classes=cfg.num_classes)
    if t_cfg.image_size != cfg.image_size:
        raise SetupError(
            f"error: teacher config {t_cfg.name} is {t_cfg.image_size}px but the student "
            f"trains at {cfg.image_size}px"
        )
    try:
        t_tree = load_params_any(args.distill_teacher, t_cfg,
                                 allow_synth=args.allow_synth_weights)
    except ValueError as e:
        raise SetupError(f"error: {e}") from e
    # an .npz load skips config validation: a teacher trained with another
    # head width would otherwise hand out argmax labels outside the
    # student's class range
    t_classes = int(np.asarray(t_tree["head"]["bias"]).shape[0])
    if t_classes != cfg.num_classes:
        raise SetupError(
            f"error: teacher head has {t_classes} classes but the student trains "
            f"{cfg.num_classes} — the distillation targets must share the student's label space"
        )
    if args.distill_teacher_int8 and ops_name != "fused_train":
        raise SetupError("error: --distill-teacher-int8 requires --ops fused_train")
    t_params = params_from_numpy(t_tree, device, torch.float32)
    t_tag = ""
    if args.distill_teacher_int8:
        # quantize from full precision FIRST, then cast the other leaves
        t_params = quant.quantize_params(t_params)
        if compute_dtype is not None:
            t_params = quant.cast_quantized_params(t_params, compute_dtype)
        t_ops = get_ops("quant")
        t_tag = " [teacher on W8A8 kernels]"
    else:
        if compute_dtype is not None:
            t_params = vit.cast_params(t_params, compute_dtype)
        t_ops = get_ops("fused" if ops_name == "fused_train" else "eager")
        if ops_name == "fused_train":
            t_tag = " [teacher on fused kernels]"
    mode = (f"soft KD (tau={args.distill_tau})" if args.distill_soft
            else "hard (CE vs teacher argmax)")
    print(f"distillation: teacher {t_cfg.name} from {args.distill_teacher}, "
          f"alpha={args.distill_alpha}, {mode}" + t_tag)

    def teacher_fwd(images):
        return vit.forward(t_params, images, t_cfg, t_ops)

    return teacher_fwd


def _mesh_flags(args) -> None:
    """The JAX package's ``_build_mesh`` refusals of --sp and --pp, in its
    order and words; --sp on --ops auto takes the eager tier."""
    if args.sp > 1:
        if args.multihost:
            raise SetupError("error: --sp composes with --dp only (no --pp/--tp/--multihost)")
        if args.pp > 1 or args.tp > 1:
            raise SetupError("error: --sp composes with --dp only (no --pp/--tp)")
        if args.optimizer == "fused_adamw":
            raise SetupError("error: --sp supports the plain optimizer (--optimizer adamw)")
        if args.ops not in ("auto", "eager", "fused_train"):
            raise SetupError(
                "error: --sp requires --ops eager or fused_train (the ring itself is plain "
                "PyTorch collectives; fused_train runs each shard's out_proj/MLP through the "
                "split CUDA kernels)"
            )
        if args.ops == "auto":
            args.ops = "eager"
    elif args.pp > 1:
        if args.multihost:
            raise SetupError("error: --pp with --multihost is not supported")
        if args.mixed_precision or args.optimizer == "fused_adamw":
            raise SetupError(
                "error: --pp supports the plain optimizer at the params' dtype "
                "(no --mixed-precision/--optimizer fused_adamw)"
            )


def _multihost_mesh(args) -> tuple:
    """--multihost: the process group (``common.resolve_multihost``), then
    the JAX package's refusals and its line, in its order and words -> (a
    dp Mesh over every process, the device)."""
    from vit_tpu_torch.cli import common

    try:
        mesh, device = common.resolve_multihost(args.coordinator, args.num_processes,
                                                args.process_id, args.device, args.dist_backend)
    except (ValueError, RuntimeError) as e:
        raise SetupError(f"error: {e}") from e
    if not (args.data_dir or args.image_dir):
        raise SetupError("error: --multihost requires --data-dir or --image-dir (each host "
                         "streams its own shard of the dataset)")
    if args.tp != 1:
        raise SetupError("error: --multihost supports dp only (tp=1): checkpoint round-trips "
                         "assume host-replicated params")
    procs = mesh.size("dp")
    print(f"multihost: {procs} host(s), {procs} global device(s)")
    if args.batch % procs:
        raise SetupError(f"error: global --batch {args.batch} must divide across {procs} hosts")
    if mesh.rank == 0:
        print(f"mesh: {{'dp': {procs}}} over {procs} rank(s)")
    return mesh, torch.device(device)


def build_mesh(args) -> tuple:
    """--tp/--dp/--pp/--sp/--dist-backend -> (this rank's Mesh, or None for
    one device; its torch.device).  The ranks come from ``torchrun``
    (``cli/common.resolve_mesh``): each takes card LOCAL_RANK modulo the
    card count, and gloo only when asked for.  --multihost: a dp mesh over
    every process (``_multihost_mesh``)."""
    from vit_tpu_torch.cli import common

    if not args.multihost:
        _mesh_flags(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: torch.cuda.is_available() is False (no NVIDIA card "
            "or a CPU-only PyTorch); pass --device cpu to train on the CPU"
        )
    if args.multihost:
        mesh, device = _multihost_mesh(args)
        _mesh_flags(args)  # after the multihost line, as the JAX package's _build_mesh
        return mesh, device
    try:
        mesh, device = common.resolve_mesh(args.dp, args.tp, args.device, args.dist_backend,
                                           pp=args.pp, sp=args.sp)
    except (common.MeshError, RuntimeError) as e:
        raise SetupError(f"error: {e}") from e
    return mesh, torch.device(device)


def _not_ported_tp(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} with --tp > 1: the JAX package runs it through GSPMD tensor parallelism, "
        "which is not ported (ROADMAP.md item 14); use --ops fused_train, or --dp"
    )


def prepare(args, mesh: Optional[Mesh] = None, device=None) -> TrainSetup:
    """-> the run's :class:`TrainSetup`.  ``mesh`` and ``device`` as
    :func:`build_mesh` returns them (built here when not given)."""
    from vit_tpu_torch.config import resolve_config
    from vit_tpu_torch.io import checkpoint as ckpt
    from vit_tpu_torch.io.load_any import load_params_any
    from vit_tpu_torch.io.params import params_from_numpy
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.dispatch import get_ops
    from vit_tpu_torch.parallel.sharding import shard_params, splits_params
    from vit_tpu_torch.runtime import trainer

    if device is None:
        mesh, device = build_mesh(args)
    dp, tp, pp, sp = ((mesh.size("dp"), mesh.size("tp"), mesh.size("pp"), mesh.size("sp"))
                      if mesh is not None else (1, 1, 1, 1))
    load_cfg = resolve_config(args.config)  # --init-weights loads under its own head
    cfg = resolve_config(args.config, args.num_classes)
    ops_name = args.ops
    if ops_name == "auto":
        if args.distill_teacher and tp > 1:
            # the kernel-TP step has no teacher leg (the JAX package's rule)
            ops_name = "eager"
        else:
            ops_name = "fused_train" if device.type == "cuda" else "eager"
    if pp > 1:  # the JAX package's _resolve_ops
        if ops_name not in ("eager", "fused_train"):
            raise SetupError("error: --pp supports --ops eager or fused_train")
        if tp > 1 and ops_name != "fused_train":
            raise SetupError("error: --pp with --tp requires --ops fused_train (the "
                             "tensor-parallel fused block)")
        if cfg.depth % pp:
            raise SetupError(f"error: --pp {pp} must divide depth {cfg.depth}")
    if args.batch % dp:
        raise SetupError(f"error: --batch {args.batch} must be divisible by dp={dp}")
    compute_dtype = torch.bfloat16 if args.mixed_precision else None
    # fused_train's backward kernels recompute from (x, ctx, x1) already;
    # recomputing the whole forward on top would run it twice
    remat = not args.no_remat and ops_name != "fused_train"
    print(f"device: {device}  ops: {ops_name}  mixed_precision: "
          f"{bool(args.mixed_precision)}  remat: {remat}")
    if (args.batch // dp) % args.grad_accum:
        raise SetupError(f"error: --grad-accum {args.grad_accum} must divide --batch {args.batch}"
                         + (f" / dp={dp}" if dp > 1 else ""))
    use_dropout = bool(args.dropout or args.drop_path)
    if use_dropout:
        # eager and qat: masks drawn in the plain blocks; fused_train:
        # regenerated in the kernels from one seed per layer
        # (ops/trainable.py).  --ops takes no table without regularizer
        # hooks (argparse refuses fused); --tp and --sp have no regularized
        # kernels; under --pp the layers' seeds and rates split with the
        # stages (parallel/pipeline.py).
        if tp > 1 or sp > 1:
            raise SetupError(
                "error: --dropout/--drop-path require --ops eager, qat, or fused_train on a dp "
                "or dp x pp mesh (no --tp/--sp)"
            )
        max_t = fused_block.VMEM_ATTENTION_MAX_T
        if ops_name == "fused_train" and cfg.seq_len > max_t:
            raise SetupError(
                "error: --dropout/--drop-path through the fused kernels support "
                f"seq_len <= {max_t} (got {cfg.seq_len}); use --ops eager for very "
                "long sequences"
            )
        cfg = dataclasses.replace(cfg, dropout=args.dropout, drop_path=args.drop_path)
        print(f"dropout: {args.dropout}  drop_path: {args.drop_path}")
    dp_only = tp == pp == sp == 1
    tome_forward = _tome_forward(args, cfg, ops_name, dp_only)
    mae_cfg = _mae_config(args, cfg, ops_name, tp)
    teacher_fwd = _teacher(args, cfg, ops_name, device, compute_dtype, tp)
    augment_fn = _augment(args, cfg, dp_only)
    if args.save_ema and not args.ema_decay:
        raise SetupError("error: --save-ema requires --ema-decay")

    if mae_cfg is not None:
        from vit_tpu_torch.models import mae

        params = mae.init_mae_params(torch.Generator().manual_seed(args.seed), cfg, mae_cfg)
    elif args.init_weights:
        try:
            tree = load_params_any(args.init_weights, load_cfg, round_to_6dp=True,
                                   allow_synth=args.allow_synth_weights)
        except ValueError as e:
            raise SetupError(f"error: {e}") from e
        params = params_from_numpy(tree, "cpu", torch.float32)
        if args.num_classes:
            params["head"] = vit.init_head(torch.Generator().manual_seed(args.seed ^ 0x4EAD), cfg)
            if "head_dist" in params:
                # a distilled backbone: apply_head averages the two heads, so
                # the distillation head takes the new class count too
                params["head_dist"] = vit.init_head(
                    torch.Generator().manual_seed(args.seed ^ 0xD157), cfg)
            print(f"transfer learning: fresh {cfg.embed_dim} x {args.num_classes} head")
    else:
        params = vit.init_params(torch.Generator().manual_seed(args.seed), cfg)

    try:
        resumed_at = ckpt.peek_step(args.resume) if args.resume else 0
    except ValueError as e:
        raise SetupError(f"error: {e}") from e
    # the loop runs --steps more steps from the restored step, so the
    # schedule's horizon reaches past it (at a bare --steps every resumed
    # step would fall past the decay's end, at lr 0)
    lr_at = (warmup_cosine(args.lr, args.steps + resumed_at)
             if args.schedule == "warmup_cosine" else None)
    fused = args.optimizer == "fused_adamw"
    if fused:
        # the JAX package's refusals, in its order and words
        if args.wd_exempt_norm_bias:
            raise SetupError("error: --wd-exempt-norm-bias requires --optimizer adamw")
        if args.grad_clip:
            raise SetupError("error: --grad-clip requires --optimizer adamw")
        if args.freeze_backbone:
            raise SetupError("error: --freeze-backbone requires --optimizer adamw")
        if args.skip_nonfinite:
            raise SetupError("error: --skip-nonfinite requires --optimizer adamw")
        if ops_name != "fused_train" or tp > 1:
            raise SetupError("error: --optimizer fused_adamw requires --ops fused_train and tp=1")
    guard = trainer.NonFiniteGuard() if args.skip_nonfinite else None
    schedule = lr_at is not None and not fused
    start_step, opt_leaves = 0, None
    if args.resume:
        # params, optimizer and step, held against this run's optimizer
        # layout (the whole tree's shapes: under --tp/--pp each rank then
        # keeps its part)
        template = trainer.opt_state_shapes(_trained(params, args.freeze_backbone), schedule,
                                            guard)
        try:
            tree, opt_leaves, start_step = ckpt.load_train_state(args.resume, template)
        except ValueError as e:
            raise SetupError(f"error: {e}") from e
        params = params_from_numpy(tree, "cpu", torch.float32)
    if tp > 1:
        if ops_name != "fused_train":
            raise _not_ported_tp(f"--ops {ops_name}")
        for what, n in (("num_heads", cfg.num_heads), ("mlp_dim", cfg.mlp_dim)):
            if n % tp:
                raise SetupError(f"error: tp={tp} must divide {what}={n}")
    if splits_params(mesh):
        # each rank keeps and updates its own part (the same seed on every
        # rank makes the same whole tree first)
        params = shard_params(params, mesh)
    params = trainer.as_trainable(params, device, torch.float32)
    trained = _trained(params, args.freeze_backbone)
    if fused:
        # K20 on every leaf; the optimizer evaluates the schedule itself, at
        # its 1-based count, so the loop leaves its lr alone
        optimizer = trainer.FusedAdamW(list(trainer.leaves(params)), lr=lr_at or args.lr,
                                       weight_decay=args.weight_decay)
        lr_at = None
    else:
        # the schedule's lr is set by the loop from the applied updates
        optimizer = torch.optim.AdamW(
            adamw_param_groups(trained, args.weight_decay, args.wd_exempt_norm_bias),
            lr=lr_at(0) if lr_at else args.lr,
        )
    if args.wd_exempt_norm_bias:
        print("weight decay: GEMM kernels only (norm/bias/embeddings exempt)")
    if args.grad_clip:
        print(f"grad-clip: global norm {args.grad_clip}")
    if args.freeze_backbone:
        print("freeze-backbone: training the classification head(s) only (distilled configs "
              "train head AND head_dist — apply_head averages them)")
    if opt_leaves is not None:
        trainer.restore_opt_state(optimizer, trained, opt_leaves, mesh, schedule, guard)
        print(f"resumed from {args.resume} at step {start_step}")
    ops = get_ops(ops_name)
    # every step's randomness (augmentation, dropout, MAE's masks) from
    # seeds of (this seed, the step's number, the dp index)
    draw_seed = args.seed ^ 0xA46
    if mae_cfg is not None:
        gen = torch.Generator(device=device).manual_seed(draw_seed)
        step = trainer.make_mae_train_step(cfg, mae_cfg, optimizer, gen, ops,
                                           compute_dtype=compute_dtype, grad_clip=args.grad_clip,
                                           mesh=mesh, guard=guard, trained=trained)
    elif teacher_fwd is not None:
        step = trainer.make_distill_train_step(
            cfg, optimizer, teacher_fwd, ops, remat=remat, compute_dtype=compute_dtype,
            alpha=args.distill_alpha, hard=not args.distill_soft, tau=args.distill_tau,
            label_smoothing=args.label_smoothing, grad_clip=args.grad_clip, mesh=mesh,
            guard=guard, trained=trained,
        )
    elif sp > 1:
        from vit_tpu_torch.parallel.sequence import make_sp_train_step

        step = make_sp_train_step(
            cfg, optimizer, mesh, label_smoothing=args.label_smoothing,
            compute_dtype=compute_dtype, remat=remat, ops_name=ops_name,
            grad_clip=args.grad_clip, guard=guard, trained=trained,
        )
        print(f"sequence parallel: ring size {sp} (ops {ops_name})")
    elif pp > 1:
        from vit_tpu_torch.parallel.pipeline import make_pp_train_step

        m = args.microbatches or 2 * pp
        local_b = args.batch // dp
        if args.batch % dp or local_b % m:
            raise SetupError(
                f"error: dp={dp} must divide --batch {args.batch}, and --microbatches {m} "
                f"must divide the per-shard batch {local_b}"
            )
        step = make_pp_train_step(
            cfg, optimizer, mesh, m, ops_name=ops_name, label_smoothing=args.label_smoothing,
            use_dropout=use_dropout,
            rng=torch.Generator().manual_seed(draw_seed) if use_dropout else None,
            grad_clip=args.grad_clip, guard=guard, trained=trained,
        )
        print(f"pipeline: {pp} stage(s), {m} microbatches")
    elif tp > 1:
        step = trainer.make_train_step_kernel_tp(
            cfg, optimizer, mesh, remat=remat, compute_dtype=compute_dtype,
            label_smoothing=args.label_smoothing, grad_clip=args.grad_clip, guard=guard,
            trained=trained,
        )
    else:
        step = trainer.make_train_step_dp(
            cfg, optimizer, mesh, ops, remat=remat, compute_dtype=compute_dtype,
            label_smoothing=args.label_smoothing, grad_accum=args.grad_accum,
            grad_clip=args.grad_clip, use_dropout=use_dropout,
            rng=(torch.Generator().manual_seed(draw_seed)
                 if use_dropout or augment_fn is not None else None),
            forward_fn=tome_forward, augment_fn=augment_fn, guard=guard, trained=trained,
        )

    ema = ema_update = None
    if args.ema_decay:
        from vit_tpu_torch.cli.train_loop import ema_sidecar

        ema = _detached(params)
        if args.resume and ema_sidecar(args.resume).exists():
            tree = params_from_numpy(ckpt.load_npz(ema_sidecar(args.resume)), device,
                                     torch.float32)
            ema = shard_params(tree, mesh) if splits_params(mesh) else tree
            print(f"resumed EMA from {ema_sidecar(args.resume)}")
        ema_update = trainer.make_ema_update(args.ema_decay)
        print(f"ema: decay {args.ema_decay}")

    stream = _build_data(args, cfg, mesh, device, start_step)
    images = labels = None
    n_static = 0
    if stream is None:
        images, labels = _load_data(args, cfg)
        if len(images) < args.batch:
            raise SetupError(
                f"error: {len(images)} image(s) < --batch {args.batch}; reduce --batch"
            )
        n_static = (len(images) // args.batch) * args.batch  # drop the ragged tail
        images, labels = images[:n_static], labels[:n_static]
    # the stream's producer starts at the loop's first batch: nothing to
    # stop if this raises
    run_eval = _build_eval(args, cfg, mesh, device) if args.eval_data_dir else None
    return TrainSetup(
        cfg=cfg, device=device, ops_name=ops_name, step=step, params=params,
        optimizer=optimizer, trained=trained, lr_at=lr_at, stream=stream, images=images,
        labels=labels, n_static=n_static, run_eval=run_eval, mesh=mesh, start_step=start_step, guard=guard,
        ema=ema, ema_update=ema_update, schedule=schedule,
    )

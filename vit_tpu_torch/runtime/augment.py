"""Data augmentation inside the train step (flip, random-resized crop,
mixup, cutmix) — counterpart of ``vit_tpu.runtime.augment``, in plain
torch on the images' device.

torch cannot draw what ``jax.random`` draws, so each transform takes its
draws as arguments (a seam, as ``models/mae.masks_from_noise`` takes MAE's
noise), and a drawing function beside it makes them from a host
``torch.Generator``: the flip bits, the crop's area, log aspect ratio and
position, mixup's λ, cutmix's λ and box centre, and the coin between mixup
and cutmix.  Given the same draws, each transform computes what the JAX
package's does: flip, mixup, cutmix and the soft targets in the same fp32
operations, the crop through the weight matrices of
``jax.image.scale_and_translate(..., method="linear")`` applied in fp32
with TF32 off.  The draws are a few numbers per image, made on the host
and copied to the device in one copy before the first transform's kernels
are queued: a copy from pageable host memory waits for the device's
queue, and the step needs no read-back from the device to choose a
branch.

Images are (B, C, H, W); the targets are soft rows (B, K).
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, Sequence, Tuple

import torch
import torch.nn.functional as F

_EPS32 = float(torch.finfo(torch.float32).eps)


@contextlib.contextmanager
def _no_tf32():
    """fp32 matmuls in full fp32 on the card inside the block."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


@functools.lru_cache(maxsize=None)
def _arange(n: int, device: torch.device) -> torch.Tensor:
    """0, 1, ..., n - 1 in fp32 on ``device``, made once per (n, device)."""
    return torch.arange(n, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _frame(h: int, w: int, device: torch.device) -> torch.Tensor:
    """[[h], [w]] in fp32 on ``device`` (a column: one row per axis), made
    once per (h, w, device)."""
    return torch.tensor([[h], [w]], dtype=torch.float32).to(device)


def soft_targets(labels: torch.Tensor, num_classes: int,
                 label_smoothing: float = 0.0) -> torch.Tensor:
    """Int labels (B,) -> fp32 rows (B, num_classes), smoothed by eps/K on
    every class; soft rows (B, K) pass through unsmoothed (their producer
    owns the distribution)."""
    if labels.dim() == 2:
        return labels.float()
    y = F.one_hot(labels.long(), num_classes).float()
    if label_smoothing:
        eps = float(label_smoothing)
        y = y * (1.0 - eps) + eps / num_classes
    return y


def flip_draws(gen: torch.Generator, batch: int) -> torch.Tensor:
    """Bernoulli(1/2) per image: which to flip."""
    return torch.rand(batch, generator=gen) < 0.5


def random_flip(images: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of the images whose ``flip`` bit (or nonzero) is set."""
    return torch.where(flip.to(images.device, torch.bool)[:, None, None, None], images.flip(-1),
                       images)


def crop_draws(gen: torch.Generator, batch: int, scale: Tuple[float, float] = (0.3, 1.0),
               ratio: Tuple[float, float] = (3 / 4, 4 / 3)) -> tuple:
    """-> (area (B,) uniform in ``scale``, log aspect (B,) uniform in
    log(``ratio``), position (B, 2) uniform in [0, 1)), fp32."""
    area = scale[0] + (scale[1] - scale[0]) * torch.rand(batch, generator=gen)
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    log_r = lo + (hi - lo) * torch.rand(batch, generator=gen)
    return area, log_r, torch.rand(batch, 2, generator=gen)


def linear_weights(n: int, scale: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """(B, n in, n out) fp32: per image, the weights of
    ``jax.image.scale_and_translate``'s linear resampling of an axis of
    ``n`` samples onto ``n`` (``compute_weight_mat``): a triangle kernel at
    the sample centres (i + 0.5)/s - t/s - 0.5, each output's weights
    normalised to sum to 1, and zero where the sample falls outside
    [-0.5, n - 0.5].  At scale >= 1 (a crop) the kernel is not widened."""
    idx = _arange(n, scale.device)
    inv = 1.0 / scale
    sample = (idx[None, :] + 0.5) * inv[:, None] - (translation * inv)[:, None] - 0.5
    w = torch.clamp(1.0 - (sample[:, None, :] - idx[None, :, None]).abs(), min=0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n - 0.5)
    return torch.where(inside[:, None, :], w, torch.zeros_like(w))


def random_resized_crop(images: torch.Tensor, area: torch.Tensor, log_r: torch.Tensor,
                        pos: torch.Tensor) -> torch.Tensor:
    """Per image, the crop of area fraction ``area`` and aspect
    exp(``log_r``) (its sides clipped to [1, H] and [1, W]) at fractional
    position ``pos``, resized back to (H, W) bilinearly: the two per-image
    weight matrices of :func:`linear_weights` applied in fp32 (the two
    axes' matrices in one call on a square frame)."""
    b, _, h, w = images.shape
    dev = images.device
    area, log_r, pos = (t.to(dev, torch.float32) for t in (area, log_r, pos))
    aspect = torch.exp(log_r)  # crop width / crop height, relative to the frame
    frame = _frame(h, w, dev)
    # the crop's (height, width) and (top, left), one row per axis
    side = torch.minimum(
        (torch.sqrt(torch.stack([area / aspect, area * aspect])) * frame).clamp_min(1.0), frame)
    offset = pos.t() * (frame - side)
    # output row y samples input row y / scale + top: scale H/crop_h and
    # translation -top * scale, as the JAX package passes them
    scale = frame / side
    trans = -offset * scale
    if h == w:
        wy, wx = linear_weights(h, scale.reshape(-1), trans.reshape(-1)).split(b)
    else:
        wy, wx = linear_weights(h, scale[0], trans[0]), linear_weights(w, scale[1], trans[1])
    with _no_tf32():
        rows = torch.einsum("bchw,bwx->bchx", images.float(), wx)
        out = torch.einsum("bchx,bhy->bcyx", rows, wy)
    return out.to(images.dtype)


def beta_draw(gen: torch.Generator, alpha: float) -> torch.Tensor:
    """λ ~ Beta(alpha, alpha), a 0-d fp32 tensor on the host: two gamma
    draws from ``gen`` in float64 (``torch.distributions.Beta`` takes no
    generator)."""
    g = torch._standard_gamma(torch.full((2,), float(alpha), dtype=torch.float64), generator=gen)
    return (g[0] / (g[0] + g[1])).to(torch.float32)


def mixup(images: torch.Tensor, targets: torch.Tensor, lam: torch.Tensor):
    """The convex combination, weight ``lam`` (a 0-d fp32 tensor), of the
    batch with its reverse, images and soft targets alike."""
    lam = lam.to(torch.float32)
    mixed_x = lam * images + (1.0 - lam) * images.flip(0)
    mixed_y = lam * targets + (1.0 - lam) * targets.flip(0)
    return mixed_x.to(images.dtype), mixed_y


def cutmix_draws(gen: torch.Generator, alpha: float, h: int, w: int) -> tuple:
    """-> (λ ~ Beta(alpha, alpha), box centre row cy in [0, h), column cx
    in [0, w)), 0-d fp32 tensors on the host."""
    lam = beta_draw(gen, alpha)
    u = torch.rand(2, generator=gen)
    return lam, u[0] * h, u[1] * w


def cutmix(images: torch.Tensor, targets: torch.Tensor, lam: torch.Tensor, cy: torch.Tensor,
           cx: torch.Tensor):
    """Paste the box of side fraction sqrt(1 - ``lam``) centred at (``cy``,
    ``cx``), clipped to the frame, from the reversed batch; the targets mix
    by the pasted fraction of the frame after clipping."""
    _, _, h, w = images.shape
    lam, cy, cx = (torch.as_tensor(t, dtype=torch.float32) for t in (lam, cy, cx))
    cut = torch.sqrt(1.0 - lam)
    y0, y1 = torch.clamp(cy - cut * h / 2, 0, h), torch.clamp(cy + cut * h / 2, 0, h)
    x0, x1 = torch.clamp(cx - cut * w / 2, 0, w), torch.clamp(cx + cut * w / 2, 0, w)
    # the box on the images' device, from the host's scalars
    ys, xs = _arange(h, images.device), _arange(w, images.device)
    in_box = ((ys >= y0) & (ys < y1))[:, None] & ((xs >= x0) & (xs < x1))[None, :]
    mixed_x = torch.where(in_box[None, None], images.flip(0), images)
    # the pasted fraction as XLA computes the JAX package's mean: the count
    # times the fp32 reciprocal of the pixel count
    frac = in_box.sum().float() * (1.0 / (h * w))
    mixed_y = (1.0 - frac) * targets + frac * targets.flip(0)
    return mixed_x.to(images.dtype), mixed_y


def make_augment_fn(
    names: Sequence[str],
    num_classes: int,
    label_smoothing: float = 0.0,
    mixup_alpha: float = 0.2,
    cutmix_alpha: float = 1.0,
    crop_scale: Tuple[float, float] = (0.3, 1.0),
) -> Callable:
    """Compose named transforms into ``(gen, images, labels) -> (images,
    soft targets)``, ``gen`` a host ``torch.Generator`` that every draw
    comes from, in order: the crop's, the flips, the coin (mixup when
    < 1/2) when both mixup and cutmix are named, then the mix's.  ``names``
    ⊆ {flip, crop, mixup, cutmix}; refused as the JAX package refuses them."""
    names = list(names)
    known = {"flip", "crop", "mixup", "cutmix"}
    bad = set(names) - known
    if bad:
        raise ValueError(f"unknown augmentation(s) {sorted(bad)}; "
                         f"choose from {sorted(known)}")
    # Beta(a, a) with a <= 0 has no samples: fail at config time
    if "mixup" in names and not mixup_alpha > 0.0:
        raise ValueError(
            f"mixup_alpha must be > 0 (got {mixup_alpha}); to disable "
            "mixup, drop 'mixup' from the augmentation list instead"
        )
    if "cutmix" in names and not cutmix_alpha > 0.0:
        raise ValueError(
            f"cutmix_alpha must be > 0 (got {cutmix_alpha}); to disable "
            "cutmix, drop 'cutmix' from the augmentation list instead"
        )
    has_mix, has_cut = "mixup" in names, "cutmix" in names

    def fn(gen: torch.Generator, images: torch.Tensor, labels: torch.Tensor):
        b, _, h, w = images.shape
        # every draw first, and the per-image ones onto the device in one
        # copy while its queue holds none of this step's kernels
        per_image = []
        if "crop" in names:
            area, log_r, pos = crop_draws(gen, b, crop_scale)
            per_image += [area, log_r, pos.reshape(-1)]
        if "flip" in names:
            per_image.append(flip_draws(gen, b).float())
        crop = flip = None
        if per_image:
            drawn = list(torch.cat(per_image).to(images.device).split(
                [t.numel() for t in per_image]))
            if "crop" in names:
                crop, drawn = (drawn[0], drawn[1], drawn[2].view(b, 2)), drawn[3:]
            if "flip" in names:
                flip = drawn[0]
        use_mix, use_cut = has_mix, has_cut
        if has_mix and has_cut:
            use_mix = bool(torch.rand((), generator=gen) < 0.5)
            use_cut = not use_mix
        mix = (beta_draw(gen, mixup_alpha) if use_mix
               else cutmix_draws(gen, cutmix_alpha, h, w) if use_cut else None)
        y = soft_targets(labels, num_classes, label_smoothing)
        if crop is not None:
            images = random_resized_crop(images, *crop)
        if flip is not None:
            images = random_flip(images, flip)
        if use_mix:
            images, y = mixup(images, y, mix)
        elif use_cut:
            images, y = cutmix(images, y, *mix)
        return images, y

    return fn

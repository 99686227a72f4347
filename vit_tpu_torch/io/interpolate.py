"""Position-embedding interpolation for resolution transfer — counterpart
of ``vit_tpu.io.interpolate``.

A ViT trained at 224 px has a (197, D) position table; running it at 384
px needs (577, D).  torchvision's ``interpolate_embeddings`` bicubic-resizes
the patch-grid part of the table and passes the prefix rows (CLS, and
DeiT's distillation token) through.  ``method="bicubic"`` is torch's
bicubic exactly: the Keys kernel with a = -0.75, taps clamped to the edge,
``align_corners=True``, as one (n_out, n_in) weight matrix per axis built
in float64, cast to fp32 and contracted in fp32.

Every other method is what the JAX package hands to ``jax.image.resize``:
half-pixel-centred separable weights (``nearest``; ``linear`` and its
aliases, a triangle; ``cubic``, Keys with a = -0.5; ``lanczos3``,
``lanczos5``), normalised per output sample and, when shrinking, widened
by the scale (antialiasing).  The weight matrices here are that
function's, computed in fp32 as it computes them; ``nearest`` picks
``floor((j + 0.5) n_in / n_out)``.  numpy only: the tree is adapted on the
host before an engine places it on a device.
"""

from __future__ import annotations

import numpy as np

from vit_tpu_torch.config import ViTConfig

# jax.image.resize's names for its methods (jax/_src/image/scale.py's
# ResizeMethod.from_string); "bicubic" is the torch-exact path above
_JAX_METHODS = {
    "nearest": "nearest",
    **{name: "linear" for name in ("linear", "bilinear", "trilinear", "triangle")},
    "lanczos3": "lanczos3",
    "lanczos5": "lanczos5",
    **{name: "cubic" for name in ("cubic", "tricubic")},
}


def _cubic_kernel(s: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel; a = -0.75 is torch's constant."""
    s = np.abs(s)
    near = (a + 2.0) * s**3 - (a + 3.0) * s**2 + 1.0
    far = a * s**3 - 5.0 * a * s**2 + 8.0 * a * s - 4.0 * a
    return np.where(s <= 1.0, near, np.where(s < 2.0, far, 0.0))


def _bicubic_matrix(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    """(n_out, n_in) float64 weights of torch's
    ``F.interpolate(mode="bicubic")`` along one axis; a tap past the edge
    adds its weight to the edge sample (torch's clamp)."""
    j = np.arange(n_out, dtype=np.float64)
    if align_corners:
        x = j * ((n_in - 1) / (n_out - 1)) if n_out > 1 else np.zeros_like(j)
    else:
        x = (j + 0.5) * (n_in / n_out) - 0.5
    x0 = np.floor(x)
    t = x - x0
    w = np.zeros((n_out, n_in), np.float64)
    for m in (-1, 0, 1, 2):
        idx = np.clip(x0 + m, 0, n_in - 1).astype(np.int64)
        np.add.at(w, (np.arange(n_out), idx), _cubic_kernel(t - m))
    return w


def _resize_kernel(method: str, x: np.ndarray) -> np.ndarray:
    """jax.image.resize's kernels on fp32 distances ``x >= 0``."""
    if method == "linear":
        return np.maximum(np.float32(0), 1 - np.abs(x))
    if method == "cubic":  # Keys, a = -0.5
        out = ((1.5 * x - 2.5) * x) * x + 1.0
        out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
        return np.where(x >= 2.0, 0.0, out).astype(np.float32)
    radius = np.float32(3.0 if method == "lanczos3" else 5.0)
    y = radius * np.sin(np.float32(np.pi) * x) * np.sin(np.float32(np.pi) * x / radius)
    safe = np.where(x != 0, np.float32(np.pi ** 2) * x * x, np.float32(1))
    out = np.where(x > 1e-3, y / safe, np.float32(1))
    return np.where(x > radius, np.float32(0), out).astype(np.float32)


def resize_matrix(n_in: int, n_out: int, method: str) -> np.ndarray:
    """(n_out, n_in) fp32 weights of ``jax.image.resize(method=...,
    antialias=True)`` along one axis of n_in -> n_out samples."""
    if n_in == n_out:
        return np.eye(n_out, dtype=np.float32)
    if method == "nearest":
        src = np.floor(((np.arange(n_out, dtype=np.float32) + 0.5) * n_in / n_out)
                       .astype(np.float32)).astype(np.int64)
        w = np.zeros((n_out, n_in), np.float32)
        w[np.arange(n_out), src] = 1.0
        return w
    scale = np.float32(n_out / n_in)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))  # widened when shrinking
    sample = (np.arange(n_out, dtype=np.float32) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = _resize_kernel(method, x.astype(np.float32))  # (n_in, n_out)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).T.astype(np.float32)


def _resize_grid(grid: np.ndarray, wh: np.ndarray, ww: np.ndarray) -> np.ndarray:
    """(H, W, D) fp32 through the per-axis matrices, contracted in fp32."""
    g = np.einsum("oh,hwd->owd", wh, grid)
    return np.einsum("ow,hwd->hod", ww, g)


def bicubic_resize_grid(grid, to_hw: tuple, align_corners: bool = True) -> np.ndarray:
    """(H, W, D) -> (to_h, to_w, D) fp32, torch's bicubic."""
    h, w, _ = grid.shape
    th, tw = to_hw
    wh = _bicubic_matrix(h, th, align_corners).astype(np.float32)
    ww = _bicubic_matrix(w, tw, align_corners).astype(np.float32)
    return _resize_grid(np.asarray(grid, np.float32), wh, ww)


def interpolate_pos_embed(pos_embed, from_grid: int, to_grid: int, method: str = "bicubic",
                          num_prefix_tokens: int = 1):
    """(P + from_grid², D) -> (P + to_grid², D); the P prefix rows pass
    through.  ``pos_embed`` is a numpy array or a CPU tensor, and the result
    is the same kind, in its dtype."""
    t, d = pos_embed.shape
    p = num_prefix_tokens
    if t != p + from_grid * from_grid:
        raise ValueError(
            f"pos_embed has {t} rows, expected {p + from_grid * from_grid} "
            f"({p} prefix + {from_grid}x{from_grid} grid)"
        )
    if from_grid == to_grid:
        return pos_embed
    if method != "bicubic" and method not in _JAX_METHODS:
        raise ValueError(f'Unknown resize method "{method}"')
    is_tensor = hasattr(pos_embed, "detach")
    table = pos_embed.detach().cpu().float().numpy() if is_tensor \
        else np.asarray(pos_embed, np.float32)
    grid = table[p:].reshape(from_grid, from_grid, d)
    if method == "bicubic":
        resized = bicubic_resize_grid(grid, (to_grid, to_grid))
    else:
        w = resize_matrix(from_grid, to_grid, _JAX_METHODS[method])
        resized = _resize_grid(grid, w, w)
    out = np.concatenate([table[:p], resized.reshape(to_grid * to_grid, d)], axis=0)
    if is_tensor:
        import torch

        return torch.from_numpy(np.ascontiguousarray(out)).to(pos_embed.dtype)
    return out.astype(np.asarray(pos_embed).dtype)


def adapt_params_resolution(params, from_cfg: ViTConfig, to_cfg: ViTConfig,
                            method: str = "bicubic"):
    """Re-target a params tree to another image resolution (the same patch
    size and everything else: only the position table changes)."""
    if (from_cfg.patch_size, from_cfg.embed_dim, from_cfg.depth, from_cfg.distilled) != (
            to_cfg.patch_size, to_cfg.embed_dim, to_cfg.depth, to_cfg.distilled):
        raise ValueError("resolution transfer requires matching architecture")
    out = dict(params)
    out["pos_embed"] = interpolate_pos_embed(
        params["pos_embed"], from_cfg.grid_size, to_cfg.grid_size, method,
        num_prefix_tokens=from_cfg.num_prefix_tokens,
    )
    return out

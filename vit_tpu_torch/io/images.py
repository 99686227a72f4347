"""Image batches — counterpart of ``vit_tpu.io.images``: the reference's
``input-100.bin`` format (4 x int32 little-endian header ``(n, c, h, w)``,
then ``n*c*h*w`` fp32 values in NCHW order) and the seeded synthetic batch
that stands in for it."""

from __future__ import annotations

import numpy as np


def load_image_bin(path) -> np.ndarray:
    """Read an input-100.bin-format file -> (N, C, H, W) float32."""
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype="<i4", count=4)
        if header.size != 4:
            raise ValueError(f"{path}: truncated header (Network.c:36-44 format)")
        n, c, h, w = (int(v) for v in header)
        if min(n, c, h, w) < 0:
            raise ValueError(f"{path}: negative header field ({n}, {c}, {h}, {w})")
        data = np.fromfile(f, dtype="<f4", count=n * c * h * w)
    if data.size != n * c * h * w:
        raise ValueError(f"{path}: expected {n * c * h * w} fp32 values, got {data.size}")
    return data.reshape(n, c, h, w)


def synth_images(n: int, cfg, seed: int = 0) -> np.ndarray:
    """Seeded (n, C, H, W) float32 batch with preprocessed-ImageNet-like
    statistics — the JAX package's ``synth_images`` draw for draw."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, (n, cfg.in_channels, cfg.image_size, cfg.image_size))
    return x.astype(np.float32)

"""Image batches — counterpart of ``vit_tpu.io.images``: the reference's
``input-100.bin`` format (4 x int32 little-endian header ``(n, c, h, w)``,
then ``n*c*h*w`` fp32 values in NCHW order), read from a file or from memory
(the serving daemon's request body) and written (``save_image_bin``), the
seeded synthetic batch that stands in for it, and the torchvision-eval
normalization of raw uint8 images (``preprocess``)."""

from __future__ import annotations

import numpy as np

from vit_tpu_torch.io.preprocess import IMAGENET_MEAN, IMAGENET_STD


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


def parse_image_bytes(data: bytes) -> np.ndarray:
    """In-memory variant of :func:`load_image_bin` (an HTTP request body in
    the serving daemon): the same int32[4]-header + fp32-NCHW wire format.
    A short or inconsistent body raises ``ValueError``."""
    # length-check before frombuffer, whose own errors for short or ragged
    # bodies would mask the format message
    if len(data) < 16:
        raise ValueError("truncated header (Network.c:36-44 format)")
    n, c, h, w = (int(v) for v in np.frombuffer(data, dtype="<i4", count=4))
    if min(n, c, h, w) < 0:
        raise ValueError(f"negative header field ({n}, {c}, {h}, {w})")
    want = n * c * h * w
    if len(data) - 16 != 4 * want:
        raise ValueError(
            f"expected {want} fp32 values ({4 * want} bytes), got {len(data) - 16} bytes"
        )
    body = np.frombuffer(data, dtype="<f4", offset=16, count=want)
    return body.reshape(n, c, h, w).copy()


def synth_images(n: int, cfg, seed: int = 0) -> np.ndarray:
    """Seeded (n, C, H, W) float32 batch with preprocessed-ImageNet-like
    statistics — the JAX package's ``synth_images`` draw for draw."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, (n, cfg.in_channels, cfg.image_size, cfg.image_size))
    return x.astype(np.float32)


def save_image_bin(images: np.ndarray, path) -> None:
    """Write (N, C, H, W) float32 in the reference's binary format."""
    images = np.asarray(images, dtype="<f4")
    n, c, h, w = images.shape
    with open(path, "wb") as f:
        np.array([n, c, h, w], dtype="<i4").tofile(f)
        images.tofile(f)


def preprocess(raw_uint8: np.ndarray) -> np.ndarray:
    """torchvision-eval normalization of (N, H, W, C) uint8 [0, 255] ->
    (N, C, H, W) float32, for callers feeding images already cropped to
    size (the reference does this offline before writing input-100.bin)."""
    x = raw_uint8.astype(np.float32) / 255.0
    x = (x - IMAGENET_MEAN) / IMAGENET_STD
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2))

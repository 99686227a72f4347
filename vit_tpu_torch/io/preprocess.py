"""Raw images -> model-ready NCHW batches: torchvision's ``vit_b_16`` eval
transform, as ``vit_tpu.io.preprocess`` computes it (counterpart, numpy
and PIL): resize the shorter side to ``image_size * 256 // 224`` with
bilinear resampling (the long side truncates), center-crop ``image_size``
(offset ``int(round(diff / 2))``), scale to [0, 1] and normalize with the
ImageNet mean and std.  ``mode="train"`` resizes the full frame to
``image_size`` square instead (no crop), and ``folder_dataset`` indexes an
ImageNet-style folder-per-class tree (``io/dataset.ImageFolderDataset``)."""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
IMAGE_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp"}


class PreprocessError(RuntimeError):
    pass


def preprocess_image(source, image_size: int, resize_size: int | None = None,
                     mean: np.ndarray = IMAGENET_MEAN, std: np.ndarray = IMAGENET_STD,
                     mode: str = "eval") -> np.ndarray:
    """One image file, PIL image or HWC uint8 array -> (3, S, S) float32.
    ``mode="eval"``: the eval transform above; ``mode="train"``: the full
    frame resized to (S, S) with bilinear resampling, nothing cropped (the
    JAX package's on-device RandomResizedCrop samples from the whole
    image)."""
    if mode not in ("eval", "train"):
        raise ValueError(f"mode {mode!r}: need 'eval' or 'train'")
    if mode == "train" and resize_size is not None:
        raise ValueError(
            "resize_size is an eval-transform knob; mode='train' "
            "stages the full frame at image_size (the on-device "
            "RandomResizedCrop does the cropping)"
        )
    try:
        from PIL import Image
    except ImportError as e:
        raise PreprocessError(
            "raw-image preprocessing needs Pillow (PIL); or preprocess offline "
            "into the input-100.bin format"
        ) from e
    if resize_size is None:
        resize_size = image_size * 256 // 224
    if isinstance(source, np.ndarray):
        img = Image.fromarray(source)
    elif isinstance(source, (str, Path)):
        img = Image.open(source)
    else:
        img = source
    img = img.convert("RGB")
    if mode == "train":
        img = img.resize((image_size, image_size), Image.Resampling.BILINEAR)
    else:
        w, h = img.size
        if w <= h:
            new_w, new_h = resize_size, int(resize_size * h / w)
        else:
            new_w, new_h = int(resize_size * w / h), resize_size
        img = img.resize((new_w, new_h), Image.Resampling.BILINEAR)
        left = int(round((new_w - image_size) / 2.0))
        top = int(round((new_h - image_size) / 2.0))
        if left < 0 or top < 0:
            raise PreprocessError(f"crop {image_size} exceeds resized image {new_w}x{new_h}")
        img = img.crop((left, top, left + image_size, top + image_size))
    arr = (np.asarray(img, np.float32) / 255.0 - mean) / std
    return np.ascontiguousarray(arr.transpose(2, 0, 1))


def collect_image_paths(sources: Iterable[str]) -> list[Path]:
    """Files, and the image files of directories (sorted, not recursive)."""
    out: list[Path] = []
    for s in sources:
        p = Path(s)
        if p.is_dir():
            out.extend(sorted(q for q in p.iterdir() if q.suffix.lower() in IMAGE_EXTENSIONS))
        elif p.exists():
            out.append(p)
        else:
            raise FileNotFoundError(f"no such image file or directory: {s}")
    if not out:
        raise PreprocessError(f"no image files found under {list(sources)}")
    return out


def load_and_preprocess(sources: Sequence[str], cfg, resize_size: int | None = None):
    """Files/dirs -> ((N, 3, S, S) float32 batch, per-row source names)."""
    paths = collect_image_paths(sources)
    batch = np.stack([preprocess_image(p, cfg.image_size, resize_size) for p in paths])
    return batch, [str(p) for p in paths]


def folder_dataset(root) -> tuple[list[Path], np.ndarray, list[str]]:
    """ImageNet-style folder-per-class layout (torchvision's ImageFolder
    convention): ``root/<class>/<image>``, classes indexed by the sorted
    subdirectory names.  -> (paths, int32 labels, class names)."""
    root = Path(root)
    classes = sorted(d.name for d in root.iterdir() if d.is_dir())
    if not classes:
        raise PreprocessError(f"no class subdirectories under {root}")
    paths: list[Path] = []
    labels: list[int] = []
    for idx, name in enumerate(classes):
        files = sorted(q for q in (root / name).iterdir()
                       if q.suffix.lower() in IMAGE_EXTENSIONS)
        paths.extend(files)
        labels.extend([idx] * len(files))
    if not paths:
        raise PreprocessError(f"no image files under {root}/<class>/")
    return paths, np.asarray(labels, np.int32), classes

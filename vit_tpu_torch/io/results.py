"""What the classify CLI writes: one ``[i] label: L / prob: P`` line per
image (the reference program's format, Main.c:71, which
``vit_tpu_torch.eval.comparator`` parses and gates) and the class names
printed beside them (``vit_tpu.io.labels``'s resolution order)."""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List, Optional, Sequence

# the JAX package's ImageNet-1k name table, read in place (a data file, not a module)
PACKAGED_LABELS = Path(__file__).resolve().parents[2] / "vit_tpu" / "io" / "data" / "imagenet_labels.txt"


def format_result_line(index: int, label: int, prob: float) -> str:
    return f"[{index}] label: {label} / prob: {prob:.6f}"


def write_result_file(labels: Sequence[int], probs: Sequence[float], path) -> None:
    Path(path).write_text("".join(
        format_result_line(i, int(l), float(p)) + "\n" for i, (l, p) in enumerate(zip(labels, probs))
    ))


def load_labels(path: Optional[str] = None, num_classes: int = 1000) -> List[str]:
    """Class names: an explicit text file (one per line) or C source with a
    string-array literal; else the packaged ImageNet-1k table, then
    ``$VIT_TPU_LABELS_SOURCE``, when they cover ``num_classes``; else
    ``class_{i}``."""
    if path is not None:
        labels = _load_source(Path(path))
        if len(labels) >= num_classes:
            return labels[:num_classes]
        raise ValueError(f"{path}: found {len(labels)} labels, need {num_classes}")
    for src in (PACKAGED_LABELS, os.environ.get("VIT_TPU_LABELS_SOURCE")):
        if src and Path(src).exists():
            labels = _load_source(Path(src))
            if len(labels) >= num_classes:
                return labels[:num_classes]
    return [f"class_{i}" for i in range(num_classes)]


def _load_source(p: Path) -> List[str]:
    if p.suffix == ".c":  # the longest brace-delimited array of string literals
        best: List[str] = []
        for m in re.finditer(r"\{((?:\s*\"(?:[^\"\\]|\\.)*\"\s*,?)+)\}", p.read_text(errors="replace")):
            strings = re.findall(r"\"((?:[^\"\\]|\\.)*)\"", m.group(1))
            best = strings if len(strings) > len(best) else best
        return [s.replace('\\"', '"') for s in best]
    return [ln.strip() for ln in p.read_text().splitlines() if ln.strip()]

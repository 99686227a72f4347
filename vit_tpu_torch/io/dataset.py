"""Labeled datasets for training and evaluation — counterpart of
``vit_tpu.io.dataset``: ``EpochStream``, ``BinShardDataset`` and
``ImageFolderDataset``, numpy on the host.

A ``BinShardDataset`` is a directory of ``input-100.bin``-format shards
(4 x int32 header + fp32 NCHW payload, Network.c:24-97), each with an
optional raw little-endian int32 label file ``<stem>.labels.bin``, indexed
once at open and read by sample in shuffled order: a batch scattered
across shards is one call of the native threaded gather reader
(``io/native.py``), or numpy ``memmap`` slices where no compiler built it
(the same bytes).  An ``ImageFolderDataset`` is an ImageNet-style
folder-per-class tree of raw images, decoded and preprocessed in a thread
pool.  Both stream minibatches through ``EpochStream.batches``, whose
permutations are the JAX package's index for index (resume and the
multihost split depend on it); feed them to
``runtime.prefetch.prefetch_to_device`` so reads, host->device copies and
device compute overlap.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from vit_tpu_torch.io import native

_HEADER_BYTES = 16  # 4 x int32: n, c, h, w (Network.c:36-44)


class EpochStream:
    """The shuffled, sharded epoch stream of a dataset exposing ``__len__``,
    ``read(indices)`` and ``_labels``."""

    def batch_indices(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        epochs: Optional[int] = None,
        drop_remainder: bool = True,
        shard: Optional[Tuple[int, int]] = None,
        skip_batches: int = 0,
    ) -> Iterator[np.ndarray]:
        """The sample indices of each minibatch :meth:`batches` yields, in
        order, without reading a sample: a data-parallel rank reads only its
        rows of each.  Arguments as in :meth:`batches`."""
        if shard is not None:
            sid, nsh = shard
            if not (0 <= sid < nsh):
                raise ValueError(f"shard {shard}: need 0 <= i < n")
        else:
            sid, nsh = 0, 1
        local_n = len(self) // nsh
        if batch_size < 1 or batch_size > local_n:
            raise ValueError(f"batch_size {batch_size} not in [1, {local_n}]")
        # the batch count per epoch is a constant of (local_n, batch_size)
        # and each epoch's permutation is seeded on its own, so whole skipped
        # epochs are arithmetic, not discarded permutations
        end = local_n - (local_n % batch_size) if drop_remainder else local_n
        n_batches = -(-end // batch_size)
        to_skip = int(skip_batches)
        epoch = to_skip // n_batches
        to_skip -= epoch * n_batches
        while epochs is None or epoch < epochs:
            if shuffle:
                perm = np.random.default_rng(
                    np.random.SeedSequence([seed, epoch])
                ).permutation(len(self))
            else:
                perm = np.arange(len(self))
            perm = perm[sid::nsh][:local_n]
            for i in range(to_skip * batch_size, end, batch_size):
                yield perm[i : i + batch_size]
            to_skip = 0
            epoch += 1

    def batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        epochs: Optional[int] = None,
        drop_remainder: bool = True,
        shard: Optional[Tuple[int, int]] = None,
        skip_batches: int = 0,
    ) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
        """Yield ``(images, labels_or_None)`` minibatches, reshuffled each
        epoch from ``SeedSequence([seed, epoch])`` (so a resume at epoch e
        is reproducible); ``epochs=None`` streams forever.

        ``shard=(i, n)`` keeps every n-th sample of each epoch's shared
        permutation starting at i — the multi-host split: the hosts' slices
        cover each epoch without overlap, ``batch_size`` is per host, and
        every slice is cut to ``len(ds) // n`` samples so all hosts see the
        same number of batches per epoch.

        ``skip_batches`` fast-forwards past that many minibatches without
        reading them — the resume path: a run resumed at step N with the
        same seed continues on the batches an uninterrupted run sees."""
        for take in self.batch_indices(batch_size, shuffle, seed, epochs, drop_remainder,
                                       shard, skip_batches):
            labs = self._labels[take] if self._labels is not None else None
            yield self.read(take), labs


class BinShardDataset(EpochStream):
    """Index over one or more ``input-100.bin``-format shards.

    Args:
      sources: a directory (every ``*.bin`` except ``*.labels.bin``) or an
        explicit list of shard paths.
      require_labels: insist every shard has a ``<stem>.labels.bin`` (raw
        int32, one per image).
      threads: worker threads of the native gather reader.
      num_classes: when given, reject labels outside [0, num_classes) at
        load (the loss's gather would not fail on them).
    """

    def __init__(
        self,
        sources,
        require_labels: bool = False,
        threads: int = 8,
        num_classes: Optional[int] = None,
    ):
        if isinstance(sources, (str, Path)) and Path(sources).is_dir():
            paths = sorted(
                p for p in Path(sources).glob("*.bin") if not p.name.endswith(".labels.bin")
            )
        else:
            paths = [Path(p) for p in ([sources] if isinstance(sources, (str, Path))
                                       else sources)]
        if not paths:
            raise FileNotFoundError(f"no .bin shards found in {sources!r}")
        self.paths: List[Path] = paths
        self.threads = threads

        shape: Optional[Tuple[int, int, int]] = None
        counts: List[int] = []
        labels: List[Optional[np.ndarray]] = []
        for p in paths:
            hdr = np.fromfile(p, dtype="<i4", count=4)
            if hdr.size != 4 or (hdr < 0).any():
                raise ValueError(f"{p}: truncated header (Network.c:36-44 format)")
            n, c, h, w = (int(v) for v in hdr)
            if shape is None:
                shape = (c, h, w)
            elif shape != (c, h, w):
                raise ValueError(f"{p}: shard shape {(c, h, w)} != first shard {shape}")
            expect = _HEADER_BYTES + 4 * n * c * h * w
            actual = p.stat().st_size
            if actual < expect:
                raise ValueError(f"{p}: {actual} bytes < expected {expect}")
            counts.append(n)
            lp = p.with_name(p.stem + ".labels.bin")
            if lp.exists():
                lab = np.fromfile(lp, dtype="<i4")
                if len(lab) != n:
                    raise ValueError(f"{lp}: {len(lab)} labels != {n} images")
                if num_classes is not None and lab.size and (
                    lab.min() < 0 or lab.max() >= num_classes
                ):
                    raise ValueError(
                        f"{lp}: labels outside [0, {num_classes}) "
                        f"(min {lab.min()}, max {lab.max()})"
                    )
                labels.append(lab)
            elif require_labels:
                raise FileNotFoundError(f"{lp} (require_labels=True)")
            else:
                labels.append(None)
        assert shape is not None
        self.sample_shape: Tuple[int, int, int] = shape
        self.sample_bytes = 4 * int(np.prod(shape))
        self.counts = counts
        # global index: sample i -> (shard, byte offset), shard-major order
        # (keeps the native reader's per-worker file reopens rare)
        self._shard_of = np.repeat(np.arange(len(paths), dtype=np.int32), counts)
        within = np.concatenate([np.arange(n, dtype=np.int64) for n in counts])
        self._offset_of = _HEADER_BYTES + within * self.sample_bytes
        have = [lab is not None for lab in labels]
        if any(have) and not all(have):
            missing = [str(paths[i]) for i, h in enumerate(have) if not h]
            raise ValueError(
                "some shards have .labels.bin files and some don't "
                f"(missing for: {missing}); label a shard set consistently "
                "— silently dropping the labeled shards' labels would "
                "train/evaluate unlabeled"
            )
        self._labels = np.concatenate(labels).astype(np.int32) if all(have) else None
        self._mmaps: List[Optional[np.memmap]] = [None] * len(paths)

    def __len__(self) -> int:
        return int(sum(self.counts))

    @property
    def has_labels(self) -> bool:
        return self._labels is not None

    def labels(self) -> np.ndarray:
        if self._labels is None:
            raise ValueError("dataset has no .labels.bin files")
        return self._labels

    def read(self, indices: Sequence[int]) -> np.ndarray:
        """(len(indices), C, H, W) float32 — the native threaded gather when
        the reader is built, memmap slices otherwise (the same bytes)."""
        idx = np.asarray(indices, dtype=np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= len(self)):
            raise IndexError(f"index out of range 0..{len(self) - 1}")
        # sort by (shard, offset) for sequential IO; undo afterwards
        order = np.lexsort((self._offset_of[idx], self._shard_of[idx]))
        sidx = idx[order]
        if native.gather_available():
            flat = native.gather_read(
                [str(p) for p in self.paths], self._shard_of[sidx], self._offset_of[sidx],
                self.sample_bytes, threads=self.threads,
            )
            out = flat.view("<f4").reshape(len(sidx), *self.sample_shape)
        else:
            out = np.empty((len(sidx), *self.sample_shape), np.float32)
            for j, i in enumerate(sidx):
                out[j] = self._mmap(int(self._shard_of[i]))[
                    int(self._offset_of[i] - _HEADER_BYTES) // self.sample_bytes
                ]
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        return np.ascontiguousarray(out[inv])

    def _mmap(self, shard: int) -> np.memmap:
        if self._mmaps[shard] is None:
            self._mmaps[shard] = np.memmap(
                self.paths[shard], dtype="<f4", mode="r", offset=_HEADER_BYTES,
                shape=(self.counts[shard], *self.sample_shape),
            )
        return self._mmaps[shard]


class ImageFolderDataset(EpochStream):
    """An ImageNet-style folder-per-class tree of raw image files
    (``root/<class>/<image>``, classes the sorted subdirectory names).
    ``read`` decodes and preprocesses in a thread pool (``io/preprocess.py``):
    ``mode='eval'`` the torchvision eval transform, ``mode='train'`` the
    full frame resized to ``image_size``."""

    def __init__(self, root, image_size: int, threads: int = 8,
                 resize_size: Optional[int] = None, mode: str = "eval"):
        from concurrent.futures import ThreadPoolExecutor

        from vit_tpu_torch.io.preprocess import folder_dataset

        if mode == "train" and resize_size is not None:
            raise ValueError(
                "resize_size is an eval-transform knob; mode='train' "
                "stages the full frame at image_size (the on-device "
                "RandomResizedCrop does the cropping)"
            )
        self.paths, self._labels, self.class_names = folder_dataset(root)
        self.image_size = image_size
        self.resize_size = resize_size
        self.mode = mode
        self.sample_shape = (3, image_size, image_size)
        self._pool = ThreadPoolExecutor(max(threads, 1))

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def has_labels(self) -> bool:
        return True

    def labels(self) -> np.ndarray:
        return self._labels

    def read(self, indices: Sequence[int]) -> np.ndarray:
        from vit_tpu_torch.io.preprocess import preprocess_image

        idx = np.asarray(indices, dtype=np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= len(self)):
            raise IndexError(f"index out of range 0..{len(self) - 1}")
        return np.stack(list(self._pool.map(
            lambda i: preprocess_image(self.paths[i], self.image_size, self.resize_size,
                                       mode=self.mode),
            idx,
        )))

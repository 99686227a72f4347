"""Process-group initialization — counterpart of ``vit_tpu.runtime.distributed``.

The JAX package calls ``jax.distributed.initialize`` once per host; the
port runs one process per rank (``torchrun`` sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``)
and joins them with ``torch.distributed.init_process_group``.

The backend is chosen explicitly and reported: ``nccl`` when every rank
of this host has a card of its own; ``gloo`` on the CPU, and when the
caller asks for it — gloo is also what lets two ranks share one card,
which NCCL refuses.  Ranks that would share a card without the caller
asking for gloo raise; nothing falls back to another backend.
"""

from __future__ import annotations

import atexit
import os
from typing import Optional

import torch
import torch.distributed as dist

_initialized = False
_initialized_explicit = False


def local_world_size() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))


def choose_backend(backend: Optional[str] = None, device_type: str = "cuda") -> str:
    """``backend`` when given ('nccl' or 'gloo'); else 'gloo' for CPU ranks
    and 'nccl' where every rank of this host has a card of its own.  Ranks
    that would share a card raise unless the caller asks for 'gloo'."""
    if backend is not None:
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"backend {backend!r} not in ('nccl', 'gloo')")
        if backend == "nccl" and device_type != "cuda":
            raise ValueError("backend 'nccl' needs CUDA ranks")
        return backend
    if device_type != "cuda":
        return "gloo"
    cards, ranks = torch.cuda.device_count(), local_world_size()
    if cards < ranks:
        raise RuntimeError(
            f"{ranks} rank(s) on this host share {cards} card(s): NCCL refuses two ranks on "
            "one GPU; ask for backend 'gloo' to share a card"
        )
    return "nccl"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device_type: str = "cuda",
) -> Optional[str]:
    """Join this process to its ranks.  With no arguments the cluster comes
    from ``torchrun``'s environment (``env://``); elsewhere pass
    ``coordinator_address`` ('host:port'), ``num_processes`` and
    ``process_id``.  Idempotent.  -> the backend, or None when this is a
    single process.

    With nothing passed and no cluster in the environment this is a no-op:
    one process, no process group, and every parallel path runs in its
    single-process form.  Explicit cluster arguments after such an
    argument-less call raise: silently ignoring them would leave this rank
    alone while its peers wait for it."""
    global _initialized, _initialized_explicit
    explicit = bool(coordinator_address or num_processes or process_id is not None)
    if _initialized:
        if explicit and not _initialized_explicit and not dist.is_initialized():
            raise RuntimeError(
                "distributed.initialize already ran (single-process); "
                "explicit cluster args came too late — call initialize "
                "with them before any other use"
            )
        return dist.get_backend() if dist.is_initialized() else None
    if explicit:
        if not coordinator_address or num_processes is None or process_id is None:
            raise ValueError("explicit initialize needs coordinator_address, num_processes "
                             "and process_id")
        chosen = choose_backend(backend, device_type)
        dist.init_process_group(chosen, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    elif "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        chosen = choose_backend(backend, device_type)
        dist.init_process_group(chosen, init_method="env://")
    else:
        chosen = None  # no cluster: a single process
    if chosen is not None:
        # a group left to the interpreter's exit can abort the process
        # ("terminate called without an active exception") after its work
        # is done; destroy it first
        atexit.register(_destroy)
    _initialized = True
    _initialized_explicit = explicit
    return chosen


def _destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()

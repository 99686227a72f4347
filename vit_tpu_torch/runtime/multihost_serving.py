"""Multi-process serving: lockstep tick dispatch — counterpart of
``vit_tpu.runtime.multihost_serving``.

``runtime/serving.py``'s server coalesces requests freely because one
process (or, over a mesh, one lead rank) owns the queue.  Here every rank
takes its own requests: every rank runs a ``LockstepServer`` over the same
mesh engine, and on each tick every front end contributes a fixed-size
local slice (padded with zeros) of one data-parallel global batch.  A rank
is one process, so the front ends are the ranks at tp index 0, one per dp
index, and the global batch is ``local_batch`` times their count; on a
``{dp, tp}`` mesh each front end's slice goes to its tp peers (a
``mesh.broadcast_from`` over the tp group), which run the same rows.  Each
rank runs only its own slice (the engine's rank-local forward: no join over
dp), so no batch crosses between dp ranks and each rank reads back only its
own rows.

Idle ticks: every tick first runs one all-reduce SUM over the world of the
ranks' (work, stopping) counts and skips the forward when no rank has work.
The same all-reduce is the shutdown rendezvous: a rank whose ``stop()`` was
called keeps ticking (contributing zero work and a stop flag, still joining
any forward another rank triggers) until every rank has flagged stop;
without it, the first rank to exit would leave the others blocked in a
collective.  With one process the server blocks on its local queue.
"""

from __future__ import annotations

import queue
import time
from typing import List, Optional

import numpy as np
import torch

from vit_tpu_torch.runtime.serving import (
    _STOP,
    _Request,
    _ServerBase,
    _sync,
    device_context,
    make_serve_fn,
    start_async_readback,
)


class LockstepServer(_ServerBase):
    """Fixed-tick, fixed-local-batch server over a mesh spanning the world
    of ``torch.distributed`` (one process per rank).

    Args:
      engine: an InferenceEngine over this rank's mesh (``make_mesh``; it
        must have a 'dp' axis, and may have 'tp').
      local_batch: images this front end contributes per tick (the global
        batch is ``local_batch`` x the front ends, the ranks at tp index 0;
        every forward has this one shape).
      tick_ms: lockstep period: how often idle ranks poll the any-work
        all-reduce.  Irrelevant with one process (the server blocks on its
        queue instead).
      pipeline_depth: in-flight batches (dispatch/readback overlap).
    """

    def __init__(
        self,
        engine,
        local_batch: int = 32,
        tick_ms: float = 10.0,
        pipeline_depth: int = 2,
        max_queue_images: "Optional[int]" = None,
    ):
        from vit_tpu_torch.parallel.mesh import world

        if local_batch < 1:
            raise ValueError("local_batch and pipeline_depth must be >= 1")
        if not tick_ms > 0:  # an idle tick waits this long on the queue
            raise ValueError(f"tick_ms must be > 0, got {tick_ms}")
        mesh = engine.mesh
        if mesh is None or "dp" not in mesh.axis_names:
            raise ValueError("LockstepServer needs an engine with a 'dp' mesh")
        super().__init__(engine, pipeline_depth,
                         max_queue_images if max_queue_images is not None
                         else 8 * local_batch)
        self.local_batch = local_batch
        self.tick = tick_ms / 1e3
        self._procs = world()[1]
        self._tp = mesh.size("tp")
        hosts = self._procs // self._tp  # the front ends
        self.front = mesh.index("tp") == 0
        self.global_batch = local_batch * hosts
        dp = mesh.size("dp")
        if self.global_batch % dp:
            raise ValueError(
                f"global batch {self.global_batch} (local {local_batch} x "
                f"{hosts} hosts) must divide dp={dp}"
            )
        if self._procs > 1 and dp % hosts:
            raise ValueError(f"dp={dp} must divide across {hosts} hosts")
        # each rank's forward reads its own slice and returns its rows
        self._serve_fn = make_serve_fn(engine, engine._local_forward)

    # -- request API ------------------------------------------------------------

    def _validate(self, images) -> None:
        if not self.front:
            raise RuntimeError("requests enter at tp index 0; this rank is a tensor-parallel "
                               "peer of its front end")
        if len(images) > self.local_batch:
            raise ValueError(
                f"request of {len(images)} exceeds local_batch={self.local_batch}"
            )

    def warmup(self) -> None:
        """Run the (single) tick shape before traffic.  Every rank must call
        this together.  If the server is already running, the warmup is
        routed through the tick loop itself: dispatching directly from
        another thread would interleave collectives in different orders on
        different ranks (a lockstep violation)."""
        cfg = self.engine.cfg
        if self._running:
            if self.front:  # a tp peer joins its front end's tick
                self.classify(
                    np.zeros((1, cfg.in_channels, cfg.image_size, cfg.image_size),
                             np.float32)
                )
            return
        with device_context(self.engine):
            self._dispatch(
                [_Request(np.zeros(self._local_shape(), np.float32), False)]
            )
            _sync(self.engine)
            if self._procs > 1:
                # warm the control all-reduce too (every rank runs warmup
                # before start())
                self._tick_control(0, False)

    # -- internals ------------------------------------------------------------

    def _local_shape(self):
        cfg = self.engine.cfg
        return (self.local_batch, cfg.in_channels, cfg.image_size, cfg.image_size)

    def _gather_tick(self) -> Optional[List[_Request]]:
        """Pull requests for one tick (never past local_batch images).
        One process: blocks until work arrives.  Several: returns (possibly
        empty) after the tick window so the rank stays in lockstep."""
        reqs: List[_Request] = []
        total = 0
        first = None
        while first is None:
            first = self._carry
            self._carry = None
            if first is None:
                try:
                    first = self._q.get(
                        timeout=self.tick if self._procs > 1 else None
                    )
                except queue.Empty:
                    return reqs  # idle tick (several ranks keep ticking)
            if first is _STOP:
                return None
            if self._expired(first):  # deadline passed while queued
                first = None
        reqs.append(first)
        total = len(first.images)
        while total < self.local_batch:
            try:
                nxt = self._q.get_nowait()
            except queue.Empty:
                break
            if nxt is _STOP:
                self._q.put(_STOP)
                break
            if self._expired(nxt):
                continue
            if total + len(nxt.images) > self.local_batch:
                self._carry = nxt
                break
            reqs.append(nxt)
            total += len(nxt.images)
        return reqs

    def _dispatch(self, reqs: List[_Request]):
        """Assemble this rank's padded slice of the global batch and run one
        tick's forward on it.  Tensor payloads are joined on the device
        (``--staged``: they never leave the card); a tp peer takes its front
        end's slice."""
        engine = self.engine
        if any(isinstance(r.images, torch.Tensor) for r in reqs):
            parts = [torch.as_tensor(r.images).to(engine.device, engine.compute_dtype)
                     for r in reqs]
            pad = self.local_batch - sum(len(p) for p in parts)
            if pad:
                parts.append(torch.zeros((pad,) + self._local_shape()[1:],
                                         dtype=engine.compute_dtype, device=engine.device))
            x = torch.cat(parts, dim=0)
        else:
            local = np.zeros(self._local_shape(), np.float32)
            off = 0
            for r in reqs:
                local[off : off + len(r.images)] = np.asarray(r.images)
                off += len(r.images)
            x = torch.from_numpy(local).to(engine.device, engine.compute_dtype)
        if self._tp > 1:
            from vit_tpu_torch.parallel.mesh import broadcast_from

            x = broadcast_from(x, engine.mesh, "tp", 0)
        return self._serve_fn(engine.params, x)

    def _tick_control(self, n_work: int, stopping: bool):
        """One control all-reduce: -> (global work, every rank stopping)."""
        import torch.distributed as dist

        counts = torch.tensor([n_work, 1 if stopping else 0], dtype=torch.int32,
                              device=self.engine.device)
        dist.all_reduce(counts)
        work, stopped = counts.tolist()
        return work, stopped == self._procs

    def _dispatch_loop(self) -> None:
        stopping = False
        with device_context(self.engine):
            while True:
                if stopping:
                    reqs: List[_Request] = []
                    time.sleep(self.tick)
                else:
                    got = self._gather_tick()
                    if got is None:  # local stop requested
                        stopping = True
                        reqs = []
                        if self._procs == 1:
                            break  # no peers to rendezvous with
                    else:
                        reqs = got
                if self._procs > 1:
                    # lockstep control tick: skip the forward when every
                    # rank is idle; exit only when EVERY rank has flagged
                    # stop (a stopping rank keeps joining forwards others
                    # trigger)
                    work, all_stopped = self._tick_control(
                        sum(len(r.images) for r in reqs), stopping
                    )
                    if all_stopped:
                        break
                    if work == 0:
                        continue
                elif not reqs:
                    continue
                cancelled = [r for r in reqs
                             if not r.future.set_running_or_notify_cancel()]
                if cancelled:
                    self._release_pending(cancelled)
                    reqs = [r for r in reqs if r not in cancelled]
                if self._procs == 1 and not reqs:
                    # every gathered request was client-cancelled; with no
                    # peers to stay in lockstep with, skip the all-zeros
                    # forward entirely (several ranks must still dispatch)
                    continue
                try:
                    labels, top, probs = self._dispatch(reqs)
                    if not reqs:
                        continue  # joined the forward for other ranks' work
                    if not any(r.return_probs for r in reqs):
                        probs = None
                    self._inflight.put((start_async_readback(labels, top, probs), reqs))
                except Exception as e:
                    for r in reqs:
                        self._resolve(r.future, exc=e)
                    self._release_pending(reqs)
        self._inflight.put(_STOP)

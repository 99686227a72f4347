"""Batch-queue inference serving — counterpart of ``vit_tpu.runtime.serving``.

A daemon's core: it accepts concurrent variable-size requests, coalesces
them into padded device batches (dynamic batching), and keeps the card
busy with a two-stage dispatch/readback pipeline.

Throughput design:
  - requests coalesce up to ``max_batch`` images or ``max_delay_ms``,
    whichever comes first (the latency/throughput knob);
  - batches pad to the engine's ``batch_pad`` grain, so the kernels see a
    few fixed shapes, each run once by ``warmup`` before traffic;
  - the dispatcher thread stages and launches batch i+1 while the completer
    thread waits for batch i's readback (``pipeline_depth`` batches in
    flight).  The forward ends on the device in softmax, argmax and the
    top probability, so ~12 bytes an image come back (the probabilities
    only when a request asks); the copies go into pinned host tensors that
    belong to their batch, and the completer waits on that batch's CUDA
    event alone — never on a device-wide synchronize, which would also wait
    for batch i+1.

The dispatcher thread enters ``torch.inference_mode()`` and
``torch.cuda.device(engine.device)`` itself (both are per thread); the
kernels launch on its current stream.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Tuple

import numpy as np
import torch

from vit_tpu_torch.ops import reference

# Prometheus-style latency buckets (seconds): 1ms .. 10s + +Inf
LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0,
)


class LatencyHistogram:
    """Thread-safe fixed-bucket latency histogram (Prometheus exposition
    shape: cumulative ``le`` buckets + sum + count) with quantile
    estimation by linear interpolation inside the containing bucket."""

    def __init__(self, buckets=LATENCY_BUCKETS):
        self.buckets = tuple(buckets)
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        i = bisect.bisect_left(self.buckets, seconds)
        with self._lock:
            self._counts[i] += 1
            self.sum += seconds
            self.count += 1

    def quantile(self, q: float) -> float:
        """Estimated q-quantile in seconds (0 when empty; the last finite
        bucket bound when the quantile falls in the +Inf bucket)."""
        with self._lock:
            total = self.count
            counts = list(self._counts)
        if total == 0:
            return 0.0
        rank = q * total
        cum = 0.0
        lo = 0.0
        for i, ub in enumerate(self.buckets):
            prev = cum
            cum += counts[i]
            if cum >= rank:
                frac = (rank - prev) / max(counts[i], 1)
                return lo + (ub - lo) * frac
            lo = ub
        return self.buckets[-1]

    def snapshot(self):
        """(cumulative_bucket_counts aligned to self.buckets + inf, sum,
        count) — consistent under the lock, for /metrics exposition."""
        with self._lock:
            cum = []
            c = 0
            for v in self._counts:
                c += v
                cum.append(c)
            return cum, self.sum, self.count


@dataclasses.dataclass
class ServerStats:
    requests: int = 0
    images: int = 0
    batches: int = 0
    deadline_expired: int = 0
    latency: LatencyHistogram = dataclasses.field(default_factory=LatencyHistogram)

    @property
    def images_per_batch(self) -> float:
        return self.images / max(self.batches, 1)


class _Request:
    __slots__ = ("images", "future", "return_probs", "submit_t", "deadline")

    def __init__(self, images, return_probs: bool, deadline: Optional[float] = None):
        self.images = images
        self.return_probs = return_probs
        self.submit_t = time.perf_counter()
        self.deadline = deadline  # absolute perf_counter time, or None
        self.future: Future = Future()


_STOP = object()


class ServerOverloadedError(RuntimeError):
    """Raised by ``submit`` when the pending-image backlog exceeds the
    server's ``max_queue_images`` — load-shedding instead of unbounded
    queue growth under overload (HTTP daemons map this to 503)."""


class DeadlineExceededError(RuntimeError):
    """A request's submit deadline passed while it was still QUEUED (not
    yet dispatched to the card): the dispatcher fails it instead of
    spending device time on an answer the client stopped waiting for
    (HTTP daemons map this to 504).  In-flight batches are never
    cancelled — the card has already paid for them."""


def make_serve_fn(engine):
    """(params, staged images) -> (labels, top_probs, probs), all on the
    engine's device: its forward, then the fp32 softmax, the argmax (the
    first maximum, as numpy breaks ties) and the top probability gathered
    there, so the readback per batch is the labels and tops, not the
    ``num_classes`` probabilities."""
    forward = engine._forward

    def serve(params, x):
        probs = reference.softmax(forward(params, x))
        labels = torch.argmax(probs, dim=-1)
        top = probs.gather(-1, labels[:, None])[:, 0]
        return labels, top, probs

    return serve


@dataclasses.dataclass
class Readback:
    """One batch's outputs on their way to the host: host tensors (pinned,
    filled by copies already queued on the device) and the CUDA event
    recorded after them (None for outputs computed on the CPU)."""

    labels: torch.Tensor
    top: torch.Tensor
    probs: Optional[torch.Tensor]
    event: Optional[torch.cuda.Event]

    def wait(self) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """Block until this batch's copies have landed (this event only)
        -> numpy (labels, top, probs)."""
        if self.event is not None:
            self.event.synchronize()
        probs = None if self.probs is None else self.probs.numpy().copy()
        return self.labels.numpy().copy(), self.top.numpy().copy(), probs


def start_async_readback(labels, top, probs=None) -> Readback:
    """Begin the device->host copies of one batch's outputs now, into
    pinned host tensors owned by the batch, and record an event after them
    on the current stream, so the copies overlap the next batches' compute
    and the completer waits for this batch alone."""
    if labels.device.type != "cuda":
        return Readback(labels, top, probs, None)
    host = []
    for t in (labels, top, probs):
        if t is None:
            host.append(None)
            continue
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
    event = torch.cuda.Event()
    event.record()
    return Readback(*host, event)


def device_context(engine) -> contextlib.ExitStack:
    """The per-thread state a thread driving ``engine`` needs: inference
    mode, and on the card its device as the thread's current device."""
    stack = contextlib.ExitStack()
    stack.enter_context(torch.inference_mode())
    if engine.device.type == "cuda":
        stack.enter_context(torch.cuda.device(engine.device))
    return stack


def _sync(engine) -> None:
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


class _ServerBase:
    """Lifecycle + request API + completer of the dynamic-batching server.
    Subclasses provide ``_dispatch_loop`` (and may override ``_validate``)."""

    def __init__(self, engine, pipeline_depth: int,
                 max_queue_images: "Optional[int]" = None):
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        self.engine = engine
        self.stats = ServerStats()
        self.max_queue_images = max_queue_images
        self._pending = 0  # images submitted but not yet resolved
        self._pending_lock = threading.Lock()
        self._q: "queue.Queue" = queue.Queue()
        self._inflight: "queue.Queue" = queue.Queue(maxsize=pipeline_depth)
        self._dispatcher: Optional[threading.Thread] = None
        self._completer: Optional[threading.Thread] = None
        self._carry: Optional[_Request] = None  # request that overflowed a batch
        self._running = False

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        if self._running:
            return self
        self._running = True
        self._dispatcher = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._completer = threading.Thread(target=self._complete_loop, daemon=True)
        self._dispatcher.start()
        self._completer.start()
        return self

    def stop(self) -> None:
        # flip + _STOP under the same lock submit() enqueues under: any
        # request that saw _running=True is already in the queue AHEAD of
        # _STOP (FIFO), so nothing can land behind it and hang its caller
        with self._pending_lock:
            if not self._running:
                return
            self._running = False
            self._q.put(_STOP)
        self._dispatcher.join()
        self._completer.join()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- request API --------------------------------------------------------

    def submit(self, images, return_probs: bool = False,
               deadline_ms: Optional[float] = None) -> Future:
        """Enqueue a (n, C, H, W) request; resolves to (labels, top_probs,
        probs) numpy arrays for those n images — ``probs`` is None unless
        ``return_probs`` (argmax and top probability are computed on the
        device, so ~12 bytes an image come back, not the class
        distribution).  A numpy array or a tensor; CUDA tensors stay on the
        card until their results come back.

        ``deadline_ms``: fail the request with DeadlineExceededError if it
        is still queued (not yet dispatched) this long after submit."""
        if not isinstance(images, torch.Tensor):
            images = np.asarray(images)
        if images.ndim != 4:
            raise ValueError(f"expected (n, C, H, W), got {tuple(images.shape)}")
        cfg = self.engine.cfg
        want = (cfg.in_channels, cfg.image_size, cfg.image_size)
        if tuple(images.shape[1:]) != want:
            # reject HERE, per request: a wrong-shape payload coalesced
            # into a batch would fail the join in the dispatch loop and
            # fail every innocent request in that batch
            raise ValueError(
                f"expected images of shape (n, {want[0]}, {want[1]}, "
                f"{want[2]}) for {cfg.name}, got {tuple(images.shape)}"
            )
        self._validate(images)
        n = len(images)
        deadline = (
            time.perf_counter() + deadline_ms / 1e3 if deadline_ms is not None else None
        )
        req = _Request(images, return_probs, deadline)
        with self._pending_lock:
            # running-check and enqueue are one atomic section vs stop():
            # see stop() — prevents a request landing behind _STOP and
            # never resolving
            if not self._running:
                raise RuntimeError("server not started")
            if (self.max_queue_images is not None
                    and self._pending + n > self.max_queue_images):
                raise ServerOverloadedError(
                    f"backlog {self._pending} + {n} images exceeds "
                    f"max_queue_images={self.max_queue_images}"
                )
            self._pending += n
            self._q.put(req)
        return req.future

    def classify(self, images, timeout: Optional[float] = None, return_probs: bool = False):
        return self.submit(images, return_probs).result(timeout)

    # -- hooks ---------------------------------------------------------------

    def _validate(self, images) -> None:
        pass

    def _release_pending(self, reqs) -> None:
        with self._pending_lock:
            self._pending -= sum(len(r.images) for r in reqs)

    @staticmethod
    def _resolve(fut: Future, result=None, exc=None) -> None:
        """set_result/set_exception that tolerates a client-cancelled
        future — an InvalidStateError here would kill the completer thread
        and wedge the bounded in-flight pipeline."""
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)
        except Exception:  # concurrent.futures.InvalidStateError
            pass

    def _expired(self, req: "_Request") -> bool:
        """If the request's submit deadline has passed while still queued,
        fail it (DeadlineExceededError) and return True.  Called by the
        dispatcher as it pulls requests into a batch — dispatched work is
        never cancelled."""
        if req.deadline is None or time.perf_counter() < req.deadline:
            return False
        self._resolve(
            req.future,
            exc=DeadlineExceededError(
                f"request of {len(req.images)} images spent longer than its "
                "deadline in the queue"
            ),
        )
        self._release_pending([req])
        self.stats.deadline_expired += 1
        return True

    def _dispatch_loop(self) -> None:
        raise NotImplementedError

    # -- completer -----------------------------------------------------------

    def _complete_loop(self) -> None:
        while True:
            item = self._inflight.get()
            if item is _STOP:
                break
            readback, reqs = item
            try:
                labels, top, probs = readback.wait()
            except Exception as e:
                for r in reqs:
                    self._resolve(r.future, exc=e)
                self._release_pending(reqs)
                continue
            # Snapshot the stats object once and record the WHOLE batch's
            # stats BEFORE resolving any future: a selftest thread swaps
            # ``self.stats`` the moment classify() returns, and stats
            # recorded after a _resolve would leak into the fresh SLO window.
            stats = self.stats
            stats.batches += 1
            done_t = time.perf_counter()
            for r in reqs:
                stats.requests += 1
                stats.images += len(r.images)
                stats.latency.record(done_t - r.submit_t)
            off = 0
            for r in reqs:
                n = len(r.images)
                p = probs[off:off + n] if (probs is not None and r.return_probs) else None
                self._resolve(r.future, (labels[off:off + n], top[off:off + n], p))
                off += n
            self._release_pending(reqs)


class InferenceServer(_ServerBase):
    """Dynamic-batching server around an InferenceEngine.

    ``submit(images) -> Future[(labels, top_probs, probs)]`` is thread-safe;
    ``classify`` is the blocking convenience wrapper.
    """

    def __init__(
        self,
        engine,
        max_batch: int = 64,
        max_delay_ms: float = 5.0,
        pipeline_depth: int = 2,
        max_queue_images: "Optional[int]" = None,
    ):
        if max_batch < 1:
            raise ValueError("max_batch and pipeline_depth must be >= 1")
        if max_queue_images is None:
            max_queue_images = 8 * max_batch  # bounded backlog by default
        super().__init__(engine, pipeline_depth, max_queue_images)
        self.max_batch = max_batch
        self.max_delay = max_delay_ms / 1e3
        self._serve_fn = make_serve_fn(engine)

    def _validate(self, images) -> None:
        # a request past max_batch would run a padded size warmup never
        # ran; make the client split it instead
        if len(images) > self.max_batch:
            raise ValueError(
                f"request of {len(images)} images exceeds "
                f"max_batch={self.max_batch}; split into smaller requests"
            )

    def swap_params(self, params) -> None:
        """Zero-downtime weight reload: stage the new checkpoint through the
        engine's dtype/quantization/placement policy, then swap it in
        atomically.  No drain, nothing rebuilt: batches already dispatched
        finish on the old weights, the next gathered batch serves the new
        ones.  Raises ValueError (and keeps serving the old weights) on a
        shape/structure mismatch."""
        self.engine.swap_params(params)

    # -- internals ----------------------------------------------------------

    def _gather(self) -> Optional[List[_Request]]:
        """Collect requests up to (never past) max_batch images or
        max_delay.  A request that would overflow the batch is carried to
        the next one, so padded batch sizes stay within the warmed ones.
        Requests whose submit deadline expired while queued are failed here
        instead of batched."""
        first = None
        while first is None:
            first = self._carry or self._q.get()
            self._carry = None
            if first is _STOP:
                return None
            if self._expired(first):
                first = None
        reqs = [first]
        total = len(first.images)
        deadline = time.perf_counter() + self.max_delay
        while total < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is _STOP:
                self._q.put(_STOP)  # re-signal for the outer loop
                break
            if self._expired(nxt):
                continue
            if total + len(nxt.images) > self.max_batch:
                self._carry = nxt
                break
            reqs.append(nxt)
            total += len(nxt.images)
        return reqs

    def warmup(self) -> None:
        """Run every padded batch size the server can dispatch (each
        ``batch_pad`` multiple up to max_batch) once before serving traffic;
        the first run also builds the kernels."""
        engine = self.engine
        cfg = engine.cfg
        grain = engine.batch_pad
        sizes = sorted({min(s, self.max_batch) for s in
                        range(grain, self.max_batch + grain, grain)})
        with device_context(engine):
            for s in sizes:
                x = np.zeros((s, cfg.in_channels, cfg.image_size, cfg.image_size), np.float32)
                staged, _ = engine._stage(x)
                self._serve_fn(engine.params, staged)
            _sync(engine)

    def _join(self, reqs: List[_Request]):
        """The batch's payloads as one array: numpy joined on the host, or,
        where any request is a tensor, every payload cast to the compute
        dtype on the engine's device and joined there."""
        if len(reqs) == 1:
            return reqs[0].images
        engine = self.engine
        if any(isinstance(r.images, torch.Tensor) for r in reqs):
            return torch.cat([
                torch.as_tensor(r.images).to(engine.device, engine.compute_dtype)
                for r in reqs
            ])
        return np.concatenate([r.images for r in reqs], axis=0)

    def _dispatch_loop(self) -> None:
        engine = self.engine
        with device_context(engine):
            while True:
                reqs = self._gather()
                if reqs is None:
                    break
                try:
                    x, _ = engine._stage(self._join(reqs))
                    # padded tail rows are never read (the completer's
                    # offsets cover real images only)
                    labels, top, probs = self._serve_fn(engine.params, x)
                    if not any(r.return_probs for r in reqs):
                        probs = None
                    readback = start_async_readback(labels, top, probs)
                    self._inflight.put((readback, reqs))  # backpressure
                except Exception as e:  # a bad batch fails its own requests
                    for r in reqs:
                        self._resolve(r.future, exc=e)
                    self._release_pending(reqs)
        self._inflight.put(_STOP)


def _prepare_selftest(
    server: InferenceServer,
    request_sizes: List[int],
    cfg,
    seed: int,
    device_staged: bool,
) -> list:
    """Shared selftest setup: build the synthetic request stream, optionally
    place it on the engine's device, run every padded size (``warmup``)
    and open a fresh SLO window.  Returns the list of request payloads.

    ``device_staged`` places every payload on the device in the compute
    dtype beforehand, measuring the serving loop itself (batching, pipeline,
    compute, readback) without the host->device copy of the images."""
    from vit_tpu_torch.io.images import synth_images

    engine = server.engine
    pool = synth_images(max(request_sizes), cfg, seed=seed)
    requests = [np.asarray(pool[:n]) for n in request_sizes]
    if device_staged:
        requests = [torch.from_numpy(r).to(engine.device, engine.compute_dtype)
                    for r in requests]
        _sync(engine)  # keep the copies out of the timed window
    server.warmup()  # every padded size runs once outside the timed window
    server.classify(requests[0])
    server.stats = ServerStats()  # SLO window excludes warmup traffic
    return requests


def measure_throughput(
    server: InferenceServer,
    request_sizes: List[int],
    cfg,
    seed: int = 0,
    device_staged: bool = False,
) -> Tuple[float, int]:
    """Drive the server with a pre-generated stream of variable-size
    synthetic requests; returns (images/sec, total_images).  Used by the
    serve CLI's --selftest.

    See ``_prepare_selftest`` for the ``device_staged`` semantics.
    """
    requests = _prepare_selftest(server, request_sizes, cfg, seed, device_staged)
    # the whole stream is enqueued at t=0 BY DESIGN (backlog-drain
    # measurement): suspend load-shedding for the burst so a default
    # max_queue_images can't shed the benchmark's own traffic mid-submit
    cap, server.max_queue_images = server.max_queue_images, None
    try:
        t0 = time.perf_counter()
        futures = [server.submit(r) for r in requests]
        for f in futures:
            f.result()
        dt = time.perf_counter() - t0
    finally:
        server.max_queue_images = cap
    total = sum(request_sizes)
    return total / dt, total


def measure_steady_state(
    server: InferenceServer,
    request_sizes: List[int],
    cfg,
    rate_rps: float,
    seed: int = 0,
    device_staged: bool = False,
) -> Tuple[float, int, float]:
    """Drive the server with paced Poisson arrivals at ``rate_rps``
    requests/sec; returns (images/sec achieved, total_images, offered_rps).

    ``measure_throughput`` enqueues the whole stream at t=0, so its latency
    histogram measures backlog drain under saturation.  This variant spaces
    submissions with seeded exponential inter-arrival gaps — below capacity,
    the recorded p50/p99 is the per-request service latency (queueing +
    batching delay + compute + readback).  Offered load at or above capacity
    degenerates to the saturation measurement.
    """
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    requests = _prepare_selftest(server, request_sizes, cfg, seed, device_staged)
    gaps = np.random.default_rng(seed).exponential(1.0 / rate_rps, len(requests))
    # suspend load-shedding like measure_throughput: at/above-capacity
    # offered load must degenerate to the saturation measurement, not
    # raise ServerOverloadedError out of the submit loop
    cap, server.max_queue_images = server.max_queue_images, None
    try:
        t0 = time.perf_counter()
        arrivals = t0 + np.cumsum(gaps)
        futures = []
        for due, r in zip(arrivals, requests):
            delay = due - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            futures.append(server.submit(r))
        for f in futures:
            f.result()
        dt = time.perf_counter() - t0
    finally:
        server.max_queue_images = cap
    total = sum(request_sizes)
    offered = len(requests) / float(arrivals[-1] - t0)
    return total / dt, total, offered

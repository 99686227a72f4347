"""Serving daemon CLI — counterpart of ``vit_tpu.cli.serve``.

An HTTP endpoint accepting image batches in the reference's wire format
(input-100.bin layout: int32[4] header + fp32 NCHW), answered with the
result lines' data as JSON, backed by the dynamic-batching
``InferenceServer`` (``runtime/serving.py``) on the card.

Usage::

    vit-tpu-torch-serve --weights ./Network --port 8117
    # POST /classify with an input-100.bin-format body -> JSON results;
    # Content-Type: image/* bodies (one raw JPEG/PNG) are preprocessed
    # with the torchvision eval transform (io/preprocess.py)
    # X-Deadline-Ms: N -> 504 when the request is still queued after N ms
    # GET  /healthz -> liveness + batching stats
    # GET  /metrics -> Prometheus text (the JAX daemon's metric names)
    # POST /reload {"weights": PATH} -> hot swap (with --allow-reload)

    vit-tpu-torch-serve --weights ./Network --allow-synth-weights --selftest 200
    # in-process throughput check on a stream of variable-size requests
    vit-tpu-torch-serve --weights ./Network --allow-synth-weights --selftest 50 \
        --device cpu
    # the same on the CPU (the kernels' plain twins)

``--ops auto`` is ``fused`` on the card and ``eager`` on the CPU.

Over a mesh, one process per rank::

    torchrun --standalone --nproc-per-node 2 -m vit_tpu_torch.cli.serve \
        --weights ./Network --tp 2 --dist-backend gloo
    # --tp/--dp: rank 0 runs the daemon (or the selftest) and answers HTTP;
    # the other ranks follow its dispatches (runtime/serving.py)
    vit-tpu-torch-serve --weights ./Network --multihost --coordinator HOST:PORT \
        --num-processes 2 --process-id I [--local-batch 32 --tick-ms 10]
    # run once per process (or under torchrun without the coordinator
    # flags): a dp mesh over every process, the lockstep tick server
    # (runtime/multihost_serving.py); every process's daemon answers its own
    # requests, and POST /reload answers 409

``--device cpu`` runs either on the CPU over gloo; ranks sharing one card
need ``--dist-backend gloo`` (NCCL puts no two ranks on one card).
"""

from __future__ import annotations

import argparse
import json
import sys


class _Refused(Exception):
    """Flags this run cannot serve with (the CLI exits 2)."""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vit-tpu-torch-serve")
    p.add_argument("--config", default="vit_b_16")
    p.add_argument(
        "--num-classes", type=int, default=None, metavar="K",
        help="override the config's class count (fine-tuned checkpoints)",
    )
    p.add_argument("--weights", required=True)
    p.add_argument("--allow-synth-weights", action="store_true")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument(
        "--ops", default="auto", choices=["auto", "eager", "per_op", "fused", "quant"],
        help="compute path (as the classify CLI's); auto = fused on cuda, eager on cpu",
    )
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8117)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel size (heads/MLP over a mesh; under torchrun, one "
                   "process per rank)")
    p.add_argument("--dp", type=int, default=None, help="data-parallel size")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="torch.distributed backend of --tp/--dp/--multihost (default: nccl "
                   "with a card per rank, gloo on the CPU; gloo lets ranks share one card)")
    p.add_argument("--max-batch", type=int, default=64,
                   help="coalesce requests up to this many images")
    p.add_argument("--max-delay-ms", type=float, default=5.0,
                   help="max time to wait filling a batch")
    p.add_argument("--batch-pad", type=int, default=32,
                   help="padding grain (every padded size runs once at startup; "
                   "set equal to --max-batch for a single shape / fastest startup "
                   "at the cost of small batches computing at the max-batch shape)")
    p.add_argument("--max-queue", type=int, default=None, metavar="IMAGES",
                   help="shed load (HTTP 503) when the pending-image "
                   "backlog exceeds this (default: 8 x max-batch)")
    p.add_argument("--tome", type=int, default=0, metavar="R",
                   help="ToMe token merging on the serving forward "
                   "(needs --ops fused, quant or eager)")
    p.add_argument("--labels", help="label names file (default: packaged ImageNet)")
    p.add_argument(
        "--selftest", type=int, metavar="N", default=None,
        help="serve N randomized variable-size requests in-process, print "
        "one JSON throughput line, and exit (no socket)",
    )
    p.add_argument(
        "--selftest-rate", type=float, metavar="RPS", default=None,
        help="pace the selftest's submissions as Poisson arrivals at this "
        "many requests/sec instead of enqueueing everything at t=0: below "
        "capacity the reported p50/p99 is steady-state service latency, "
        "not saturation backlog drain",
    )
    p.add_argument(
        "--staged", action="store_true",
        help="selftest with device-resident payloads (measures the serving "
        "loop, not the host->device copy; request sizes snap to the "
        "padding grain)",
    )
    p.add_argument(
        "--allow-reload", action="store_true",
        help="enable POST /reload {\"weights\": PATH}: hot-swap the model "
        "weights (same config) with zero downtime — no drain, nothing "
        "rebuilt; in-flight batches finish on the old weights. Off by "
        "default (the endpoint loads server-side file paths).",
    )
    p.add_argument(
        "--multihost", action="store_true",
        help="pod mode: join every process (one per card) into a global dp mesh and "
        "serve via the lockstep tick server (every process runs this same command; "
        "each process's daemon answers its local requests)",
    )
    p.add_argument("--coordinator", default=None,
                   help="multihost coordinator address (host:port); from torchrun's "
                   "environment when omitted")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--local-batch", type=int, default=32,
                   help="multihost: images per process per tick (shape-static)")
    p.add_argument("--tick-ms", type=float, default=10.0,
                   help="multihost: lockstep tick period")
    return p


def resolve_ops(args) -> str:
    """--ops auto -> fused on the card, eager on the CPU."""
    if args.ops != "auto":
        return args.ops
    return "fused" if args.device == "cuda" else "eager"


def _build_server(args):
    """-> (cfg, ops, server): an ``InferenceServer`` (over the --tp/--dp
    mesh, when given) or, with --multihost, a ``LockstepServer`` over a dp
    mesh of every process.  Raises ``_Refused`` for flags this run cannot
    serve with."""
    import functools

    from vit_tpu_torch.cli import common
    from vit_tpu_torch.config import resolve_config
    from vit_tpu_torch.io.load_any import load_params_any
    from vit_tpu_torch.runtime.engine import InferenceEngine
    from vit_tpu_torch.runtime.serving import InferenceServer

    cfg = resolve_config(args.config, args.num_classes)
    ops = resolve_ops(args)
    device = args.device
    try:
        if args.multihost:
            # before anything else touches the card or the process group
            try:
                mesh, device = common.resolve_multihost(args.coordinator, args.num_processes,
                                                        args.process_id, device,
                                                        args.dist_backend)
            except (ValueError, RuntimeError) as e:
                raise _Refused(f"--multihost (--coordinator/--num-processes/--process-id): "
                               f"{e}") from e
            print(f"multihost: {mesh.size('dp')} host(s), global dp={mesh.size('dp')}, "
                  f"local_batch={args.local_batch}")
        else:
            mesh, device = common.resolve_mesh(args.dp, args.tp, device, args.dist_backend)
    except common.MeshError as e:
        raise _Refused(str(e)) from e
    load = functools.partial(load_params_any, cfg=cfg, allow_synth=args.allow_synth_weights)
    params = load(args.weights)
    try:
        engine = InferenceEngine(cfg, params, dtype=args.dtype, ops=ops, device=device,
                                 batch_pad=args.batch_pad, tome_r=args.tome, mesh=mesh)
        if args.multihost:
            from vit_tpu_torch.runtime.multihost_serving import LockstepServer

            server = LockstepServer(engine, local_batch=args.local_batch,
                                    tick_ms=args.tick_ms, max_queue_images=args.max_queue)
        else:
            server = InferenceServer(engine, max_batch=args.max_batch,
                                     max_delay_ms=args.max_delay_ms,
                                     max_queue_images=args.max_queue, load_params=load)
    except ValueError as e:
        raise _Refused(str(e)) from e
    return cfg, ops, server


def selftest_sizes(args, rng) -> list:
    """The selftest's request sizes: with --staged, the padding grain, half
    of the cap or the cap; else uniform in 1..cap.  The cap is max_batch, or
    in multihost mode local_batch (a request must fit one tick's local
    slice)."""
    cap = args.local_batch if args.multihost else args.max_batch
    if args.staged:
        grain = args.batch_pad
        choices = sorted({min(grain, cap), max(min(grain, cap), cap // 2), cap})
        return [int(rng.choice(choices)) for _ in range(args.selftest)]
    return [int(v) for v in rng.integers(1, cap + 1, args.selftest)]


def _selftest(args, cfg, ops, server) -> int:
    import numpy as np

    from vit_tpu_torch.runtime.serving import measure_steady_state, measure_throughput

    sizes = selftest_sizes(args, np.random.default_rng(0))
    offered = None
    with server:
        if args.selftest_rate:
            img_per_sec, total, offered = measure_steady_state(
                server, sizes, cfg, args.selftest_rate, device_staged=args.staged,
            )
        else:
            img_per_sec, total = measure_throughput(
                server, sizes, cfg, device_staged=args.staged
            )
    print(
        json.dumps(
            {
                "metric": f"serving images/sec, {cfg.name} variable-size stream"
                + (" (device-staged)" if args.staged else ""),
                "value": round(img_per_sec, 2),
                "unit": "images/sec",
                "mode": "steady" if args.selftest_rate else "saturation",
                **({"offered_rps": round(offered, 2)} if offered is not None else {}),
                "requests": args.selftest,
                "images": total,
                "images_per_batch": round(server.stats.images_per_batch, 2),
                "batches": server.stats.batches,
                "latency_p50_ms": round(server.stats.latency.quantile(0.50) * 1e3, 2),
                "latency_p99_ms": round(server.stats.latency.quantile(0.99) * 1e3, 2),
                "ops": ops,
                "dtype": args.dtype,
                "staged": bool(args.staged),
            }
        )
    )
    return 0


def metrics_text(stats) -> str:
    """Prometheus text exposition of the batching and latency SLOs, under
    the JAX daemon's metric names (one scrape config serves both)."""
    s = stats
    lines = [
        "# TYPE vit_tpu_requests_total counter",
        f"vit_tpu_requests_total {s.requests}",
        "# TYPE vit_tpu_images_total counter",
        f"vit_tpu_images_total {s.images}",
        "# TYPE vit_tpu_batches_total counter",
        f"vit_tpu_batches_total {s.batches}",
        "# TYPE vit_tpu_images_per_batch gauge",
        f"vit_tpu_images_per_batch {s.images_per_batch:.4f}",
        "# TYPE vit_tpu_deadline_expired_total counter",
        f"vit_tpu_deadline_expired_total {s.deadline_expired}",
    ]
    cum, lat_sum, lat_count = s.latency.snapshot()
    lines.append("# TYPE vit_tpu_request_latency_seconds histogram")
    for ub, c in zip(s.latency.buckets, cum):
        lines.append(f'vit_tpu_request_latency_seconds_bucket{{le="{ub}"}} {c}')
    lines += [
        f'vit_tpu_request_latency_seconds_bucket{{le="+Inf"}} {cum[-1]}',
        f"vit_tpu_request_latency_seconds_sum {lat_sum:.6f}",
        f"vit_tpu_request_latency_seconds_count {lat_count}",
        "# TYPE vit_tpu_request_latency_p50_seconds gauge",
        f"vit_tpu_request_latency_p50_seconds {s.latency.quantile(0.5):.6f}",
        "# TYPE vit_tpu_request_latency_p99_seconds gauge",
        f"vit_tpu_request_latency_p99_seconds {s.latency.quantile(0.99):.6f}",
    ]
    return "\n".join(lines) + "\n"


def _deadline_ms(hdr):
    """The X-Deadline-Ms header -> ms, or None when absent; a value that is
    empty, non-numeric, nan, inf or negative is a client error
    (ValueError), never a silently disabled SLO or a permanent 504."""
    import math

    if hdr is None:
        return None
    try:
        ms = float(hdr)
    except ValueError:
        raise ValueError(f"bad X-Deadline-Ms: {hdr!r}")
    if not math.isfinite(ms) or ms < 0:
        raise ValueError(f"bad X-Deadline-Ms: {hdr!r}")
    return ms


def _http_daemon(args, cfg, ops, server, on_listen=None) -> int:
    """Bind, warm up, then serve until shutdown (SIGTERM drains);
    ``on_listen(httpd)`` is called once the daemon answers."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from vit_tpu_torch.io.images import parse_image_bytes
    from vit_tpu_torch.io.results import load_labels
    from vit_tpu_torch.runtime.serving import DeadlineExceededError, ServerOverloadedError

    label_names = load_labels(args.labels, cfg.num_classes)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet access log
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reload(self):
            """POST /reload {"weights": PATH}: zero-downtime weight hot-swap
            through server.reload (gated on --allow-reload; the path is
            resolved server-side, on a mesh by every rank).  409 in
            multihost mode: the lockstep server has no coordinated swap."""
            try:
                if not args.allow_reload:
                    self._send(403, {"error": "reload disabled; start with --allow-reload"})
                    return
                if not hasattr(server, "swap_params"):
                    self._send(409, {"error": "reload unsupported in multihost lockstep mode "
                                              "(hosts would diverge)"})
                    return
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(req, dict):  # valid JSON, wrong shape -> 400
                    raise ValueError('body must be {"weights": "<path>"}')
                path = req.get("weights")
                if not isinstance(path, str) or not path:
                    raise ValueError('body must be {"weights": "<path>"}')
                server.reload(path)  # on a mesh, on every rank
                print(f"hot-swapped weights from {path}")
                self._send(200, {"ok": True, "weights": path})
            except (ValueError, KeyError, FileNotFoundError) as e:
                self._send(400, {"error": str(e)})
            except Exception as e:
                self._send(500, {"error": repr(e)})

        def do_GET(self):
            if self.path == "/healthz":
                s = server.stats
                self._send(200, {
                    "ok": True, "model": cfg.name, "ops": ops,
                    "requests": s.requests, "images": s.images,
                    "batches": s.batches,
                    "images_per_batch": round(s.images_per_batch, 2),
                    "latency_p50_ms": round(s.latency.quantile(0.5) * 1e3, 3),
                    "latency_p99_ms": round(s.latency.quantile(0.99) * 1e3, 3),
                    "deadline_expired": s.deadline_expired,
                })
            elif self.path == "/metrics":
                body = metrics_text(server.stats).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path == "/reload":
                self._reload()
                return
            if self.path != "/classify":
                self._send(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                if self.headers.get("Content-Type", "").startswith("image/"):
                    images = _decode_image(body, cfg)
                else:
                    images = parse_image_bytes(body)
                deadline_ms = _deadline_ms(self.headers.get("X-Deadline-Ms"))
                labels, top_probs, _ = server.submit(images, deadline_ms=deadline_ms).result()
                self._send(200, {
                    "results": [
                        {"index": i, "label": int(l), "prob": float(p),
                         "name": label_names[int(l)]}
                        for i, (l, p) in enumerate(zip(labels, top_probs))
                    ]
                })
            except ValueError as e:
                self._send(400, {"error": str(e)})
            except ServerOverloadedError as e:
                self._send(503, {"error": str(e)})
            except DeadlineExceededError as e:
                self._send(504, {"error": str(e)})
            except Exception as e:  # keep the daemon alive on bad requests
                self._send(500, {"error": repr(e)})

    # bind FIRST (cheap): a port conflict must fail fast, not after the
    # warmup's kernel build
    httpd = ThreadingHTTPServer((args.host, args.port), Handler)
    print("warming up (every padded batch size; the first builds the kernels)...")
    server.warmup()
    print(
        f"vit-tpu-torch-serve: {cfg.name} ops={ops} dtype={args.dtype} "
        f"device={server.engine.device} listening on "
        f"http://{args.host}:{httpd.server_address[1]}",
        flush=True,
    )
    restore_sigterm = _drain_on_sigterm(httpd)
    with server:  # __exit__ = stop(): drains queued + in-flight work FIFO
        if on_listen is not None:
            on_listen(httpd)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            restore_sigterm()
            httpd.server_close()
    return 0


def _decode_image(body: bytes, cfg):
    """One raw JPEG/PNG/... body -> (1, 3, S, S) through the torchvision
    eval preprocessing (io/preprocess.py); an undecodable body is a client
    error (ValueError), not a 500."""
    import io as _io

    from PIL import Image, UnidentifiedImageError

    from vit_tpu_torch.io.preprocess import preprocess_image

    try:
        decoded = Image.open(_io.BytesIO(body))
        decoded.load()
    except (UnidentifiedImageError, OSError) as e:
        raise ValueError(f"undecodable image body: {e}")
    return preprocess_image(decoded, cfg.image_size)[None]


def _drain_on_sigterm(httpd):
    """Install a SIGTERM handler that stops the HTTP listener so the daemon
    exits through its normal drain path (``server.stop()`` resolves every
    already-accepted request before the process ends).  Returns a
    restore() callable; a no-op off the main thread (signal.signal would
    raise there — e.g. daemons embedded in another process's thread)."""
    import signal
    import threading

    if threading.current_thread() is not threading.main_thread():
        return lambda: None

    def _handler(signum, frame):
        print("SIGTERM: draining accepted requests, then exiting")
        # shutdown() blocks until serve_forever returns; the handler runs
        # ON the serve_forever thread, so hand it to a helper thread
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    prev = signal.signal(signal.SIGTERM, _handler)
    installed_default = prev is None  # prior handler came from outside Python

    def restore():
        signal.signal(signal.SIGTERM, signal.SIG_DFL if installed_default else prev)

    return restore


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.tome < 0:
        print("error: --tome must be >= 0", file=sys.stderr)
        return 2
    if args.tome and (args.multihost or args.tp > 1):
        print("error: --tome needs --ops fused/quant/eager on a single-host dp mesh (no "
              "--tp/--multihost)", file=sys.stderr)
        return 2
    if args.tome and resolve_ops(args) not in ("fused", "quant", "eager"):
        print("error: --tome (token merging) needs --ops fused, quant, or eager",
              file=sys.stderr)
        return 2
    if args.selftest is not None and args.max_queue is None:
        # the selftest intentionally enqueues the whole burst up front to
        # measure drain throughput — don't shed it
        args.max_queue = 1 << 31
    from vit_tpu_torch.io.params import device_or_raise

    try:
        device_or_raise(args.device)  # --device cuda without a card: nothing runs elsewhere
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        cfg, ops, server = _build_server(args)
    except _Refused as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not getattr(server, "leads", True):
        server.follow()  # a mesh rank past the lead joins its dispatches
        return 0
    try:
        if args.selftest is not None:
            return _selftest(args, cfg, ops, server)
        return _http_daemon(args, cfg, ops, server)
    finally:
        server.stop()  # over a mesh, frees the followers even after a failure


if __name__ == "__main__":
    sys.exit(main())

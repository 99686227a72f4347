"""One rank of the gloo groups that ``test_torch_serve_mesh.py`` (``mesh``, 2
ranks) and ``test_torch_multihost_serving.py`` (``lockstep``, 4 ranks)
start:

    python -m torch.distributed.run --standalone --nproc-per-node N \
        tests/torch_serve_worker.py {mesh,lockstep} DIR

Reads the requests from ``DIR/in.npz`` and the seed-0 and seed-1 weights
from ``DIR/p0.npz`` and ``DIR/p1.npz`` (made with numpy and the JAX
package's loader by the test, which hands the same arrays to the JAX
package), serves them over meshes of the world on the CPU and writes each
rank's results to ``DIR/out.<rank>.npz``.  ``cli serve|train ARGV...`` runs
one of the CLIs in this process with the tiny config registered (the
explicit-coordinator ``--multihost`` runs).  Imports nothing of JAX.
"""

import contextlib
import hashlib
import io
import json
import os
import queue
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from vit_tpu_torch import config
from vit_tpu_torch.io.load_any import load_params_any

CFG = config.ViTConfig(image_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
                       num_classes=11, name="vit_tiny_test")
WAIT = 120  # s: the bound on every wait
# the InferenceServer runs: name -> (mesh axes, ops)
MESH_RUNS = {"dp2_fused": ({"dp": 2}, "fused"), "dp2_quant": ({"dp": 2}, "quant"),
             "tp2_fused": ({"dp": 1, "tp": 2}, "fused"), "tp2_quant": ({"dp": 1, "tp": 2}, "quant")}
DPTP_RUNS = {"dp2tp2_fused": "fused", "dp2tp2_quant": "quant"}
LOCAL_BATCH = 4
TICK_MS = 5.0


class Spy:
    """A server's ``_serve_fn`` that counts its calls and digests each
    batch it is given."""

    def __init__(self, fn):
        self.fn, self.calls, self.digests = fn, 0, []

    def __call__(self, params, x):
        self.calls += 1
        self.digests.append(hashlib.sha256(x.contiguous().view(torch.uint8).numpy()).hexdigest())
        return self.fn(params, x)


def _engine(d: Path, mesh, ops: str, seed: int = 0):
    from vit_tpu_torch.runtime.engine import InferenceEngine

    params = load_params_any(str(d / f"p{seed}.npz"), CFG)
    return InferenceEngine(CFG, params, dtype="float32", ops=ops, device="cpu", batch_pad=4,
                           mesh=mesh)


def _answers(res: dict, name: str, got: list) -> None:
    for i, (labels, top, probs) in enumerate(got):
        res[f"{name}/{i}/labels"] = labels
        res[f"{name}/{i}/top"] = top
        if probs is not None:
            res[f"{name}/{i}/probs"] = probs


def _params_equal(engine, d: Path, seed: int) -> bool:
    """This rank's params are those of a fresh engine on ``p<seed>.npz``
    (its shard, bit for bit)."""
    from vit_tpu_torch.runtime.engine import _leaves

    want = _engine(d, engine.mesh, engine._ops.name, seed).params
    return all(torch.equal(a, b) for (_, a), (_, b) in zip(_leaves(engine.params), _leaves(want)))


def _serve(res: dict, name: str, server, reqs: list, warm_running: bool) -> None:
    """The lead serves ``reqs`` (every even one with probabilities); the
    other ranks follow.  Every rank's batch digests into ``res``."""
    spy = server._serve_fn = Spy(server._serve_fn)
    if server.leads:
        if not warm_running:
            server.warmup()
        with server:
            if warm_running:
                server.warmup()
            futures = [server.submit(r, return_probs=(i % 2 == 0)) for i, r in enumerate(reqs)]
            _answers(res, name, [f.result(timeout=WAIT) for f in futures])
    else:
        server.follow()
    res[f"{name}/digests"] = np.array(spy.digests)


def mesh_cases(res: dict, d: Path, data: dict, rank: int) -> None:
    from vit_tpu_torch.parallel import make_mesh
    from vit_tpu_torch.runtime.serving import InferenceServer

    reqs = [data[f"reqs/{i}"] for i in range(int(data["n_reqs"]))]

    def load(path):
        if rank == 1 and "fails_on_rank1" in path:
            raise FileNotFoundError(f"{path}: not on rank 1")
        return load_params_any(path.replace("fails_on_rank1", "p1"), CFG)

    for name, (axes, ops) in MESH_RUNS.items():
        server = InferenceServer(_engine(d, make_mesh(axes), ops), max_batch=8,
                                 max_delay_ms=20.0, load_params=load)
        _serve(res, name, server, reqs, warm_running=name.startswith("tp"))
        if name != "tp2_fused":
            continue
        # reload to seed 1 at its place in the dispatch order; then one that
        # fails on rank 1 alone: every rank keeps seed 1
        server._serve_fn = server._serve_fn.fn
        if server.leads:
            with server:
                server.reload(str(d / "p1.npz"))
                _answers(res, "tp2_reloaded", [server.classify(r, timeout=WAIT, return_probs=True)
                                              for r in reqs])
                try:
                    server.reload(str(d / "fails_on_rank1.npz"))
                    res["failed_reload/error"] = np.array("")
                except ValueError as e:
                    res["failed_reload/error"] = np.array(str(e))
                _answers(res, "tp2_after_failed", [server.classify(r, timeout=WAIT)
                                                   for r in reqs])
        else:
            server.follow()
        res["tp2_params_seed1"] = np.bool_(_params_equal(server.engine, d, 1))
        try:
            server.swap_params(load_params_any(str(d / "p0.npz"), CFG))
            res["swap_params_on_mesh"] = np.array("")
        except ValueError as e:
            res["swap_params_on_mesh"] = np.array(str(e))
    daemon_case(res, d, data, rank)
    train_case(res, d, rank)


def daemon_case(res: dict, d: Path, data: dict, rank: int) -> None:
    """The serve CLI's daemon on a tp 2 mesh: rank 0 answers HTTP
    (``--port 0``), rank 1 follows; POST /classify, POST /reload to seed 1,
    POST /classify again."""
    import http.client

    from vit_tpu_torch.cli import serve

    args = serve.build_parser().parse_args([
        "--config", CFG.name, "--weights", str(d / "p0.npz"), "--device", "cpu", "--ops",
        "fused", "--dtype", "float32", "--tp", "2", "--dist-backend", "gloo", "--max-batch",
        "8", "--batch-pad", "4", "--allow-reload", "--port", "0"])
    cfg, ops, server = serve._build_server(args)
    if not server.leads:
        server.follow()
        return
    imgs = data["daemon_images"]
    body = np.array(imgs.shape, dtype="<i4").tobytes() + imgs.astype("<f4").tobytes()
    listening = queue.Queue()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        t = threading.Thread(target=serve._http_daemon, args=(args, cfg, ops, server),
                             kwargs={"on_listen": listening.put}, daemon=True)
        t.start()
        httpd = listening.get(timeout=WAIT)

        def post(path, payload):
            conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=WAIT)
            try:
                conn.request("POST", path, body=payload)
                resp = conn.getresponse()
                return resp.status, json.loads(resp.read())
            finally:
                conn.close()

        try:
            for name, path, payload in (
                    ("classify", "/classify", body),
                    ("reload", "/reload", json.dumps({"weights": str(d / "p1.npz")})),
                    ("classify_seed1", "/classify", body)):
                code, reply = post(path, payload)
                res[f"daemon/{name}/code"] = np.int32(code)
                if "results" in reply:
                    res[f"daemon/{name}/labels"] = np.array([r["label"] for r in reply["results"]])
                    res[f"daemon/{name}/top"] = np.array([r["prob"] for r in reply["results"]],
                                                         np.float32)
        finally:
            httpd.shutdown()
            t.join(timeout=WAIT)
    res["daemon/alive"] = np.bool_(t.is_alive())
    res["daemon/stdout"] = np.array(out.getvalue())


def train_case(res: dict, d: Path, rank: int) -> None:
    """The train CLI with --dp 2 on the test's shards (the reference of the
    explicit-coordinator --multihost processes)."""
    from vit_tpu_torch.cli.train import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main([*train_argv(d, "dp2"), "--dp", "2", "--dist-backend", "gloo"])
    res["train_dp2/rc"] = np.int32(rc)


def train_argv(d: Path, name: str) -> list:
    return ["--config", CFG.name, "--device", "cpu", "--ops", "fused_train", "--steps", "3",
            "--batch", "4", "--data-dir", str(d / "shards"), "--log-jsonl",
            str(d / f"{name}.jsonl"), "--save", str(d / f"{name}.npz")]


def lockstep_cases(res: dict, d: Path, data: dict, rank: int) -> None:
    from vit_tpu_torch.cli import serve
    from vit_tpu_torch.parallel import make_mesh
    from vit_tpu_torch.runtime.multihost_serving import LockstepServer
    from vit_tpu_torch.runtime.serving import InferenceServer

    # dp 4: each rank its own requests; idle ticks; rank 3 stops first
    server = LockstepServer(_engine(d, make_mesh({"dp": 4}), "fused"), local_batch=LOCAL_BATCH,
                            tick_ms=TICK_MS)
    spy = server._serve_fn = Spy(server._serve_fn)
    server.warmup()
    dist.barrier()  # before start(): no collective may run beside the tick loop's
    server.start()
    idle0 = spy.calls
    time.sleep(0.5)  # every rank idle: ~100 ticks, no forward
    res["idle_forwards"] = np.int32(spy.calls - idle0)
    # no rank submits before every rank has read its idle count
    (d / f"idle_done{rank}").touch()
    while not all((d / f"idle_done{r}").exists() for r in range(dist.get_world_size())):
        time.sleep(0.01)
    mine = [data[f"lock/{rank}/{i}"] for i in range(int(data["lock_n"]))]
    futures = [server.submit(r) for r in mine]
    _answers(res, "lock", [f.result(timeout=WAIT) for f in futures])
    if rank == 3:
        before = spy.calls
        (d / "rank3_stopping").touch()
        server.stop()
        res["stopped_rank_forwards"] = np.int32(spy.calls - before)
    elif rank == 0:
        while not (d / "rank3_stopping").exists():
            time.sleep(0.01)
        time.sleep(0.1)
        late = [data[f"late/{i}"] for i in range(int(data["late_n"]))]
        _answers(res, "late", [server.classify(r, timeout=WAIT) for r in late])
        res["late_done_at"] = np.float64(time.time())
        server.stop()
    else:
        server.stop()
    res["stop_returned_at"] = np.float64(time.time())

    # dp 2 x tp 2: requests enter at the front ends (ranks 0 and 2), the tp
    # peers run the same rows
    dptp = make_mesh({"dp": 2, "tp": 2})
    server = LockstepServer(_engine(d, dptp, "fused"), local_batch=8, tick_ms=TICK_MS)
    res["dptp/front"] = np.bool_(server.front)
    dist.barrier()
    with server:
        if server.front:
            imgs = data[f"dptp/{rank}"]
            f1, f2 = server.submit(imgs[:3]), server.submit(imgs[3:])
            _answers(res, "dptp", [f1.result(timeout=WAIT), f2.result(timeout=WAIT)])
        else:
            try:
                server.submit(data["dptp/0"][:1])
                res["dptp/peer_submit"] = np.array("")
            except RuntimeError as e:
                res["dptp/peer_submit"] = np.array(str(e))

    # the InferenceServer over dp 2 x tp 2, fused and quant
    reqs = [data[f"reqs/{i}"] for i in range(int(data["n_reqs"]))]
    for name, ops in DPTP_RUNS.items():
        server = InferenceServer(_engine(d, dptp, ops), max_batch=8, max_delay_ms=20.0)
        _serve(res, name, server, reqs, warm_running=True)

    # the serve CLI's selftest on --dp 2 --tp 2
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--config", CFG.name, "--weights", str(d / "p0.npz"), "--device", "cpu",
                         "--ops", "fused", "--dtype", "float32", "--selftest", "3",
                         "--max-batch", "8", "--batch-pad", "4", "--dp", "2", "--tp", "2",
                         "--dist-backend", "gloo"])
    res["cli_selftest/rc"] = np.int32(rc)
    res["cli_selftest/stdout"] = np.array(out.getvalue())


def run_cli(which: str, argv: list) -> int:
    config.CONFIGS[CFG.name] = CFG
    if which == "serve":
        from vit_tpu_torch.cli.serve import main
    else:
        from vit_tpu_torch.cli.train import main
    return main(argv)


def main(mode: str, d: str) -> None:
    from vit_tpu_torch.runtime import distributed

    torch.set_num_threads(1)
    config.CONFIGS[CFG.name] = CFG
    d = Path(d)
    data = dict(np.load(d / "in.npz"))
    assert distributed.initialize(backend="gloo", device_type="cpu") == "gloo"
    rank = dist.get_rank()
    res = {}
    (mesh_cases if mode == "mesh" else lockstep_cases)(res, d, data, rank)
    np.savez(d / f"out.{rank}.npz", **res)


def start_group(mode: str, d: Path, ranks: int, timeout: int = 240) -> list:
    """Run the ``ranks``-rank group in ``mode`` over ``d`` -> the ranks'
    result dicts.  A group that hangs is killed after ``timeout`` s, and
    fails."""
    [(rc, _, err)] = finish([spawn([sys.executable, "-m", "torch.distributed.run",
                                    "--nproc-per-node", str(ranks), "--standalone", __file__,
                                    mode, str(d)], d)], timeout)
    assert rc == 0, err[-4000:]
    return [dict(np.load(d / f"out.{r}.npz")) for r in range(ranks)]


def spawn(cmd: list, d: Path):
    """``cmd`` started in its own process group from ``d``: this repo and
    tests/ on the path, one torch thread, no torchrun environment."""
    import subprocess

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=f"{repo}:{repo / 'tests'}", OMP_NUM_THREADS="1")
    for key in ("WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "RANK", "LOCAL_RANK"):
        env.pop(key, None)
    return subprocess.Popen(cmd, cwd=d, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)


def finish(procs: list, timeout: int) -> list:
    """Wait for ``procs`` -> [(rc, stdout, stderr)]; past ``timeout`` s
    every one is killed with its process group, and this fails."""
    import signal
    import subprocess

    end = time.monotonic() + timeout
    results = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=max(end - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            for q in procs:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(q.pid, signal.SIGKILL)  # each launcher and what it started
            for q in procs:
                q.communicate()
            raise AssertionError(f"{len(procs)} process(es) did not finish in {timeout} s: "
                                 "a rank hung")
        results.append((p.returncode, out, err))
    return results


if __name__ == "__main__":
    if sys.argv[1] == "cli":
        torch.set_num_threads(1)
        sys.exit(run_cli(sys.argv[2], sys.argv[3:]))
    main(sys.argv[1], sys.argv[2])

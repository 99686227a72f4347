"""The port's lockstep server (``runtime/multihost_serving.py``) and the serve
CLI's ``--multihost`` against the JAX package on the CPU, and what only
several processes show.

In one process (``procs`` 1: the server blocks on its queue), a counterpart
of every case of ``tests/test_multihost_serving.py`` against the JAX
``LockstepServer`` on the same images (its virtual 8-device mesh, Pallas in
interpret mode).  In one 4-rank gloo group (``torch_serve_worker.py
lockstep``, started once for the module; a group that hangs is killed on
the module's time limit and fails): over ``{dp: 4}`` idle ticks run no
forward, each rank's answers are its own requests' rows, and a rank that
stops first keeps joining the forwards another rank's late requests
trigger until every rank has stopped; over ``{dp: 2, tp: 2}`` the front
ends' rows, and the ``InferenceServer`` and the serve CLI's ``--selftest``
on that mesh.  The serve CLI's ``--multihost`` at one process (selftest and
daemon) and at two processes joined by explicit coordinator flags, and the
train CLI's ``--multihost`` refusals in the JAX package's words.

Tolerances: the JAX tests' own, labels equal and fp32 top probabilities
within 1e-5.
"""

import contextlib
import dataclasses
import http.client
import json
import queue
import socket
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.config import VIT_B_16
from vit_tpu.io import checkpoint as jckpt
from vit_tpu.io import images as jimages
from vit_tpu.io import weights as wio
from vit_tpu.parallel import make_mesh as jmake_mesh
from vit_tpu.runtime import InferenceEngine as JaxEngine
from vit_tpu.runtime import serving as jserving
from vit_tpu.runtime.multihost_serving import LockstepServer as JaxLockstep
from vit_tpu_torch.parallel import make_mesh
from vit_tpu_torch.runtime import distributed
from vit_tpu_torch.runtime.engine import InferenceEngine
from vit_tpu_torch.runtime.multihost_serving import LockstepServer

import torch_serve_worker as W

pytestmark = pytest.mark.skipif(jax.device_count() < 4, reason="needs 4 (virtual) devices")

JCFG = dataclasses.replace(VIT_B_16, **{k: getattr(W.CFG, k) for k in (
    "image_size", "patch_size", "embed_dim", "depth", "num_heads", "num_classes", "name")})
TOL = 1e-5
LOCK_SIZES = (2, 3, 1, 4)  # each rank's requests: several ticks of local_batch 4
LATE_SIZES = (3, 2, 4)
SIZES = (1, 3, 2, 5, 4, 8)


def _tree(seed=0):
    return wio.params_from_tensors(wio.synth_reference_tensors(JCFG, seed=seed), JCFG)


@pytest.fixture(scope="module")
def fresh_distributed():
    """distributed.initialize's latch cleared for this module's in-process
    --multihost runs (one process: a no-op that latches), and restored."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(distributed, "_initialized", False)
        mp.setattr(distributed, "_initialized_explicit", False)
        yield


@pytest.fixture(scope="module")
def data():
    imgs = {f"lock/{r}/{i}": jimages.synth_images(n, JCFG, seed=100 * r + i)
            for r in range(4) for i, n in enumerate(LOCK_SIZES)}
    imgs.update({f"late/{i}": jimages.synth_images(n, JCFG, seed=500 + i)
                 for i, n in enumerate(LATE_SIZES)})
    imgs.update({f"dptp/{r}": jimages.synth_images(6, JCFG, seed=600 + r) for r in (0, 2)})
    imgs.update({f"reqs/{i}": jimages.synth_images(n, JCFG, seed=30 + i)
                 for i, n in enumerate(SIZES)})
    return imgs


@pytest.fixture(scope="module")
def group(tmp_path_factory, data):
    d = tmp_path_factory.mktemp("lockstep")
    jckpt.save_npz(_tree(), str(d / "p0.npz"))
    np.savez(d / "in.npz", lock_n=np.int32(len(LOCK_SIZES)), late_n=np.int32(len(LATE_SIZES)),
             n_reqs=np.int32(len(SIZES)), **data)
    return W.start_group("lockstep", d, 4)


@pytest.fixture(scope="module")
def jax_ref(data):
    """The JAX package's answers, each program run once: its LockstepServer
    over {dp: 4} (xla, and fused) and {dp: 2, tp: 2} (fused) on every image
    set these tests use, and its InferenceServer over {dp: 2, tp: 2}."""
    params = jax.tree.map(jnp.asarray, _tree())
    out = {}
    for name, axes, ops in (("xla", {"dp": 4}, "xla"), ("fused", {"dp": 4}, "fused"),
                            ("dptp", {"dp": 2, "tp": 2}, "fused")):
        eng = JaxEngine(JCFG, params, dtype="float32", ops=ops, batch_pad=8,
                        mesh=jmake_mesh(axes, jax.devices()[:4]))
        with JaxLockstep(eng, local_batch=8) as srv:
            out[name] = {k: tuple(np.asarray(v) for v in srv.classify(x, timeout=W.WAIT,
                                                                       return_probs=True))
                         for k, x in data.items() if not k.startswith("reqs")}
    for name, ops in W.DPTP_RUNS.items():
        eng = JaxEngine(JCFG, params, dtype="float32", ops=ops, batch_pad=4,
                        mesh=jmake_mesh({"dp": 2, "tp": 2}, jax.devices()[:4]))
        with jserving.InferenceServer(eng, max_batch=8, max_delay_ms=20.0) as srv:
            futures = [srv.submit(data[f"reqs/{i}"], return_probs=True)
                       for i in range(len(SIZES))]
            out[name] = [tuple(np.asarray(v) for v in f.result(timeout=W.WAIT))
                         for f in futures]
    return out


def _same(labels, top, want, what):
    np.testing.assert_array_equal(labels, want[0], err_msg=what)
    np.testing.assert_allclose(top, want[1], atol=TOL, rtol=0, err_msg=what)


# -- one process: the JAX tests' counterparts ---------------------------------


@pytest.fixture(scope="module")
def engines():
    tree = _tree()
    mesh = make_mesh({"dp": 1})
    return {ops: InferenceEngine(W.CFG, tree, dtype="float32", ops=ops, device="cpu",
                                 batch_pad=8, mesh=mesh)
            for ops in ("eager", "fused")} | {
        "plain": InferenceEngine(W.CFG, tree, dtype="float32", ops="eager", device="cpu",
                                 batch_pad=8)}


def test_lockstep_matches_direct_engine(engines, data, jax_ref):
    reqs = [data[f"lock/0/{i}"] for i in range(len(LOCK_SIZES))]
    with LockstepServer(engines["eager"], local_batch=8) as srv:
        srv.warmup()
        futures = [srv.submit(r, return_probs=(i == 0)) for i, r in enumerate(reqs)]
        results = [f.result(timeout=W.WAIT) for f in futures]
    for i, (r, (labels, top, probs)) in enumerate(zip(reqs, results)):
        want = jax_ref["xla"][f"lock/0/{i}"]
        _same(labels, top, want, f"request {i}")
        _same(labels, top, engines["plain"].classify(r), f"request {i} vs the engine")
        if i == 0:
            np.testing.assert_allclose(probs, want[2], atol=TOL, rtol=0)
        else:
            assert probs is None


def test_lockstep_fixed_tick_batches(engines):
    # requests beyond one tick's local_batch carry to the next tick
    reqs = [jimages.synth_images(3, JCFG, seed=i) for i in range(4)]  # 12 images
    with LockstepServer(engines["eager"], local_batch=8) as srv:
        srv.warmup()
        for f in [srv.submit(r) for r in reqs]:
            f.result(timeout=W.WAIT)
    # 12 request images + 1 warmup image (warmup on a running server routes
    # through the tick loop)
    assert srv.stats.images == 13
    assert srv.stats.batches >= 2  # 12 images can't fit one 8-image tick


def test_lockstep_validates_request_size(engines):
    with LockstepServer(engines["eager"], local_batch=4) as srv:
        with pytest.raises(ValueError, match="exceeds local_batch"):
            srv.submit(jimages.synth_images(5, JCFG))


def test_lockstep_requires_dp_mesh(engines):
    with pytest.raises(ValueError, match="'dp' mesh"):
        LockstepServer(engines["plain"], local_batch=4)
    with pytest.raises(ValueError, match="local_batch and pipeline_depth must be >= 1"):
        LockstepServer(engines["eager"], local_batch=0)


def test_lockstep_device_staged_payloads(engines, data, jax_ref):
    """Tensor payloads are joined where they are (on the card for --staged)
    and give the numpy payloads' answers."""
    imgs = data["lock/1/3"]
    with LockstepServer(engines["eager"], local_batch=8) as srv:
        srv.warmup()
        labels, top, _ = srv.classify(torch.from_numpy(imgs), timeout=W.WAIT)
    _same(labels, top, jax_ref["xla"]["lock/1/3"], "staged")


def test_lockstep_kernel_path(engines, data, jax_ref):
    """Lockstep serving over the fused path (the plain twins here)."""
    with LockstepServer(engines["fused"], local_batch=8) as srv:
        srv.warmup()
        labels, top, _ = srv.classify(data["dptp/0"], timeout=W.WAIT)
    _same(labels, top, jax_ref["fused"]["dptp/0"], "fused")


def test_lockstep_queued_deadline_fails_fast(engines):
    from vit_tpu_torch.runtime.serving import DeadlineExceededError

    imgs = jimages.synth_images(2, JCFG, seed=4)
    with LockstepServer(engines["eager"], local_batch=8) as srv:
        srv.classify(imgs)  # warm
        fut = srv.submit(imgs, deadline_ms=0.0)
        with pytest.raises(DeadlineExceededError):
            fut.result(timeout=W.WAIT)
        labels, _, _ = srv.classify(imgs, timeout=W.WAIT)
        assert labels.shape == (2,)
    assert srv.stats.deadline_expired == 1
    assert srv.stats.latency.count >= 2  # per-request latency recorded


# -- four ranks -----------------------------------------------------------------


def test_idle_ticks_run_no_forward(group):
    """Half a second with no traffic on any rank (~100 ticks of 5 ms): the
    control all-reduce only, no forward on any rank."""
    assert [int(r["idle_forwards"]) for r in group] == [0, 0, 0, 0]


def test_each_rank_answers_its_own_rows(group, jax_ref):
    """Over dp 4 each rank read back its own slice: its answers are its own
    requests' (the JAX LockstepServer's on those images)."""
    for r, res in enumerate(group):
        for i in range(len(LOCK_SIZES)):
            _same(res[f"lock/{i}/labels"], res[f"lock/{i}/top"],
                  jax_ref["fused"][f"lock/{r}/{i}"], f"rank {r} request {i}")


def test_a_rank_that_stops_first_joins_later_forwards(group, jax_ref):
    """Rank 3 stops first; rank 0's late requests still run (rank 3 joins
    their forwards while it waits), and no rank returns from stop() before
    every rank has stopped."""
    assert int(group[3]["stopped_rank_forwards"]) >= 1
    for i in range(len(LATE_SIZES)):
        _same(group[0][f"late/{i}/labels"], group[0][f"late/{i}/top"],
              jax_ref["fused"][f"late/{i}"], f"late request {i}")
    done = float(group[0]["late_done_at"])
    assert all(float(r["stop_returned_at"]) >= done for r in group)


def test_lockstep_serves_correct_rows_on_dp_tp_mesh(group, jax_ref):
    """{dp: 2, tp: 2}: the front ends (tp index 0) each serve two requests
    of their own past the first half of their slice; their tp peers run the
    same rows and take no requests."""
    assert [bool(r["dptp/front"]) for r in group] == [True, False, True, False]
    for r in (0, 2):
        labels = np.concatenate([group[r]["dptp/0/labels"], group[r]["dptp/1/labels"]])
        top = np.concatenate([group[r]["dptp/0/top"], group[r]["dptp/1/top"]])
        _same(labels, top, jax_ref["dptp"][f"dptp/{r}"], f"front end {r}")
    for r in (1, 3):
        assert "requests enter at tp index 0" in str(group[r]["dptp/peer_submit"])


@pytest.mark.parametrize("name", list(W.DPTP_RUNS))
def test_mesh_server_on_dp2_tp2_matches_jax(group, jax_ref, name):
    """The InferenceServer over {dp: 2, tp: 2}: the lead's answers are the
    JAX mesh server's; every rank ran the lead's batches bit for bit."""
    for i, want in enumerate(jax_ref[name]):
        _same(group[0][f"{name}/{i}/labels"], group[0][f"{name}/{i}/top"], want,
              f"{name} request {i}")
    for r in group[1:]:
        assert list(r[f"{name}/digests"]) == list(group[0][f"{name}/digests"])


def test_serve_cli_selftest_dp2_tp2(group):
    """vit-tpu-torch-serve --selftest --dp 2 --tp 2 under torchrun: rank 0
    prints the mesh and one result line; every rank exits 0."""
    assert [int(r["cli_selftest/rc"]) for r in group] == [0, 0, 0, 0]
    out = str(group[0]["cli_selftest/stdout"])
    assert "mesh: {'dp': 2, 'tp': 2}" in out
    res = json.loads(out.strip().splitlines()[-1])
    assert res["value"] > 0 and res["requests"] == 3
    assert all(str(r["cli_selftest/stdout"]) == "" for r in group[1:])


# -- the serve CLI's --multihost ----------------------------------------------


def _weights(tmp_path):
    jckpt.save_npz(_tree(), str(tmp_path / "p0.npz"))
    return ["--config", W.CFG.name, "--weights", str(tmp_path / "p0.npz"), "--device", "cpu",
            "--dtype", "float32", "--multihost", "--local-batch", "8"]


@pytest.fixture
def tiny_config(monkeypatch):
    import vit_tpu_torch.config as tconfig

    monkeypatch.setitem(tconfig.CONFIGS, W.CFG.name, W.CFG)


def test_serve_cli_selftest_multihost_one_process(fresh_distributed, tiny_config, tmp_path,
                                                  capsys):
    """--multihost at one process: the process group is a no-op and the
    LockstepServer serves over a dp mesh of one."""
    from vit_tpu_torch.cli.serve import main

    assert main([*_weights(tmp_path), "--selftest", "4"]) == 0
    out = capsys.readouterr().out
    assert "multihost: 1 host(s), global dp=1, local_batch=8" in out
    res = json.loads(out.strip().splitlines()[-1])
    assert res["value"] > 0 and res["requests"] == 4


def test_serve_cli_multihost_daemon_answers_and_refuses_reload(fresh_distributed, tiny_config,
                                                               tmp_path, jax_ref, data):
    """The --multihost daemon at one process answers POST /classify (the
    JAX LockstepServer's answers) and POST /reload with 409."""
    from vit_tpu_torch.cli import serve

    args = serve.build_parser().parse_args([*_weights(tmp_path), "--allow-reload",
                                            "--port", "0"])
    cfg, ops, server = serve._build_server(args)
    listening = queue.Queue()
    t = threading.Thread(target=serve._http_daemon, args=(args, cfg, ops, server),
                         kwargs={"on_listen": listening.put}, daemon=True)
    t.start()
    httpd = listening.get(timeout=W.WAIT)
    imgs = data["late/0"]
    body = np.array(imgs.shape, dtype="<i4").tobytes() + imgs.astype("<f4").tobytes()
    replies = {}
    try:
        for path, payload in (("/classify", body), ("/reload", json.dumps({"weights": "x"}))):
            conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1],
                                              timeout=W.WAIT)
            conn.request("POST", path, body=payload)
            resp = conn.getresponse()
            replies[path] = (resp.status, json.loads(resp.read()))
            conn.close()
    finally:
        httpd.shutdown()
        t.join(timeout=W.WAIT)
    assert not t.is_alive()
    code, reply = replies["/classify"]
    assert code == 200
    _same([r["label"] for r in reply["results"]], [r["prob"] for r in reply["results"]],
          jax_ref["xla"]["late/0"], "daemon")
    assert replies["/reload"][0] == 409
    assert "multihost lockstep" in replies["/reload"][1]["error"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_cli_selftest_multihost_two_processes(tmp_path):
    """--multihost on two processes joined by explicit --coordinator
    --num-processes --process-id: each prints the multihost line and its
    own result line."""
    argv = [*_weights(tmp_path), "--selftest", "4", "--dist-backend", "gloo", "--coordinator",
            f"127.0.0.1:{_free_port()}", "--num-processes", "2"]
    outs = W.finish([W.spawn([sys.executable, W.__file__, "cli", "serve", *argv, "--process-id",
                              str(i)], tmp_path) for i in range(2)], 120)
    for rc, out, err in outs:
        assert rc == 0, err[-3000:]
        assert "multihost: 2 host(s), global dp=2, local_batch=8" in out
        res = json.loads(out.strip().splitlines()[-1])
        assert res["value"] > 0 and res["requests"] == 4


# -- the train CLI's --multihost refusals ---------------------------------------


@pytest.fixture
def two_process_mesh(monkeypatch):
    """resolve_multihost on a 2-rank dp mesh without a process group."""
    from vit_tpu_torch.cli import common
    from vit_tpu_torch.parallel.mesh import Mesh

    monkeypatch.setattr(common, "resolve_multihost",
                        lambda *a, **k: (Mesh({"dp": 2}, 0, {}), "cpu"))
    monkeypatch.setattr(torch.distributed, "all_reduce", lambda t, op=None, group=None: None)


@pytest.mark.parametrize("flags,message", [
    ([], "error: --multihost requires --data-dir or --image-dir (each host streams its own "
         "shard of the dataset)"),
    (["--data-dir", "D", "--tp", "2"], "error: --multihost supports dp only (tp=1): checkpoint "
     "round-trips assume host-replicated params"),
    (["--data-dir", "D", "--batch", "3"], "error: global --batch 3 must divide across 2 hosts"),
    (["--data-dir", "D", "--sp", "2"],
     "error: --sp composes with --dp only (no --pp/--tp/--multihost)"),
    (["--data-dir", "D", "--pp", "2"], "error: --pp with --multihost is not supported"),
    (["--data-dir", "D", "--config", "deit_b_16", "--distill-teacher", "t.npz"],
     "error: --distill-teacher composes with --dp/--tp only (no --pp/--sp/--multihost/"
     "--augment/--grad-accum/--dropout)"),
], ids=["no_data", "tp", "batch", "sp", "pp", "distill"])
def test_train_cli_multihost_refusals_in_jax_words(two_process_mesh, capsys, flags, message):
    from vit_tpu_torch.cli.train import main

    assert main(["--steps", "1", "--batch", "4", "--device", "cpu", "--multihost", *flags]) == 2
    err = capsys.readouterr()
    assert message in err.err
    if flags[:2] == ["--data-dir", "D"] and "--tp" not in flags:
        assert "multihost: 2 host(s), 2 global device(s)" in err.out

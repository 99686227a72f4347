"""The port's serving path — ``runtime/serving.py``, ``cli/serve.py`` and
``io/images.parse_image_bytes`` — against the JAX package's on the CPU.

The same seeded requests go to both packages' ``InferenceServer`` (the
port's ``eager`` against the JAX ``xla`` tier, and both ``fused``: the
port's kernels through their plain twins, the JAX package's Pallas kernels
in interpret mode), both selftests and both HTTP daemons.

Tolerances: fp32 on both sides, labels equal, top probabilities and
probabilities within 1e-6 absolute (fp32 logits agree to ~1e-6 and a
probability moves by at most its own size times that).  Every wait is
bounded (``result(timeout=...)``, HTTP client timeouts, thread joins), so a
wedged server fails its test instead of hanging the suite.
"""

import dataclasses
import http.client
import http.server as hs
import io
import json
import re
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.io import images as jimages
from vit_tpu.io import weights as wio
from vit_tpu.runtime import InferenceEngine as JaxEngine
from vit_tpu.runtime import serving as jserving
from vit_tpu_torch.io import images as timages
from vit_tpu_torch.runtime import serving as S
from vit_tpu_torch.runtime.engine import InferenceEngine

WAIT = 60  # s: the bound on every wait


@pytest.fixture(scope="module")
def tree(tiny_cfg):
    return wio.params_from_tensors(wio.synth_reference_tensors(tiny_cfg, seed=1), tiny_cfg)


@pytest.fixture(scope="module")
def engine(tiny_cfg, tree):
    return InferenceEngine(tiny_cfg, tree, dtype="float32", ops="eager", device="cpu",
                           batch_pad=8)


def _imgs(cfg, n, seed):
    return jimages.synth_images(n, cfg, seed=seed)


def _zeros(cfg, n):
    return np.zeros((n, 3, cfg.image_size, cfg.image_size), np.float32)


# -- the server against the JAX server --------------------------------------


@pytest.mark.parametrize("ops,jax_ops", [("eager", "xla"), ("fused", "fused")])
def test_server_matches_jax_server(tiny_cfg, tree, ops, jax_ops):
    """Coalesced variable-size requests: the port's answers are the JAX
    server's on the same params and requests, and each is the port
    engine's classify of that request alone."""
    reqs = [_imgs(tiny_cfg, n, 10 + n) for n in (1, 3, 2, 5, 4)]
    eng = InferenceEngine(tiny_cfg, tree, dtype="float32", ops=ops, device="cpu", batch_pad=8)
    jeng = JaxEngine(tiny_cfg, jax.tree.map(jnp.asarray, tree), dtype="float32", ops=jax_ops,
                     batch_pad=8)
    out = {}
    for name, server in (("port", S.InferenceServer(eng, max_batch=8, max_delay_ms=20.0)),
                         ("jax", jserving.InferenceServer(jeng, max_batch=8, max_delay_ms=20.0))):
        with server:
            futures = [server.submit(r, return_probs=(i % 2 == 0)) for i, r in enumerate(reqs)]
            out[name] = [f.result(timeout=WAIT) for f in futures]
    for i, (r, (labels, top, probs), (jl, jt, jp)) in enumerate(zip(reqs, out["port"],
                                                                       out["jax"])):
        np.testing.assert_array_equal(labels, np.asarray(jl))
        np.testing.assert_allclose(top, np.asarray(jt), atol=1e-6, rtol=0)
        want_labels, want_top = eng.classify(r)
        np.testing.assert_array_equal(labels, want_labels)
        np.testing.assert_allclose(top, want_top, atol=1e-6, rtol=0)
        if i % 2 == 0:  # probs only ship when asked for
            assert probs.shape == (len(r), tiny_cfg.num_classes)
            np.testing.assert_allclose(probs, np.asarray(jp), atol=1e-6, rtol=0)
        else:
            assert probs is None and jp is None


def test_serve_fn_ties_take_the_first_maximum():
    """The device-side argmax breaks ties as numpy and jnp do: the first
    maximum; the top probability is that label's."""
    identity = type("Engine", (), {"_forward": staticmethod(lambda p, x: x)})()
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [3.0, 3.0, 3.0, 3.0], [1.0, 0.0, 5.0, 5.0]])
    labels, top, probs = S.make_serve_fn(identity)(None, logits)
    np.testing.assert_array_equal(labels.numpy(), np.argmax(logits.numpy(), -1))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jnp.argmax(logits.numpy(), -1)))
    np.testing.assert_array_equal(top.numpy(), probs.numpy().max(-1))
    assert probs.dtype == torch.float32


def test_requests_coalesce_into_batches(engine, tiny_cfg):
    # 6 single-image requests submitted together with a generous delay
    # window must run in fewer batches than requests
    reqs = [_imgs(tiny_cfg, 1, i) for i in range(6)]
    with S.InferenceServer(engine, max_batch=8, max_delay_ms=200.0) as srv:
        srv.classify(reqs[0], timeout=WAIT)  # warm-up batch
        futures = [srv.submit(r) for r in reqs]
        for f in futures:
            f.result(timeout=WAIT)
        assert srv.stats.batches < 1 + len(reqs)
        assert srv.stats.images == 1 + len(reqs)


def test_concurrent_submitters(engine, tiny_cfg):
    errs = []

    def worker(seed):
        try:
            imgs = _imgs(tiny_cfg, 2, seed)
            labels, top, _ = srv.classify(imgs, timeout=WAIT)
            want, want_top = engine.classify(imgs)
            np.testing.assert_array_equal(labels, want)
            np.testing.assert_allclose(top, want_top, atol=1e-6, rtol=0)
        except Exception as e:  # surface into the main thread
            errs.append(e)

    with S.InferenceServer(engine, max_batch=4, max_delay_ms=5.0) as srv:
        threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
    assert not errs


def test_submit_validates_shape(engine, tiny_cfg):
    s = tiny_cfg.image_size
    with S.InferenceServer(engine) as srv:
        with pytest.raises(ValueError):
            srv.submit(np.zeros((3, 3)))
        # a malformed-dimension request fails itself, not the batch it
        # would have joined
        with pytest.raises(ValueError, match="expected images of shape"):
            srv.submit(np.zeros((1, 3, s // 2, s // 2), np.float32))
        with pytest.raises(ValueError, match="expected images of shape"):
            srv.submit(torch.zeros((1, 1, s, s)))
        labels, _, _ = srv.submit(_zeros(tiny_cfg, 1)).result(timeout=WAIT)
        assert len(labels) == 1
    with pytest.raises(RuntimeError):
        srv.submit(_zeros(tiny_cfg, 1))  # stopped server


def test_submit_rejects_oversize_request(engine, tiny_cfg):
    srv = S.InferenceServer(engine, max_batch=4)
    srv._running = True  # white-box: no dispatcher
    try:
        with pytest.raises(ValueError, match="exceeds max_batch"):
            srv.submit(_zeros(tiny_cfg, 5))
    finally:
        srv._running = False


def test_submit_sheds_load_past_max_queue(engine, tiny_cfg):
    srv = S.InferenceServer(engine, max_batch=4, max_queue_images=6)
    srv._running = True  # white-box: no dispatcher, so nothing drains
    try:
        imgs = _zeros(tiny_cfg, 4)
        srv.submit(imgs)  # pending 4 <= 6
        with pytest.raises(S.ServerOverloadedError, match="backlog 4"):
            srv.submit(imgs)  # 4 + 4 > 6
        srv.submit(imgs[:2])  # exactly at the cap is allowed
    finally:
        srv._running = False


def test_submit_after_stop_raises_not_hangs(engine, tiny_cfg):
    srv = S.InferenceServer(engine, max_batch=4)
    srv.start()
    imgs = _zeros(tiny_cfg, 2)
    srv.classify(imgs, timeout=WAIT)
    srv.stop()
    with pytest.raises(RuntimeError, match="not started"):
        srv.submit(imgs)
    assert srv._q.empty()  # nothing stranded behind _STOP
    assert srv._pending == 0


def test_cancelled_future_does_not_wedge_server(engine, tiny_cfg):
    imgs = _zeros(tiny_cfg, 2)
    with S.InferenceServer(engine, max_batch=4, max_delay_ms=1.0,
                           max_queue_images=64) as srv:
        for _ in range(5):
            srv.submit(imgs).cancel()  # races dispatch; either state is fine
        labels, _, _ = srv.classify(imgs, timeout=WAIT)
        assert len(labels) == 2
    assert srv._pending == 0


def test_failed_dispatch_releases_backlog_and_server_survives(engine, tiny_cfg):
    """A batch whose dispatch raises fails its own futures, releases its
    backlog accounting, and the server serves the next batch."""
    srv = S.InferenceServer(engine, max_batch=4, max_delay_ms=1.0, max_queue_images=8)
    serve_fn = srv._serve_fn
    calls = []

    def fail_once(params, x):
        calls.append(x.shape[0])
        if len(calls) == 1:
            raise RuntimeError("dispatch failed")
        return serve_fn(params, x)

    srv._serve_fn = fail_once
    with srv:
        with pytest.raises(RuntimeError, match="dispatch failed"):
            srv.classify(_zeros(tiny_cfg, 2), timeout=WAIT)
        assert srv._pending == 0
        labels, _, _ = srv.classify(_zeros(tiny_cfg, 2), timeout=WAIT)
        assert len(labels) == 2
    assert srv._pending == 0 and len(calls) == 2


def test_queued_request_past_deadline_fails(engine, tiny_cfg):
    imgs = _imgs(tiny_cfg, 1, 3)
    with S.InferenceServer(engine, max_batch=8, max_delay_ms=1.0) as srv:
        srv.classify(imgs, timeout=WAIT)
        fut = srv.submit(imgs, deadline_ms=0.0)  # expired when the dispatcher pulls it
        with pytest.raises(S.DeadlineExceededError, match="deadline"):
            fut.result(timeout=WAIT)
        labels, _, _ = srv.classify(imgs, timeout=WAIT)
        assert labels.shape == (1,)
        assert srv._pending == 0
    assert srv.stats.deadline_expired == 1


def test_server_swap_params_hot_reload(tiny_cfg, tree):
    new = wio.params_from_tensors(wio.synth_reference_tensors(tiny_cfg, seed=7), tiny_cfg)
    eng = InferenceEngine(tiny_cfg, tree, dtype="float32", ops="eager", device="cpu",
                          batch_pad=8)
    fresh = InferenceEngine(tiny_cfg, new, dtype="float32", ops="eager", device="cpu",
                            batch_pad=8)
    imgs = _imgs(tiny_cfg, 3, 11)
    want_old, want_new = eng.classify(imgs), fresh.classify(imgs)
    with S.InferenceServer(eng, max_batch=8, max_delay_ms=2.0) as srv:
        l0, _, _ = srv.classify(imgs, timeout=WAIT)
        np.testing.assert_array_equal(l0, want_old[0])
        srv.swap_params(new)
        l1, t1, _ = srv.classify(imgs, timeout=WAIT)
        np.testing.assert_array_equal(l1, want_new[0])
        np.testing.assert_allclose(t1, want_new[1], atol=1e-6, rtol=0)
        bad = dict(new, head={"kernel": np.zeros((tiny_cfg.embed_dim, 3), np.float32),
                              "bias": np.zeros((3,), np.float32)})
        with pytest.raises(ValueError, match="shapes"):
            srv.swap_params(bad)
        l2, _, _ = srv.classify(imgs, timeout=WAIT)  # the new weights keep serving
        np.testing.assert_array_equal(l2, want_new[0])
        assert srv.stats.requests == 3


def test_stats_recorded_before_future_resolves(engine, tiny_cfg):
    """The completer records the whole batch's stats before resolving any
    future, so a selftest swapping ``server.stats`` the moment classify()
    returns never sees warmup samples in the fresh window."""
    with S.InferenceServer(engine, max_batch=8, max_delay_ms=1.0) as srv:
        old = {}

        def swap(_fut):  # runs in the completer thread, mid-resolve
            old["stats"] = srv.stats
            srv.stats = S.ServerStats()

        fut = srv.submit(_imgs(tiny_cfg, 2, 3))
        fut.add_done_callback(swap)
        fut.result(timeout=WAIT)
        time.sleep(0.2)  # let the completer finish the batch
        assert (old["stats"].requests, old["stats"].images, old["stats"].batches,
                old["stats"].latency.count) == (1, 2, 1, 1)
        fresh = srv.stats
        assert fresh.requests == fresh.images == fresh.latency.count == 0
        srv.classify(_imgs(tiny_cfg, 1, 1), timeout=WAIT)
    assert srv.stats.latency.count == 1 and srv.stats.latency.quantile(0.5) > 0


def test_device_tensor_payloads_join_with_numpy(engine, tiny_cfg):
    """Tensor payloads (the --staged selftest's) join with numpy ones in
    one batch and give the same answers."""
    a, b = _imgs(tiny_cfg, 2, 21), _imgs(tiny_cfg, 3, 22)
    with S.InferenceServer(engine, max_batch=8, max_delay_ms=100.0) as srv:
        fa = srv.submit(torch.from_numpy(a))
        fb = srv.submit(b)
        (la, ta, _), (lb, tb, _) = fa.result(timeout=WAIT), fb.result(timeout=WAIT)
    for got, want in (((la, ta), engine.classify(a)), ((lb, tb), engine.classify(b))):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)


def test_measure_throughput_and_steady_state(engine, tiny_cfg):
    srv = S.InferenceServer(engine, max_batch=4, max_delay_ms=1.0, max_queue_images=4)
    with srv:
        # 3 requests x 4 images > the 4-image cap: would shed mid-submit if
        # the helper did not lift it
        ips, total = S.measure_throughput(srv, [4, 4, 4], tiny_cfg)
        assert total == 12 and ips > 0 and srv.max_queue_images == 4
        sizes = [1, 2, 3, 2]
        rate, total, offered = S.measure_steady_state(srv, sizes, tiny_cfg, rate_rps=200.0)
        assert rate > 0 and total == sum(sizes) and offered > 0
        # stats were reset after warmup: exactly the paced requests remain
        assert srv.stats.requests == srv.stats.latency.count == len(sizes)
        # above capacity degrades to saturation, never sheds its own stream
        rate, total, _ = S.measure_steady_state(srv, [1] * 12, tiny_cfg, rate_rps=1e6)
        assert rate > 0 and total == 12 and srv.max_queue_images == 4
        with pytest.raises(ValueError):
            S.measure_steady_state(srv, sizes, tiny_cfg, rate_rps=0.0)


# -- exact matches with the JAX package --------------------------------------


@pytest.mark.parametrize("samples_ms", [
    [2, 2, 2, 2, 2, 2, 2, 2, 2, 400],
    [0.5, 1.0, 3.7, 12.0, 12.0, 80.0, 260.0, 9000.0, 20000.0],
    [],
], ids=["skewed", "spread", "empty"])
def test_latency_histogram_matches_jax(samples_ms):
    got, want = S.LatencyHistogram(), jserving.LatencyHistogram()
    for ms in samples_ms:
        got.record(ms / 1e3)
        want.record(ms / 1e3)
    assert got.snapshot() == want.snapshot()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert got.quantile(q) == want.quantile(q)
    if samples_ms == [2, 2, 2, 2, 2, 2, 2, 2, 2, 400]:
        assert 0.001 <= got.quantile(0.5) <= 0.0025 and 0.25 <= got.quantile(0.99) <= 0.5


@pytest.mark.parametrize("body,ok", [
    ("good", True), (b"\x01\x00", False), ("negative", False), ("ragged", False),
], ids=["good", "truncated", "negative", "ragged"])
def test_parse_image_bytes_matches_jax(tiny_cfg, body, ok):
    imgs = _imgs(tiny_cfg, 3, 5)
    header = np.array(imgs.shape, dtype="<i4").tobytes()
    data = {
        "good": header + imgs.astype("<f4").tobytes(),
        "negative": np.array([-1, 3, 4, 4], dtype="<i4").tobytes(),
        "ragged": header + imgs.astype("<f4").tobytes()[:-3],
    }.get(body, body)
    if ok:
        got = timages.parse_image_bytes(data)
        np.testing.assert_array_equal(got, jimages.parse_image_bytes(data))
        np.testing.assert_array_equal(got, imgs)
        return
    with pytest.raises(ValueError) as want:
        jimages.parse_image_bytes(data)
    with pytest.raises(ValueError) as got:
        timages.parse_image_bytes(data)
    assert str(got.value) == str(want.value)


class _RngSpy:
    """A numpy Generator that records what ``exponential`` draws."""

    def __init__(self, rng, log):
        self._rng, self._log = rng, log

    def exponential(self, *a, **k):
        out = self._rng.exponential(*a, **k)
        self._log.append(out)
        return out

    def __getattr__(self, name):
        return getattr(self._rng, name)


def test_steady_state_gaps_match_jax(engine, tiny_cfg, tree, monkeypatch):
    """measure_steady_state's seeded Poisson gaps, list for list."""
    log = []
    real = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng", lambda *a, **k: _RngSpy(real(*a, **k), log))
    sizes = [1, 3, 2, 4, 1]
    jeng = JaxEngine(tiny_cfg, jax.tree.map(jnp.asarray, tree), dtype="float32", batch_pad=8)
    for mod, eng in ((S, engine), (jserving, jeng)):
        with mod.InferenceServer(eng, max_batch=8, max_delay_ms=1.0) as srv:
            mod.measure_steady_state(srv, sizes, tiny_cfg, rate_rps=2000.0, seed=3)
    assert len(log) == 2 and len(log[0]) == len(sizes)
    np.testing.assert_array_equal(log[0], log[1])


@pytest.fixture
def configs(tiny_cfg, monkeypatch):
    """``vit_tiny_test`` in both packages' config tables."""
    import vit_tpu.config as jconfig
    import vit_tpu_torch.config as tconfig

    monkeypatch.setitem(jconfig.CONFIGS, "vit_tiny_test", tiny_cfg)
    monkeypatch.setitem(tconfig.CONFIGS, "vit_tiny_test",
                        tconfig.ViTConfig(**dataclasses.asdict(tiny_cfg)))


@pytest.fixture
def net(tiny_cfg, tmp_path):
    """Reference-format weight directories: seed 1 (``NetA``), seed 7 (``NetB``)."""
    for seed, name in ((1, "NetA"), (7, "NetB")):
        wio.save_reference_weights(wio.synth_reference_tensors(tiny_cfg, seed=seed),
                                   tmp_path / name, tiny_cfg)
    return tmp_path


def _run_base(net):
    return ["--config", "vit_tiny_test", "--weights", str(net / "NetA"), "--dtype", "float32",
            "--max-batch", "8", "--batch-pad", "8"]


JAX_EXTRA = ["--ops", "xla", "--no-compile-cache"]
PORT_EXTRA = ["--ops", "eager", "--device", "cpu"]


@pytest.mark.parametrize("extra", [[], ["--staged"], ["--selftest-rate", "500"]],
                         ids=["saturated", "staged", "paced"])
def test_selftest_sizes_and_json_keys_match_jax(configs, net, monkeypatch, capsys, extra):
    """The selftest's request sizes list for list, and its JSON line's keys."""
    from vit_tpu.cli import serve as jserve
    from vit_tpu_torch.cli import serve as tserve

    seen = {}
    for name, cli, mod, more in (("port", tserve, S, PORT_EXTRA),
                                 ("jax", jserve, jserving, JAX_EXTRA)):
        def fake(server, sizes, cfg, *rate, device_staged=False, seed=0, _name=name):
            seen[_name] = list(sizes)
            return (123.0, sum(sizes), 45.0) if rate else (123.0, sum(sizes))

        monkeypatch.setattr(mod, "measure_throughput", fake)
        monkeypatch.setattr(mod, "measure_steady_state", fake)
        assert cli.main([*_run_base(net), *more, "--selftest", "17", *extra]) == 0
        seen[name + "_json"] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 17
    got, want = seen["port_json"], seen["jax_json"]
    assert list(got) == list(want)
    assert {k: v for k, v in got.items() if k != "ops"} == {k: v for k, v in want.items()
                                                            if k != "ops"}


def test_serve_cli_selftest_on_cpu(configs, net, capsys):
    from vit_tpu_torch.cli.serve import main

    for extra, mode in (([], "saturation"), (["--staged"], "saturation"),
                        (["--selftest-rate", "200"], "steady")):
        assert main([*_run_base(net), "--device", "cpu", "--selftest", "5", *extra]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["value"] > 0 and out["requests"] == 5 and out["mode"] == mode
        assert out["ops"] == "eager" and out["latency_p99_ms"] > 0
        assert out["staged"] == ("--staged" in extra)


@pytest.mark.parametrize("extra,msg", [
    (["--tp", "2"], "--tp"), (["--dp", "2"], "--dp"), (["--multihost"], "--multihost"),
    (["--coordinator", "h:1"], "--coordinator"), (["--num-processes", "2"], "--num-processes"),
    (["--process-id", "0"], "--process-id"), (["--local-batch", "8"], "--local-batch"),
    (["--tick-ms", "10"], "--tick-ms"),
    (["--tome", "-1"], "--tome must be >= 0"),
    (["--tome", "2", "--ops", "per_op"], "--tome (token merging) needs --ops fused, quant"),
], ids=["tp", "dp", "multihost", "coordinator", "num_processes", "process_id", "local_batch",
        "tick_ms", "tome_negative", "tome_per_op"])
def test_serve_cli_refusals_exit_2(configs, net, capsys, extra, msg):
    from vit_tpu_torch.cli.serve import main

    assert main([*_run_base(net), "--device", "cpu", "--selftest", "2", *extra]) == 2
    err = capsys.readouterr().err
    assert msg in err
    if msg.startswith("--") and "tome" not in msg:
        assert "ROADMAP.md item 14" in err


def test_serve_cli_cuda_without_a_card_fails(configs, net, capsys, monkeypatch):
    """--device cuda (the default) without a card exits non-zero with an
    error; nothing runs on the CPU instead."""
    from vit_tpu_torch.cli.serve import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main([*_run_base(net), "--selftest", "2"]) != 0
    assert "error:" in capsys.readouterr().err


def _start_daemon(cli, argv, monkeypatch):
    """Run ``cli``'s HTTP daemon in a thread on an ephemeral port ->
    (args, port, httpd, thread); the port answers once warmup is done."""
    args = cli.build_parser().parse_args([*argv, "--port", "0"])
    cfg, ops, server = cli._build_server(args)
    bound = []
    orig = hs.ThreadingHTTPServer.__init__

    def capture(self, *a, **k):
        orig(self, *a, **k)
        bound.append(self)

    monkeypatch.setattr(hs.ThreadingHTTPServer, "__init__", capture)
    t = threading.Thread(target=cli._http_daemon, args=(args, cfg, ops, server), daemon=True)
    t.start()
    for _ in range(WAIT * 20):
        if bound:
            break
        time.sleep(0.05)
    monkeypatch.setattr(hs.ThreadingHTTPServer, "__init__", orig)
    return args, bound[0].server_address[1], bound[0], t


def _http(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _no_addresses(payload: dict) -> str:
    """A JSON answer with object addresses (PIL's message names its
    BytesIO) blanked."""
    return re.sub(r"0x[0-9a-f]+", "0x", json.dumps(payload))


def _metric_names(text: str) -> list:
    return sorted({line.split("{")[0].split()[0] for line in text.splitlines()
                   if line and not line.startswith("#")})


def test_http_daemons_match(configs, net, tiny_cfg, monkeypatch):
    """The same requests to both daemons: the same status codes and JSON
    (probabilities within 1e-6), the same /healthz keys and /metrics names,
    the same /reload codes (403, 200, 400, 500), the answers after a reload
    a seed-7 engine's."""
    from PIL import Image

    from vit_tpu.cli import serve as jserve
    from vit_tpu_torch.cli import serve as tserve

    daemons = {"port": _start_daemon(tserve, [*_run_base(net), *PORT_EXTRA], monkeypatch),
               "jax": _start_daemon(jserve, [*_run_base(net), *JAX_EXTRA], monkeypatch)}
    imgs = _imgs(tiny_cfg, 3, 5)
    body = np.array(imgs.shape, dtype="<i4").tobytes() + imgs.astype("<f4").tobytes()
    png = io.BytesIO()
    Image.fromarray((np.random.default_rng(9).random((48, 48, 3)) * 255).astype(np.uint8)
                    ).save(png, format="PNG")
    (net / "bad.npz").write_bytes(b"PK\x03\x04 not a whole archive")
    reload_body = lambda path: json.dumps({"weights": str(path)})  # noqa: E731
    steps = [
        ("POST", "/classify", body, {}),
        ("POST", "/classify", png.getvalue(), {"Content-Type": "image/png"}),
        ("POST", "/classify", b"not an image at all", {"Content-Type": "image/jpeg"}),
        ("POST", "/classify", body[:-4], {}),
        ("POST", "/classify", body, {"X-Deadline-Ms": "0"}),
        *[("POST", "/classify", body, {"X-Deadline-Ms": bad})
          for bad in ("nan", "inf", "-5", "soon", "")],
        ("POST", "/classify", body, {"X-Deadline-Ms": "60000"}),
        ("GET", "/nowhere", None, {}),
        ("POST", "/reload", reload_body(net / "NetB"), {}),  # 403: not enabled
        "enable reload",
        ("POST", "/reload", reload_body(net / "Nope"), {}),
        ("POST", "/reload", b"{}", {}),
        *[("POST", "/reload", shape, {}) for shape in (b"null", b"[1]", b'"x"')],
        ("POST", "/reload", reload_body(net / "bad.npz"), {}),  # 500
        ("POST", "/reload", reload_body(net / "NetB"), {}),  # 200
        ("POST", "/classify", body, {}),
    ]
    answers = {name: [] for name in daemons}
    try:
        for step in steps:
            for name, (args, port, _, _) in daemons.items():
                if step == "enable reload":
                    args.allow_reload = True
                    continue
                status, data = _http(port, *step[:3], headers=step[3])
                answers[name].append((status, json.loads(data)))
            if step != "enable reload":
                (ps, pj), (js, jj) = answers["port"][-1], answers["jax"][-1]
                assert ps == js, (step[:2], step[3], ps, js, pj, jj)
                if ps == 200 and "results" in pj:
                    assert [(r["index"], r["label"], r["name"]) for r in pj["results"]] == \
                        [(r["index"], r["label"], r["name"]) for r in jj["results"]]
                    np.testing.assert_allclose([r["prob"] for r in pj["results"]],
                                               [r["prob"] for r in jj["results"]],
                                               atol=1e-6, rtol=0)
                elif step[1] == "/reload" and ps == 200:
                    assert pj["ok"] is True and pj == jj
                elif ps == 500 or (step[1] == "/reload" and ps == 400
                                   and "body must be" not in jj["error"]):
                    # each package's own repr, or its own loader's message
                    assert list(pj) == list(jj) == ["error"]
                else:
                    assert _no_addresses(pj) == _no_addresses(jj), (step[:2], pj, jj)
        statuses = [s for s, _ in answers["port"]]
        assert statuses == [200, 200, 400, 400, 504, 400, 400, 400, 400, 400, 200, 404, 403,
                            400, 400, 400, 400, 400, 500, 200, 200]
        want_b = InferenceEngine(
            tiny_cfg, wio.load_reference_weights(net / "NetB", tiny_cfg), dtype="float32",
            ops="eager", device="cpu").classify(imgs)[0]
        assert [r["label"] for r in answers["port"][-1][1]["results"]] == [int(x) for x in want_b]
        health = {name: json.loads(_http(port, "GET", "/healthz")[1])
                  for name, (_, port, _, _) in daemons.items()}
        assert list(health["port"]) == list(health["jax"])
        for key in ("ok", "model", "requests", "images", "batches", "deadline_expired"):
            assert health["port"][key] == health["jax"][key], key
        metrics = {name: _http(port, "GET", "/metrics")[1].decode()
                   for name, (_, port, _, _) in daemons.items()}
        assert _metric_names(metrics["port"]) == _metric_names(metrics["jax"])
        assert "vit_tpu_deadline_expired_total 1" in metrics["port"]
        assert 'vit_tpu_request_latency_seconds_bucket{le="+Inf"} 4' in metrics["port"]
    finally:
        for _, _, httpd, t in daemons.values():
            httpd.shutdown()
            t.join(timeout=WAIT)
    assert not any(t.is_alive() for _, _, _, t in daemons.values())


def test_sigterm_handler_drains_daemon(engine, tiny_cfg):
    """The SIGTERM handler stops the HTTP listener; accepted requests then
    resolve through the server's FIFO drain (stop())."""
    from vit_tpu_torch.cli.serve import _drain_on_sigterm

    class Quiet(hs.BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):
            pass

    httpd = hs.ThreadingHTTPServer(("127.0.0.1", 0), Quiet)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    restore = _drain_on_sigterm(httpd)
    try:
        with S.InferenceServer(engine, max_batch=8, max_delay_ms=1.0) as srv:
            fut = srv.submit(_imgs(tiny_cfg, 2, 7))
            handler = signal.getsignal(signal.SIGTERM)
            handler(signal.SIGTERM, None)  # as the OS would deliver it
            t.join(timeout=WAIT)
            assert not t.is_alive()  # listener stopped...
            labels, _, _ = fut.result(timeout=WAIT)  # ...but work drained
            assert labels.shape == (2,)
    finally:
        restore()
        httpd.server_close()
    assert signal.getsignal(signal.SIGTERM) != handler  # restored

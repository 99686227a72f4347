"""The port's ``InferenceServer`` over a mesh engine (``runtime/serving.py``:
the lead rank serves, the others follow) and the serve CLI's ``--tp``
daemon, against the JAX package's ``InferenceServer`` over its mesh
engines on the CPU (the virtual 8-device mesh, Pallas in interpret mode);
the port in one 2-rank gloo group (``torch_serve_worker.py mesh``, started
once for the module).  Then the train CLI's ``--multihost``: two processes
joined by explicit coordinator flags against the group's ``--dp 2`` run.

Tolerances (``tests/test_torch_parallel.py``'s for fp32 mesh forwards):
labels equal, top probabilities and probabilities within 1e-5; a
follower's batch is the lead's bit for bit; the ``--multihost`` run's
losses and saved params the ``--dp 2`` run's bit for bit.
"""

import dataclasses
import json
import socket
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vit_tpu.config import VIT_B_16
from vit_tpu.io import checkpoint as jckpt
from vit_tpu.io import images as jimages
from vit_tpu.io import weights as wio
from vit_tpu.io.images import save_image_bin
from vit_tpu.parallel import make_mesh as jmake_mesh
from vit_tpu.runtime import InferenceEngine as JaxEngine
from vit_tpu.runtime import serving as jserving

import torch_serve_worker as W

pytestmark = pytest.mark.skipif(jax.device_count() < 4, reason="needs 4 (virtual) devices")

JCFG = dataclasses.replace(VIT_B_16, **{k: getattr(W.CFG, k) for k in (
    "image_size", "patch_size", "embed_dim", "depth", "num_heads", "num_classes", "name")})
SIZES = (1, 3, 2, 5, 4, 8)  # the requests: coalesced up to max_batch 8, padded to 4 and 8
TOL = 1e-5


def _tree(seed):
    return wio.params_from_tensors(wio.synth_reference_tensors(JCFG, seed=seed), JCFG)


@pytest.fixture(scope="module")
def data():
    return {"reqs": [jimages.synth_images(n, JCFG, seed=30 + i) for i, n in enumerate(SIZES)],
            "daemon": jimages.synth_images(5, JCFG, seed=5)}


@pytest.fixture(scope="module")
def group(tmp_path_factory, data):
    """The two ranks' results of ``torch_serve_worker.py mesh``, and its dir."""
    d = tmp_path_factory.mktemp("serve_mesh")
    for seed in (0, 1):
        jckpt.save_npz(_tree(seed), str(d / f"p{seed}.npz"))
    rng = np.random.default_rng(3)
    (d / "shards").mkdir()
    for i, n in enumerate((7, 9)):
        save_image_bin(rng.normal(size=(n, 3, 32, 32)).astype(np.float32),
                       d / "shards" / f"s{i}.bin")
        rng.integers(0, JCFG.num_classes, n).astype("<i4").tofile(d / "shards" / f"s{i}.labels.bin")
    arrays = {f"reqs/{i}": r for i, r in enumerate(data["reqs"])}
    arrays.update(n_reqs=np.int32(len(SIZES)), daemon_images=data["daemon"])
    np.savez(d / "in.npz", **arrays)
    return W.start_group("mesh", d, 2), d


def _jax_server(axes, ops, seed, reqs):
    """The JAX InferenceServer over its mesh engine (or one device: axes
    None) -> each request's (labels, top, probs)."""
    mesh = jmake_mesh(axes, jax.devices()[:axes["dp"] * axes["tp"]]) if axes else None
    eng = JaxEngine(JCFG, jax.tree.map(jnp.asarray, _tree(seed)), dtype="float32", ops=ops,
                    batch_pad=4, mesh=mesh)
    with jserving.InferenceServer(eng, max_batch=8, max_delay_ms=20.0) as srv:
        futures = [srv.submit(r, return_probs=True) for r in reqs]
        return [tuple(np.asarray(v) for v in f.result(timeout=W.WAIT)) for f in futures]


@pytest.fixture(scope="module")
def jax_ref(data):
    """The JAX package's servers on the same requests, each run once."""
    reqs = data["reqs"]
    out = {name: _jax_server({"dp": axes.get("dp", 1), "tp": axes.get("tp", 1)}, ops, 0, reqs)
           for name, (axes, ops) in W.MESH_RUNS.items()}
    out["seed1"] = _jax_server(None, "fused", 1, reqs)
    out["daemon"] = [_jax_server(None, "fused", s, [data["daemon"]])[0] for s in (0, 1)]
    return out


def _same(got_labels, got_top, want, what, got_probs=None):
    np.testing.assert_array_equal(got_labels, want[0], err_msg=what)
    np.testing.assert_allclose(got_top, want[1], atol=TOL, rtol=0, err_msg=what)
    if got_probs is not None:
        np.testing.assert_allclose(got_probs, want[2], atol=TOL, rtol=0, err_msg=what)


@pytest.mark.parametrize("name", list(W.MESH_RUNS))
def test_mesh_server_matches_jax_server(group, jax_ref, name):
    """dp 2 and tp 2, fused and quant: each answer of the lead is the JAX
    mesh server's (probabilities where asked for, none elsewhere)."""
    ranks, _ = group
    res = ranks[0]
    for i, want in enumerate(jax_ref[name]):
        probs = res.get(f"{name}/{i}/probs")
        assert (probs is None) == (i % 2 == 1)
        _same(res[f"{name}/{i}/labels"], res[f"{name}/{i}/top"], want, f"{name} request {i}",
              probs)


@pytest.mark.parametrize("name", list(W.MESH_RUNS))
def test_followers_receive_the_leads_batches_bit_for_bit(group, name):
    """Every forward the lead ran (warmup's two padded sizes, then the
    batches), the follower ran on the same bytes, in the same order."""
    ranks, _ = group
    lead, follower = ranks[0][f"{name}/digests"], ranks[1][f"{name}/digests"]
    assert len(lead) >= 2 + 2  # warmup at 4 and 8 rows, then at least two batches (24 images)
    assert list(lead) == list(follower)


def test_reload_on_tp2_gives_seed1_answers_on_every_rank(group, jax_ref):
    """The reload rides at its place in the dispatch order: afterwards the
    answers are a seed-1 server's, and every rank holds its seed-1 shard."""
    ranks, _ = group
    for i, want in enumerate(jax_ref["seed1"]):
        _same(ranks[0][f"tp2_reloaded/{i}/labels"], ranks[0][f"tp2_reloaded/{i}/top"], want,
              f"reloaded request {i}", ranks[0][f"tp2_reloaded/{i}/probs"])
    assert all(bool(r["tp2_params_seed1"]) for r in ranks)


def test_reload_failing_on_one_rank_keeps_every_rank_on_old_weights(group):
    """Rank 1 cannot load the path, rank 0 can: rank 0 answers a client
    error, and both ranks keep the seed-1 weights (the answers unchanged)."""
    ranks, _ = group
    res = ranks[0]
    assert "failed on another rank; every rank keeps the old weights" in str(
        res["failed_reload/error"])
    for i in range(len(SIZES)):
        np.testing.assert_array_equal(res[f"tp2_after_failed/{i}/labels"],
                                      res[f"tp2_reloaded/{i}/labels"])
        np.testing.assert_array_equal(res[f"tp2_after_failed/{i}/top"],
                                      res[f"tp2_reloaded/{i}/top"])
    assert all(bool(r["tp2_params_seed1"]) for r in ranks)


def test_swap_params_on_a_mesh_refuses(group):
    ranks, _ = group
    assert all("reload(path) instead" in str(r["swap_params_on_mesh"]) for r in ranks)


def test_daemon_on_tp2_mesh(group, jax_ref):
    """vit-tpu-torch-serve --tp 2: rank 0's daemon answers POST /classify
    as a one-device server does, POST /reload to seed 1 answers 200 and
    the answers after it are seed 1's; rank 1 followed and returned."""
    ranks, _ = group
    res = ranks[0]
    assert [int(res[f"daemon/{n}/code"]) for n in ("classify", "reload", "classify_seed1")] == \
        [200, 200, 200]
    for name, want in zip(("classify", "classify_seed1"), jax_ref["daemon"]):
        _same(res[f"daemon/{name}/labels"], res[f"daemon/{name}/top"], want, name)
    assert not res["daemon/alive"]
    assert "hot-swapped weights from" in str(res["daemon/stdout"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_cli_multihost_matches_dp2(group):
    """vit-tpu-torch-train --multihost on two processes joined by explicit
    --coordinator/--num-processes/--process-id on --data-dir: the losses
    and the saved params are the --dp 2 torchrun run's, bit for bit."""
    ranks, d = group
    assert int(ranks[0]["train_dp2/rc"]) == 0
    port = _free_port()
    argv = [*W.train_argv(d, "multihost"), "--multihost", "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", "2", "--dist-backend", "gloo"]
    outs = W.finish([W.spawn([sys.executable, W.__file__, "cli", "train", *argv,
                              "--process-id", str(i)], d) for i in range(2)], 120)
    assert [rc for rc, _, _ in outs] == [0, 0], outs[0][2][-3000:] + outs[1][2][-3000:]
    assert all("multihost: 2 host(s), 2 global device(s)" in out for _, out, _ in outs)
    losses = {name: [json.loads(ln)["loss"]
                     for ln in (d / f"{name}.jsonl").read_text().splitlines()]
              for name in ("dp2", "multihost")}
    assert len(losses["dp2"]) == 3 and losses["multihost"] == losses["dp2"]
    got, want = jckpt.load_npz(str(d / "multihost.npz")), jckpt.load_npz(str(d / "dp2.npz"))
    for (k, a), (_, b) in zip(sorted(_flat(got).items()), sorted(_flat(want).items())):
        np.testing.assert_array_equal(a, b, err_msg=k)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out

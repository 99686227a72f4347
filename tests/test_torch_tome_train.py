"""Training with token merging (``models/tome.forward_train``,
``vit-tpu-torch-train --tome``) against the JAX package on the CPU, and the
train CLI's repairs beside it: ``--num-classes`` re-initializes a
distilled backbone's ``head_dist`` too, and the loop bounds the batches it
keeps staged on the device.

``forward_train`` runs the port's kernels through their plain twins (CPU
tensors) and the JAX one its Pallas kernels in interpret mode.  The per-
layer dropout seeds are carried across by monkeypatching
``vit.layer_seeds`` to the JAX forward's (``jax.random.bits`` of
``fold_in(rng, l)``), and the embedding-site dropout, whose masks come from
each framework's own generator, is set in both packages to one numpy mask
by monkeypatching their ``vit._dropout``.  The matching is held to a margin
first (``test_torch_tome.assert_margins``).

Tolerances: the loss 1e-5 relative and every gradient 1e-4 of its leaf's
scale — the JAX package's bars for its kernel gradients against autodiff.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_tpu.models.vit as jvit
from vit_tpu.models import tome as jtome_model
from vit_tpu_torch.eval import tome_stages
from vit_tpu_torch.io.params import params_from_numpy
from vit_tpu_torch.models import tome as ttome_model
from vit_tpu_torch.models import vit as tvit
from vit_tpu_torch.runtime import trainer

from test_torch_tome import assert_margins


@pytest.fixture(scope="module")
def cfg(tiny_cfg):
    return dataclasses.replace(tiny_cfg, depth=3, image_size=64, patch_size=8,
                               name="vit_tome_test")


@pytest.fixture(scope="module")
def jparams(cfg):
    return jax.tree.map(lambda a: np.array(a, np.float32), jvit.init_params(jax.random.key(0), cfg))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("dropout,drop_path", [(0.0, 0.0), (0.1, 0.1), (0.0, 0.2)],
                         ids=["plain", "dropout_droppath", "droppath_lerp"])
def test_forward_train_loss_and_grads_match_jax(cfg, jparams, monkeypatch, dropout, drop_path):
    cfg = dataclasses.replace(cfg, dropout=dropout, drop_path=drop_path)
    regularized = bool(dropout or drop_path)
    x = np.random.default_rng(3).normal(size=(2, 3, 64, 64)).astype(np.float32)
    weight = np.random.default_rng(5).normal(size=(2, cfg.num_classes)).astype(np.float32)
    key = jax.random.key(11)
    if dropout:
        mask = ((np.random.default_rng(9).random((2, cfg.seq_len, cfg.embed_dim)) >= dropout)
                / np.float32(1 - dropout)).astype(np.float32)
        monkeypatch.setattr(jvit, "_dropout", lambda h, rate, rng: h * jnp.asarray(mask))
        monkeypatch.setattr(tvit, "_dropout", lambda h, rate, gen: h * torch.from_numpy(mask))
    seeds = [int(np.asarray(jax.random.bits(jax.random.fold_in(key, l), (), jnp.uint32)))
             for l in range(cfg.depth)]
    monkeypatch.setattr(tvit, "layer_seeds", lambda gen, depth: seeds[:depth])

    def jloss(p):
        logits = jtome_model.forward_train(p, jnp.asarray(x), cfg, 4,
                                           dropout_rng=key if regularized else None)
        return jnp.sum(logits * weight)

    jl, jgrads = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, jparams))
    params = trainer.as_trainable(params_from_numpy(jparams, "cpu"), "cpu")
    rng = torch.Generator().manual_seed(0) if regularized else None
    logits, metrics = tome_stages.kernel_metrics(ttome_model.forward_train, params,
                                                 torch.from_numpy(x), cfg, 4, dropout_rng=rng)
    assert_margins(metrics, ttome_model.schedule(cfg, 4, ttome_model.TRAIN_MERGE_CHUNK))
    loss = (logits * torch.from_numpy(weight)).sum()
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    want = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    for path, t in _leaves(params):
        w = want[path]
        assert np.abs(t.grad.numpy() - w).max() <= 1e-4 * max(1.0, np.abs(w).max()), path


def test_forward_train_chunk_and_eager_oracle(cfg, jparams):
    # --tome-chunk's override, and forward_eager with the same seeds: the
    # gather/scatter oracle of the kernel path, masks bit for bit
    rcfg = dataclasses.replace(cfg, dropout=0.1, drop_path=0.1)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 3, 64, 64)).astype(np.float32))
    tree = params_from_numpy(jparams, "cpu")
    with torch.no_grad():
        for chunk in (1, 3):
            got = ttome_model.forward_train(tree, x, cfg, 4, chunk=chunk)
            want = ttome_model.forward_eager(tree, x, cfg, 4,
                                             counts=ttome_model.schedule(cfg, 4, chunk))
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4, rtol=0)
        got = ttome_model.forward_train(tree, x, rcfg, 4, dropout_rng=torch.Generator().manual_seed(7))
        want = ttome_model.forward_eager(tree, x, rcfg, 4, counts=ttome_model.schedule(rcfg, 4, 2),
                                         dropout_rng=torch.Generator().manual_seed(7))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4, rtol=0)
    # rates of 0: exactly the unregularized forward
    zero = dataclasses.replace(cfg, dropout=0.0, drop_path=0.0)
    with torch.no_grad():
        assert torch.equal(ttome_model.forward_train(tree, x, zero, 4,
                                                     dropout_rng=torch.Generator()),
                           ttome_model.forward_train(tree, x, zero, 4))


def _step_lines(out):
    return [line for line in out.splitlines() if line.startswith("step")]


def test_train_cli_tome_matches_jax(cfg, monkeypatch, capsys):
    import vit_tpu.config as jconfig
    import vit_tpu_torch.config as tconfig
    from vit_tpu.cli.train import main as jmain
    from vit_tpu_torch.cli.train import main as tmain

    monkeypatch.setitem(jconfig.CONFIGS, cfg.name, cfg)
    monkeypatch.setitem(tconfig.CONFIGS, cfg.name, cfg)
    base = ["--config", cfg.name, "--steps", "2", "--batch", "4"]
    jbase, tbase = [*base, "--dp", "1", "--no-compile-cache"], [*base, "--device", "cpu"]
    final_t = cfg.seq_len - sum(ttome_model.schedule(cfg, 4, 3))
    for extra in (["--tome", "4"], ["--tome", "4", "--tome-chunk", "3"],
                  ["--tome", "4", "--dropout", "0.1", "--drop-path", "0.1"]):
        assert tmain([*tbase, "--ops", "fused_train", *extra]) == 0
        out = capsys.readouterr().out
        assert jmain([*jbase, "--ops", "fused_train", *extra]) == 0
        jout = capsys.readouterr().out
        line = next(line for line in out.splitlines() if line.startswith("tome training"))
        assert line in jout
        assert len(_step_lines(out)) == 2
        if "--tome-chunk" in extra:
            assert f"tome training: r=4 (chunk 3, final {final_t} tokens)" == line
    # the refusals, with the JAX CLI's messages
    for extra in (["--ops", "fused_train", "--tome-chunk", "2"],
                  ["--ops", "fused_train", "--tome", "4", "--tome-chunk", "0"]):
        assert tmain([*tbase, *extra]) == 2
        err = capsys.readouterr()
        assert jmain([*jbase, *extra]) == 2
        jerr = capsys.readouterr()
        msg = next(line for line in (err.out + err.err).splitlines() if line.startswith("error:"))
        assert msg in jerr.out + jerr.err
    assert tmain([*tbase, "--ops", "eager", "--tome", "4"]) == 0
    assert "tome training: r=4" in capsys.readouterr().out


def test_num_classes_reinitializes_head_dist(tiny_cfg, tmp_path, capsys):
    """A distilled backbone fine-tuned to K classes gets fresh K-way heads,
    ``head_dist`` included (from the key seed ^ 0xD157), and trains."""
    import vit_tpu_torch.config as tconfig
    from vit_tpu_torch.cli import train_args, train_setup
    from vit_tpu_torch.io import checkpoint
    from vit_tpu_torch.io.params import params_to_numpy

    dcfg = dataclasses.replace(tiny_cfg, distilled=True, name="deit_tiny_test")
    tconfig.CONFIGS[dcfg.name] = dcfg
    try:
        tree = tvit.init_params(torch.Generator().manual_seed(0), dcfg)
        checkpoint.save_npz(params_to_numpy(tree), tmp_path / "d.npz")
        args = train_args.build_parser().parse_args([
            "--config", dcfg.name, "--init-weights", str(tmp_path / "d.npz"), "--num-classes",
            "5", "--steps", "1", "--batch", "2", "--device", "cpu", "--seed", "3"])
        st = train_setup.prepare(args)
        assert st.params["head"]["kernel"].shape == st.params["head_dist"]["kernel"].shape == (
            dcfg.embed_dim, 5)
        fresh = tvit.init_head(torch.Generator().manual_seed(3 ^ 0xD157),
                               dataclasses.replace(dcfg, num_classes=5))
        assert torch.equal(st.params["head_dist"]["kernel"].detach(), fresh["kernel"])
        from vit_tpu_torch.cli import train_loop

        assert train_loop.run(args, st) == 0
    finally:
        del tconfig.CONFIGS[dcfg.name]
    assert "transfer learning" in capsys.readouterr().out


def test_staged_batches_are_bounded(tiny_cfg, monkeypatch, capsys):
    """With a bound of one batch the loop keeps the first batch staged and
    uploads the others at every use (3 distinct batches over 6 steps: 5
    uploads; unbounded it makes 3)."""
    from vit_tpu_torch.cli import train_args, train_loop, train_setup

    args = train_args.build_parser().parse_args([
        "--config", "vit_b_16", "--steps", "6", "--batch", "2", "--device", "cpu"])
    images = np.zeros((6, 3, 4, 4), np.float32)
    labels = np.zeros(6, np.int32)
    st = train_setup.TrainSetup(cfg=tiny_cfg, device=torch.device("cpu"), ops_name="eager",
                                step=lambda p, x, y, step=None: torch.zeros(()), params={},
                                optimizer=None, trained={}, lr_at=None, images=images,
                                labels=labels, n_static=6)
    uploads = []
    real = torch.from_numpy

    def counting(a):
        uploads.append(a.shape)
        return real(a)

    monkeypatch.setattr(torch, "from_numpy", counting)
    monkeypatch.setattr(train_loop, "STAGED_BYTES", images[:2].nbytes + labels[:2].nbytes)
    assert train_loop.run(args, st) == 0
    assert len(uploads) == 2 * 5  # images and labels
    uploads.clear()
    monkeypatch.setattr(train_loop, "STAGED_BYTES", int(512e6))
    assert train_loop.run(args, st) == 0
    assert len(uploads) == 2 * 3
    capsys.readouterr()

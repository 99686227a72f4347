"""The port's examples (``examples/torch_*.py``) run end to end on the CPU
(``--device cpu``; their kernels' plain twins), at a tiny config: the
library-API counterparts of ``examples/*.py`` (``tests/test_examples.py``
runs those)."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"


def _run(name, argv):
    sys.path.insert(0, str(EXAMPLES))
    try:
        mod = __import__(name)
        return mod.main(argv)
    finally:
        sys.path.remove(str(EXAMPLES))
        sys.modules.pop(name, None)


@pytest.fixture(autouse=True)
def one_thread():
    # the suite's workers share the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("ops", ["fused", "quant"])
def test_classify_example(tiny_cfg, monkeypatch, capsys, ops):
    import vit_tpu_torch.config as config

    monkeypatch.setitem(config.CONFIGS, tiny_cfg.name,
                        config.ViTConfig(**dataclasses.asdict(tiny_cfg)))
    assert _run("torch_classify", ["--config", tiny_cfg.name, "--batch", "2", "--ops", ops,
                                   "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[1] label:" in out and ("rollout (2, 2, 2)" in out) == (ops != "quant")


def test_finetune_example(capsys):
    assert _run("torch_finetune", ["--device", "cpu", "--steps", "20"]) == 0  # top-1 >= 0.9
    assert "train top-1 after 20 steps" in capsys.readouterr().out


def test_serve_example(capsys):
    assert _run("torch_serve_batching", ["--device", "cpu", "--requests", "4"]) == 0
    out = capsys.readouterr().out
    assert "served 4 requests" in out and "p99" in out


def test_distill_example(capsys):
    assert _run("torch_distill", ["--device", "cpu", "--steps", "20"]) == 0
    assert "dist-head agreement with the teacher: 1.00" in capsys.readouterr().out


def test_parallel_example():
    # two ranks under torch.distributed.run over gloo
    env = {k: v for k, v in os.environ.items() if k != "WORLD_SIZE"}
    out = subprocess.run([sys.executable, str(EXAMPLES / "torch_parallel.py"), "--device", "cpu"],
                         capture_output=True, text=True, timeout=180, cwd=REPO,
                         env=dict(env, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    for line in ("dp=2 (eager)", "dp=1 x tp=2 (fused kernels)", "pp=2 (GPipe", "dp=2 train",
                 "parallel example: OK"):
        assert line in out.stdout

"""One rank of the 2-rank gloo group that ``test_torch_plain_tp.py``
starts:

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        tests/torch_plain_tp_worker.py IN.npz OUT

Reads the tiny config's fp32 params, images and labels from ``IN.npz``
(made by the test, which hands the same arrays to the JAX package), runs
tensor parallelism on the plain tiers over ``tp`` 2 on the CPU — the
``eager`` engine's logits, features, attention maps and rollout,
``phase_report`` on the ``fused`` and ``eager`` engines, one ``eager`` and
one ``qat`` step's gradients (the ``qat`` one also with the absmaxes left
rank-local) — and then ``dryrun_multichip(2)``, and writes every result to
``OUT.<rank>.npz``.  Imports nothing of JAX.
"""

import contextlib
import io
import sys

import numpy as np
import torch
import torch.distributed as dist

from torch_parallel_train_worker import TINY, flatten, unflatten
from vit_tpu_torch.io.params import params_from_numpy, params_to_numpy
from vit_tpu_torch.ops.dispatch import get_ops
from vit_tpu_torch.parallel import make_mesh, tp_forward
from vit_tpu_torch.parallel.sharding import shard_params, unshard_params
from vit_tpu_torch.runtime import distributed, trainer
from vit_tpu_torch.runtime.engine import InferenceEngine


def grads(data, mesh, ops_name: str) -> tuple:
    """(loss, the whole gradient tree) of one tp step (SGD at lr 0 keeps
    them), the LayerNorms' partial gradients summed over tp."""
    params = trainer.as_trainable(shard_params(params_from_numpy(unflatten(data, "params/"),
                                                                 "cpu"), mesh), "cpu")
    step = trainer.make_train_step_dp(
        TINY, torch.optim.SGD(list(trainer.leaves(params)), lr=0.0), mesh,
        tp_forward.plain_tp_ops(get_ops(ops_name), mesh), remat=False)
    loss = step(params, torch.from_numpy(data["images"]), torch.from_numpy(data["labels"]))
    whole = unshard_params(_grad_tree(params), mesh)
    return float(loss), params_to_numpy(whole)


def _grad_tree(tree):
    return {k: _grad_tree(v) if isinstance(v, dict) else v.grad for k, v in tree.items()}


def main(inp: str, out: str) -> None:
    data = dict(np.load(inp))
    assert distributed.initialize(backend="gloo", device_type="cpu") == "gloo"
    rank = dist.get_rank()
    params, images = unflatten(data, "params/"), data["images"]
    tp2 = make_mesh({"dp": 1, "tp": 2})
    res = {}

    def engine(ops):
        return InferenceEngine(TINY, params, dtype="float32", ops=ops, device="cpu", mesh=tp2,
                               batch_pad=4)

    eager = engine("eager")
    res["eager_local_wqkv_shape"] = np.array(eager.params["blocks"]["wqkv"].shape)
    res["eager_logits"] = eager.logits(images).numpy()
    res["eager_features"] = eager.features(images).numpy()
    res["eager_maps"] = eager.attention_maps(images).numpy()
    res["eager_rollout"] = eager.attention_maps(images, rollout=True).numpy()
    fused = engine("fused")
    res["fused_maps"] = fused.attention_maps(images).numpy()
    for name, eng in (("fused", fused), ("eager", eager)):
        report = eng.phase_report(images, iters=1)
        if rank == 0:
            res[f"{name}_report"] = np.array(report)

    for ops_name in ("eager", "qat"):
        loss, g = grads(data, tp2, ops_name)
        res[f"{ops_name}_loss"] = np.float32(loss)
        res.update(flatten(g, f"{ops_name}_grads/"))
    # the qat absmaxes of the split data left rank-local: not the JAX package's codes
    keep = tp_forward._absmax_over_tp
    tp_forward._absmax_over_tp = lambda a, mesh: a
    try:
        loss, g = grads(data, tp2, "qat")
    finally:
        tp_forward._absmax_over_tp = keep
    res["qat_local_loss"] = np.float32(loss)
    res.update(flatten(g, "qat_local_grads/"))

    from vit_tpu_torch.dryrun import dryrun_multichip

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        line = dryrun_multichip(2, "cpu")
    res["dryrun"] = np.array(line)
    res["dryrun_stdout"] = np.array(buf.getvalue())
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("vit_tpu", "jax", "jaxlib"))
    assert not loaded, loaded
    np.savez(f"{out}.{rank}.npz", **res)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])

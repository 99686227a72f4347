"""One rank of the 2-rank gloo group that ``test_torch_parallel.py`` starts:

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        tests/torch_parallel_worker.py IN.npz OUT

Reads the tiny config's fp32 params, images and the W8A8 MLP case from
``IN.npz`` (made with numpy by the test, which hands the same arrays to the
JAX package), runs the port's tensor- and data-parallel paths on the CPU,
and writes every result to ``OUT.<rank>.npz``.  Imports nothing of JAX.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from vit_tpu_torch import config
from vit_tpu_torch.ops import fused_block
from vit_tpu_torch.parallel import make_mesh
from vit_tpu_torch.parallel import tp_forward
from vit_tpu_torch.parallel.sharding import shard_params
from vit_tpu_torch.runtime import distributed
from vit_tpu_torch.runtime.engine import InferenceEngine


def unflatten(flat: dict, prefix: str) -> dict:
    tree = {}
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        at = tree
        for p in parts[:-1]:
            at = at.setdefault(p, {})
        at[parts[-1]] = value
    return tree


def main(inp: str, out: str) -> None:
    data = dict(np.load(inp))
    cfg = config.ViTConfig(image_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
                           num_classes=11, name="vit_tiny_test")
    params, images = unflatten(data, "params/"), data["images"]
    assert distributed.initialize(backend="gloo", device_type="cpu") == "gloo"
    assert distributed.initialize() == "gloo"  # idempotent
    res = {}

    tp2 = make_mesh({"dp": 1, "tp": 2})
    res["tp_coords"] = np.array([tp2.index("dp"), tp2.index("tp")])

    def engine(mesh, ops, dtype, **kw):
        return InferenceEngine(cfg, params, dtype=dtype, ops=ops, device="cpu", mesh=mesh,
                               batch_pad=4, **kw)

    for ops in ("fused", "quant"):
        for dtype in ("float32", "bfloat16"):
            eng = engine(tp2, ops, dtype)
            res[f"{ops}_tp2_{dtype}"] = eng.logits(images).float().numpy()
            res[f"{ops}_tp2_{dtype}_features"] = eng.features(images).float().numpy()
    # the local shard's leaves: whole heads of wqkv, rows of wo and w2
    q = engine(tp2, "quant", "float32")
    res["quant_local_wqkv"] = q.params["blocks"]["wqkv"].numpy()
    res["quant_local_wqkv_scale"] = q.params["blocks"]["wqkv_scale"].numpy()
    # swap_params on a meshed engine: as an engine built on the new weights
    other = unflatten(data, "other/")
    q.swap_params(other)
    res["quant_tp2_swapped"] = q.logits(images).numpy()
    fresh = InferenceEngine(cfg, other, dtype="float32", ops="quant", device="cpu", mesh=tp2,
                            batch_pad=4)
    res["quant_tp2_fresh"] = fresh.logits(images).numpy()

    dp2 = make_mesh({"dp": 2, "tp": 1})
    res["dp_coords"] = np.array([dp2.index("dp"), dp2.index("tp")])
    for ops in ("fused", "quant", "eager"):
        res[f"{ops}_dp2_float32"] = engine(dp2, ops, "float32").logits(images).numpy()
    # 3 images pad to 4 (lcm of batch_pad 4 and dp 2): each rank takes 2
    res["fused_dp2_3images"] = engine(dp2, "fused", "float32").logits(images[:3]).numpy()

    # past the switch (lowered to 4 tokens; the tiny config has 5)
    fused_block.VMEM_ATTENTION_MAX_T = 4
    for ops in ("fused", "quant"):
        res[f"{ops}_tp2_long"] = engine(tp2, ops, "float32").logits(images).numpy()
    fused_block.VMEM_ATTENTION_MAX_T = 1024

    # the W8A8 tensor-parallel MLP, kernels (twins here) and oracle
    blk = {k: torch.from_numpy(v) for k, v in unflatten(data, "mlp/").items()}
    local = shard_params({"blocks": {k: v[None] for k, v in blk.items()}}, tp2)["blocks"]
    local = {k: v[0] for k, v in local.items()}
    x = torch.from_numpy(data["mlp_x"])
    res["mlp_q8_tp"] = tp_forward._mlp_q8_tp(x, local, 1e-6, "exact", tp2).numpy()
    res["mlp_q8_tp_ref"] = tp_forward._mlp_q8_tp_ref(x, local, 1e-6, "exact", tp2).numpy()
    np.savez(f"{out}.{dist.get_rank()}.npz", **res)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])

#!/usr/bin/env python
"""Drive the port's dynamic-batching server in-process (what
``vit-tpu-torch-serve`` wraps in HTTP), the counterpart of
``examples/serve_batching.py``: submit concurrent requests of several
sizes, read the futures, print the latency the server tracks.  It runs on
the card unless ``--device cpu`` asks for the CPU.

    python examples/torch_serve_batching.py                 # card, fused kernels
    python examples/torch_serve_batching.py --device cpu --ops eager
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ops", default="fused", help="eager | fused | quant")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import dataclasses

    import numpy as np

    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io import weights as wio
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.runtime.engine import InferenceEngine
    from vit_tpu_torch.runtime.serving import InferenceServer

    cfg = dataclasses.replace(VIT_B_16, depth=2, embed_dim=64, num_heads=4, image_size=32,
                              patch_size=16, num_classes=7, name="vit_serve_example")
    params = wio.params_from_tensors(wio.synth_reference_tensors(cfg, 1), cfg)
    engine = InferenceEngine(cfg, params, dtype="float32", ops=args.ops, device=args.device,
                             batch_pad=8)

    rng = np.random.default_rng(0)
    # `with` starts the dispatch loop and, on exit, drains it in order: the
    # path the HTTP daemon's SIGTERM handler takes (cli/serve.py)
    with InferenceServer(engine, max_batch=8, max_delay_ms=2.0) as server:
        futures = [server.submit(synth_images(int(n), cfg, seed=i))
                   for i, n in enumerate(rng.integers(1, 5, args.requests))]
        for i, fut in enumerate(futures):
            labels, top_probs, _ = fut.result(timeout=120)
            print(f"request {i}: {len(labels)} images -> labels {labels}")

    s = server.stats
    print(f"served {s.requests} requests / {s.images} images, "
          f"{s.images_per_batch:.1f} img/batch, "
          f"p50 {s.latency.quantile(0.5) * 1e3:.1f} ms / "
          f"p99 {s.latency.quantile(0.99) * 1e3:.1f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

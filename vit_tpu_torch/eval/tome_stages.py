"""Hold a token-merging kernel path to the eager oracle on the kernel's own
matching.

The matching is discrete: a k-mean that differs from the oracle's in its
last bit can rank another pair first, and then the two forwards differ by
a whole token, not by rounding.  So a kernel path is not compared with
``forward_eager`` end to end.  Instead:

  1. run the kernel path and record the metric every merging layer handed
     to ``tome.merge_matrix`` (the kernel's k-mean);
  2. run ``forward_eager`` with each layer's merge fed the kernel's metric
     in place of its own, recording its own k-mean beside it;
  3. compare each layer's two k-means at the dtype's tolerance, and the
     logits — now from the same merges — at the path's tolerance.
"""

from __future__ import annotations

from unittest import mock

import torch

from vit_tpu_torch.models import tome as tome_model
from vit_tpu_torch.ops import tome


def kernel_metrics(forward, *args, **kwargs):
    """-> (logits, [metric of each merging layer]) of ``forward`` (a
    kernel path of ``models/tome.py``)."""
    metrics = []
    real = tome.merge_matrix

    def recording(metric, size, r, protected=1):
        metrics.append(metric.detach().clone())
        return real(metric, size, r, protected)

    with mock.patch.object(tome, "merge_matrix", recording):
        logits = forward(*args, **kwargs)
    return logits, metrics


def eager_on_metrics(params, images, cfg, r, metrics, **kwargs):
    """-> (logits, [its own metric of each merging layer]) of
    ``forward_eager`` with each merge matched on ``metrics`` (in layer
    order) instead of the layer's own k-mean."""
    own, queue = [], list(metrics)
    real = tome.merge_tokens

    def replaying(x, metric, size, r_l, protected=1):
        own.append(metric.detach().clone())
        return real(x, queue.pop(0).to(metric.dtype), size, r_l, protected)

    with mock.patch.object(tome, "merge_tokens", replaying):
        logits = tome_model.forward_eager(params, images, cfg, r, **kwargs)
    if queue:
        raise AssertionError(f"{len(queue)} recorded metric(s) not consumed: schedules differ")
    return logits, own


def check_against_eager(forward, params, images, cfg, r, rtol: float, logit_tol: float) -> dict:
    """Steps 1-3 for one floating-point kernel path.  -> {"kmean": worst
    relative k-mean deviation, "logits": max |d logit|, "merges": merging
    layers}; raises ``AssertionError`` where a bound fails."""
    with torch.inference_mode():
        got, metrics = kernel_metrics(forward, params, images, cfg, r)
        want, own = eager_on_metrics(params, images, cfg, r, metrics)
    worst = 0.0
    for l, (m, o) in enumerate(zip(metrics, own)):
        m, o = m.float(), o.float().reshape(m.shape)
        dev = (m - o).abs().max().item() / max(1.0, o.abs().max().item())
        if not dev <= rtol:
            raise AssertionError(f"merge {l}: k-mean deviates by {dev:.3g} of its scale "
                                 f"(bound {rtol:.3g})")
        worst = max(worst, dev)
    err = (got.float() - want.float()).abs().max().item()
    if not (torch.isfinite(got).all() and err <= logit_tol):
        raise AssertionError(f"logits on the kernel's own matching: max|d| {err:.6g} > "
                             f"{logit_tol:.6g}")
    return {"kmean": worst, "logits": err, "merges": len(metrics)}

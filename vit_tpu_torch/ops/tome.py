"""Token merging (ToMe; Bolya et al. 2022, "Token Merging: Your ViT But
Faster") — counterpart of ``vit_tpu.ops.tome``.

Bipartite soft matching between the attention and MLP halves of each
block: the metric is the mean attention key over heads (K1/K15 emit it);
the non-protected tokens split alternately into sets A and B; each A token
scores its most similar B token (cosine similarity); the r best-scoring A
tokens merge into their B matches by a size-weighted average.  Token sizes
count the original patches a token stands for; later attention adds
log(size) to the key logits (proportional attention).  Protected prefix
tokens (CLS, and DeiT's distillation token) never merge.

The matching is discrete: ``argmax`` takes the first maximum and the
ranking is a stable sort, as ``jnp.argmax``/``jnp.argsort`` do, so a tie
resolves as in the JAX package.  The merge itself is either the
gather/scatter form (:func:`merge_tokens`, the eager oracle) or one dense
batched GEMM (:func:`merge_matrix` + :func:`apply_merge_matrix`), which
the kernel paths run between K4 and K5 in true fp32 — the JAX package
leaves it to XLA at ``Precision.HIGHEST``; here it is ``torch.matmul`` on
fp32 operands with TF32 off (PyTorch's default on the card).
"""

from __future__ import annotations

from typing import Tuple

import torch


def merge_counts(seq_len: int, depth: int, r: int, protected: int = 1):
    """Per-layer merge counts: r per layer, clipped so at least
    ``protected + 32`` tokens survive to the final layer and no layer
    merges more pairs than its A set holds."""
    floor = protected + 32
    counts = []
    t = seq_len
    for _ in range(depth):
        rl = min(r, max(0, t - floor), (t - protected) // 2)
        counts.append(rl)
        t -= rl
    return counts


def compress_counts(counts, chunk: int, seq_len: int, protected: int = 1):
    """Re-bucket a per-layer schedule so each group of ``chunk`` consecutive
    layers merges its whole budget at the group's first layer; a group
    takes at most the A set at its start, carrying the excess into the next
    group (any residue after the last group is dropped)."""
    if chunk <= 1:
        return list(counts)
    out = [0] * len(counts)
    t, carry = seq_len, 0
    for g0 in range(0, len(counts), chunk):
        want = sum(counts[g0 : g0 + chunk]) + carry
        take = min(want, (t - protected) // 2)
        out[g0] = take
        carry = want - take
        t -= take
    return out


def validate_counts(counts, seq_len: int, protected: int = 1):
    """Raise ``ValueError`` unless every layer's count fits the bipartite A
    set at that layer's live token count; -> ``counts``."""
    t = seq_len
    for l, rl in enumerate(counts):
        if rl > (t - protected) // 2:
            raise ValueError(
                f"layer {l} merges {rl} pairs but only "
                f"{(t - protected) // 2} exist at t={t}"
            )
        t -= rl
    return counts


def _match(metric: torch.Tensor, r: int, protected: int):
    """Bipartite matching of a batch: metric (B, T, Dm) -> (a_idx, b_idx,
    src, keep, dst): the A/B token positions (relative to the protected
    prefix), the r merging A rows, the surviving A rows in their original
    order, and the B slot each merging row lands in."""
    n = metric.shape[1] - protected
    mr = metric[:, protected:].float()
    mr = mr / (torch.linalg.vector_norm(mr, dim=-1, keepdim=True) + 1e-6)
    a_idx = torch.arange(0, n, 2, device=metric.device)
    b_idx = torch.arange(1, n, 2, device=metric.device)
    scores = mr[:, a_idx] @ mr[:, b_idx].transpose(-1, -2)  # (B, na, nb)
    best = scores.argmax(dim=-1)  # first maximum, as jnp.argmax
    best_val = scores.gather(-1, best[..., None])[..., 0]
    order = torch.argsort(-best_val, dim=-1, stable=True)  # most similar first
    src = order[:, :r]
    keep = order[:, r:].sort(dim=-1).values
    return a_idx, b_idx, src, keep, best.gather(1, src)


def merge_matrix(metric: torch.Tensor, size: torch.Tensor, r: int, protected: int = 1):
    """The merge as a dense operator: (B, T, Dm) metric and (B, T) sizes ->
    (W (B, T - r, T) fp32, s_out (B, T - r)), rows laid out [protected |
    surviving A (original order) | B], W's entries the sizes of the tokens
    each output row sums.  The matching is piecewise constant: no gradient
    flows through it (build it under ``torch.no_grad()``)."""
    if r <= 0:
        raise ValueError("merge_matrix needs r > 0")
    b, t = size.shape
    a_idx, b_idx, src, keep, dst = _match(metric, r, protected)
    na, nb = a_idx.shape[0], b_idx.shape[0]
    dev = size.device
    sz = size.float()
    w = torch.zeros(b, t - r, t, dtype=torch.float32, device=dev)
    bi = torch.arange(b, device=dev)[:, None]
    pidx = torch.arange(protected, device=dev)
    w[:, pidx, pidx] = sz[:, :protected]
    rows_a = (protected + torch.arange(na - r, device=dev)).expand(b, -1)
    cols_a = protected + a_idx[keep]
    w[bi, rows_a, cols_a] = sz.gather(1, cols_a)
    rows_b = protected + (na - r) + torch.arange(nb, device=dev)
    cols_b = protected + b_idx
    w[:, rows_b, cols_b] = sz[:, cols_b]
    rows_m = protected + (na - r) + dst
    cols_m = protected + a_idx[src]
    w.index_put_((bi.expand(-1, r), rows_m, cols_m), sz.gather(1, cols_m), accumulate=True)
    return w, w.sum(dim=-1)


def apply_merge_matrix(x: torch.Tensor, w: torch.Tensor, s_out: torch.Tensor) -> torch.Tensor:
    """x (B, T, D) through the merge operator: (W @ x) / s_out in fp32 —
    the size-weighted average as one batched GEMM — rounded to x's dtype."""
    acc = torch.matmul(w, x.float())
    return (acc / s_out[..., None]).to(x.dtype)


def merge_tokens(
    x: torch.Tensor, metric: torch.Tensor, size: torch.Tensor, r: int, protected: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched bipartite soft matching merge by gather and scatter: x (B, T,
    D) tokens, metric (B, T, Dm), size (B, T) -> ((B, T - r, D), (B, T -
    r)).  The first ``protected`` rows never merge."""
    if r <= 0:
        return x, size
    d = x.shape[-1]
    a_idx, b_idx, src, keep, dst = _match(metric, r, protected)
    xr, sr = x[:, protected:], size[:, protected:]
    xa, sa = xr[:, a_idx], sr[:, a_idx]
    xb, sb = xr[:, b_idx], sr[:, b_idx]
    # size-weighted average into the destination B slots (fp32 accumulate)
    wsum = (xb.float() * sb[..., None]).scatter_add(
        1, dst[..., None].expand(-1, -1, d),
        xa.gather(1, src[..., None].expand(-1, -1, d)).float() * sa.gather(1, src)[..., None],
    )
    sb_new = sb.scatter_add(1, dst, sa.gather(1, src))
    xb_new = (wsum / sb_new[..., None]).to(x.dtype)
    x_out = torch.cat([x[:, :protected], xa.gather(1, keep[..., None].expand(-1, -1, d)), xb_new],
                      dim=1)
    s_out = torch.cat([size[:, :protected], sa.gather(1, keep), sb_new], dim=1)
    return x_out, s_out

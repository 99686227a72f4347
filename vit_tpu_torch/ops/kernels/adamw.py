"""K20: the fused in-place AdamW update, one kernel launch per leaf, CUDA
(``csrc/adamw.cu``).

Replaces ``vit_tpu/ops/pallas/adamw_kernel.py:_leaf_update`` (pallas_call
at :64; body ``_adamw_kernel`` :30), reached through ``adamw_update`` (:90):
optax.adamw's math (eps_root 0, decoupled weight decay) in one pass per
leaf,

    m = b1 m + (1 - b1) g;   v = b2 v + (1 - b2) g²
    p = p - lr ((m bc1) / (sqrt(v bc2) + eps) + wd p),   bc = 1 / (1 - b^t)

with g and p in fp32 or bf16 (computed in fp32, p written back in its own
dtype) and m, v fp32.  lr, bc1 and bc2 are computed on the host in fp32 at
the 1-based step t, as the JAX function computes them from a traced step.

What bounds it on the H100: device memory — read g, p, m, v and write p,
m, v once, 28 bytes per fp32 element (ViT-B/16's 20 leaves, 86,567,656
parameters: 2.42 GB, 0.724 ms at 3.35 TB/s).  The TPU kernel aliases its
outputs onto p, m and v; here the tensors are updated in place.  The JAX
function sends leaves under 2^15 elements, or not a multiple of the TPU's
128 lanes, to jnp; on the card every leaf launches the kernel, which masks
its own ragged edge, so a B/16 step makes 20 launches.
"""

from __future__ import annotations

import numpy as np
import torch

from vit_tpu_torch.ops.kernels import _build


def _leaves(tree):
    """The tensors of a nested dict (insertion order) or a list."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def step_scalars(step: int, lr, b1: float, b2: float):
    """(lr, bc1, bc2) as fp32 numbers at the 1-based ``step``, computed in
    fp32 (the JAX function on a traced step: ``step.astype(float32)``)."""
    t = np.float32(step)
    one = np.float32(1.0)
    bc1 = one / (one - np.float32(b1) ** t)
    bc2 = one / (one - np.float32(b2) ** t)
    return np.float32(lr), bc1, bc2


def _leaf_plain(g, p, m, v, lr, bc1, bc2, b1, b2, eps, wd) -> None:
    """One leaf's update, in place, in fp32 torch arithmetic in the
    kernel's order."""
    f32 = lambda x: torch.tensor(float(x), dtype=torch.float32)  # noqa: E731
    gf = g.float()
    m.copy_(f32(b1) * m + f32(1.0 - b1) * gf)
    v.copy_(f32(b2) * v + f32(1.0 - b2) * (gf * gf))
    pf = p.float()
    upd = (m * f32(bc1)) / (torch.sqrt(v * f32(bc2)) + f32(eps)) + f32(wd) * pf
    p.copy_((pf - f32(lr) * upd).to(p.dtype))


def adamw_update_plain(grads, params, mu, nu, step: int, lr, b1=0.9, b2=0.999, eps=1e-8,
                       weight_decay=0.0):
    """Plain twin of :func:`adamw_update`: the same update in torch
    arithmetic, in place.  -> (params, mu, nu)."""
    s_lr, bc1, bc2 = step_scalars(step, lr, b1, b2)
    with torch.no_grad():
        for g, p, m, v in zip(_leaves(grads), _leaves(params), _leaves(mu), _leaves(nu)):
            _leaf_plain(g, p, m, v, s_lr, bc1, bc2, b1, b2, eps, weight_decay)
    return params, mu, nu


def _check_leaf(name: str, g, p, m, v) -> None:
    """p and g fp32 or bf16, m and v fp32, one shape, one CUDA device, all
    contiguous."""
    if p.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA or CPU tensor, got {p.device}")
    for t in (g, m, v):
        if t.device != p.device:
            raise ValueError(f"{name}: operands on {t.device} and {p.device}")
        _build.check_shape(name, "operand", t, p.shape)
    for n, t in (("param", p), ("grad", g)):
        if t.dtype not in _build.DTYPE_CODES:
            raise TypeError(f"{name}: {n} dtype {t.dtype} not supported (float32, bfloat16)")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"{name}: the moments must be float32, got {m.dtype} and {v.dtype}")
    if not all(t.is_contiguous() for t in (g, p, m, v)):
        raise ValueError(f"{name}: operands must be contiguous")


def adamw_update(grads, params, mu, nu, step: int, lr, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.0):
    """One AdamW step over matching dicts or lists of leaves, in place: ->
    (params, mu, nu).  ``step`` is the 1-based step number, ``lr`` a
    number; mu and nu are fp32 leaves shaped like the params.  A leaf on
    the CPU takes the plain twin; a leaf on the card launches the kernel."""
    name = "adamw_update"
    s_lr, bc1, bc2 = step_scalars(step, lr, b1, b2)
    consts = [float(s_lr), b1, 1.0 - b1, b2, 1.0 - b2, eps, weight_decay, float(bc1), float(bc2)]
    with torch.no_grad():
        for g, p, m, v in zip(_leaves(grads), _leaves(params), _leaves(mu), _leaves(nu),
                              strict=True):
            if p.device.type == "cpu":
                _leaf_plain(g, p, m, v, s_lr, bc1, bc2, b1, b2, eps, weight_decay)
                continue
            _check_leaf(name, g, p, m, v)
            lib = _build.load_library()
            _build.check(
                lib.vt_adamw(
                    g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(), *consts,
                    _build.DTYPE_CODES[p.dtype], _build.DTYPE_CODES[g.dtype], p.device.index,
                    _build.stream_of(p),
                ),
                name,
            )
            adamw_update.launches += 1
    return params, mu, nu


adamw_update.launches = 0

"""Reader and writer of the reference's ``Weight_{idx}_{name}.bin``
directories.

Counterpart of ``vit_tpu.io.weights``, numpy only.  Reading: scan
the directory, parse each index from its file name, read each file as
little-endian fp32, apply the reference's 6-decimal load-time rounding
(``roundf(x*1e6)/1e6``, behind a parity switch), and repack the indexed
torchvision-layout tensors into the params tree of
``vit_tpu_torch.models.vit``: [out, in] matrices become [in, out], the
encoder layers stack on a leading axis, and the packed in_proj columns go
from torchvision's (3, heads, head_dim) blocks to (heads, {q,k,v},
head_dim).  Missing files (a checkpoint with stripped blobs) are filled
from a seeded generator when ``allow_synth``.  Writing
(``--save-reference``) is the inverse: :func:`tensors_from_params`, then
:func:`save_reference_weights` (raw little-endian fp32, no header).

Index layout for depth L: 0 class_token, 1 conv_proj_weight, 2
conv_proj_bias, 3 pos_embedding; layer l at 4 + 12 l: ln_1 w/b, in_proj
w/b, out_proj w/b, ln_2 w/b, mlp_0 w/b, mlp_3 w/b; then the final LN w/b
and the head w/b.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from vit_tpu_torch.config import VIT_B_16, ViTConfig
from vit_tpu_torch.utils.tree import cast_tree

WEIGHTS_PER_LAYER = 12

_FILE_RE = re.compile(r"^Weight_(\d+)_(.+)\.bin$")


def reference_tensor_specs(cfg: ViTConfig = VIT_B_16) -> List[Tuple[int, str, Tuple[int, ...]]]:
    """(index, torchvision name, shape) of every tensor in the reference
    checkpoint layout for ``cfg``."""
    d, f, t, c, ps = cfg.embed_dim, cfg.mlp_dim, cfg.seq_len, cfg.num_classes, cfg.patch_size
    specs: List[Tuple[int, str, Tuple[int, ...]]] = [
        (0, "class_token", (d,)),
        (1, "conv_proj_weight", (d, cfg.in_channels, ps, ps)),
        (2, "conv_proj_bias", (d,)),
        (3, "encoder_pos_embedding", (t, d)),
    ]
    per_layer = [
        ("ln_1_weight", (d,)),
        ("ln_1_bias", (d,)),
        ("self_attention_in_proj_weight", (3 * d, d)),
        ("self_attention_in_proj_bias", (3 * d,)),
        ("self_attention_out_proj_weight", (d, d)),
        ("self_attention_out_proj_bias", (d,)),
        ("ln_2_weight", (d,)),
        ("ln_2_bias", (d,)),
        ("mlp_0_weight", (f, d)),
        ("mlp_0_bias", (f,)),
        ("mlp_3_weight", (d, f)),
        ("mlp_3_bias", (d,)),
    ]
    for l in range(cfg.depth):
        base = 4 + WEIGHTS_PER_LAYER * l
        for j, (name, shape) in enumerate(per_layer):
            specs.append((base + j, f"encoder_layers_encoder_layer_{l}_{name}", shape))
    base = 4 + WEIGHTS_PER_LAYER * cfg.depth
    specs += [
        (base + 0, "encoder_ln_weight", (d,)),
        (base + 1, "encoder_ln_bias", (d,)),
        (base + 2, "heads_head_weight", (c, d)),
        (base + 3, "heads_head_bias", (c,)),
    ]
    return specs


def round6(x: np.ndarray) -> np.ndarray:
    """``roundf(v * 1e6f) / 1e6f`` in fp32, C's halves-away-from-zero tie
    break included: scale in fp32, round in float64 (exact for every fp32
    value), divide back in fp32."""
    x = np.asarray(x, dtype=np.float32)
    y = (x * np.float32(1e6)).astype(np.float64)
    r = np.copysign(np.floor(np.abs(y) + 0.5), y)
    return (r.astype(np.float32) / np.float32(1e6)).astype(np.float32)


def scan_weight_dir(weight_dir: Path) -> Dict[int, Path]:
    """{index: path} of the ``Weight_<idx>_<name>.bin`` files in a directory."""
    found: Dict[int, Path] = {}
    for path in Path(weight_dir).iterdir():
        m = _FILE_RE.match(path.name)
        if m:
            found[int(m.group(1))] = path
    return found


def synth_reference_tensors(cfg: ViTConfig = VIT_B_16, seed: int = 0) -> Dict[int, np.ndarray]:
    """Seeded stand-ins in the reference's torchvision layout, drawn in the
    JAX package's order: LN scales 1, biases and the class token 0, the
    position embedding N(0, 0.02), every other tensor N(0, 1/fan_in)."""
    rng = np.random.default_rng(seed)
    out: Dict[int, np.ndarray] = {}
    for idx, name, shape in reference_tensor_specs(cfg):
        fan_in = shape[-1] if len(shape) > 1 else shape[0]
        if len(shape) == 4:
            fan_in = int(np.prod(shape[1:]))
        if name.endswith(("ln_1_weight", "ln_2_weight", "ln_weight")):
            t = np.ones(shape, np.float32)
        elif name.endswith("bias") or name == "class_token":
            t = np.zeros(shape, np.float32)
        elif name == "encoder_pos_embedding":
            t = rng.normal(0, 0.02, shape).astype(np.float32)
        else:
            t = rng.normal(0, (1.0 / fan_in) ** 0.5, shape).astype(np.float32)
        out[idx] = t
    return out


def load_reference_tensors(
    weight_dir: Path,
    cfg: ViTConfig = VIT_B_16,
    round_to_6dp: bool = True,
    allow_synth: bool = False,
    synth_seed: int = 0,
) -> Dict[int, np.ndarray]:
    """Every Weight_*.bin of ``weight_dir`` in its torchvision shape.  A
    missing file raises unless ``allow_synth``, which fills the gaps from
    :func:`synth_reference_tensors`."""
    files = scan_weight_dir(weight_dir)
    synth = None
    out: Dict[int, np.ndarray] = {}
    for idx, name, shape in reference_tensor_specs(cfg):
        path = files.get(idx)
        if path is None:
            if not allow_synth:
                raise FileNotFoundError(f"missing Weight_{idx}_{name}.bin in {weight_dir}")
            if synth is None:
                synth = synth_reference_tensors(cfg, synth_seed)
            out[idx] = round6(synth[idx]) if round_to_6dp else synth[idx]
            continue
        flat = np.fromfile(path, dtype="<f4")
        if round_to_6dp:
            flat = round6(flat)
        if flat.size != int(np.prod(shape)):
            raise ValueError(
                f"{path.name}: got {flat.size} fp32 values, expected {int(np.prod(shape))} {shape}"
            )
        out[idx] = flat.reshape(shape)
    return out


def params_from_tensors(tensors: Dict[int, np.ndarray], cfg: ViTConfig = VIT_B_16,
                        dtype=np.float32):
    """Indexed torchvision tensors -> the params tree (fp32 numpy): every
    [out, in] matrix transposed to [in, out], conv_proj_weight [D, C, p, p]
    flattened to (C*p*p, D) channel-major, the layers stacked, and the
    packed in_proj reordered from (3, H, Dh)-major rows to (H, 3, Dh).
    Another ``dtype`` casts the tree (``utils/tree.cast_tree``)."""
    d, L, hd, nh = cfg.embed_dim, cfg.depth, cfg.head_dim, cfg.num_heads
    base_final = 4 + WEIGHTS_PER_LAYER * L

    def t(i):
        return np.asarray(tensors[i], dtype=np.float32)

    def qkv_reorder(w):
        """[3D, ...] rows (3, H, Dh)-major -> (H, 3, Dh)-major."""
        return w.reshape(3, nh, hd, *w.shape[1:]).transpose(1, 0, *range(2, w.ndim + 2)).reshape(w.shape)

    def stack(offset, fn=lambda a: a):
        return np.stack([fn(t(4 + WEIGHTS_PER_LAYER * l + offset)) for l in range(L)])

    params = {
        "cls_token": t(0).reshape(d),
        "patch_embed": {"kernel": t(1).reshape(d, cfg.patch_dim).T.copy(), "bias": t(2)},
        "pos_embed": t(3).reshape(cfg.seq_len, d),
        "blocks": {
            "ln1_scale": stack(0),
            "ln1_bias": stack(1),
            "wqkv": stack(2, lambda w: qkv_reorder(w).T),
            "bqkv": stack(3, qkv_reorder),
            "wo": stack(4, np.transpose),
            "bo": stack(5),
            "ln2_scale": stack(6),
            "ln2_bias": stack(7),
            "w1": stack(8, np.transpose),
            "b1": stack(9),
            "w2": stack(10, np.transpose),
            "b2": stack(11),
        },
        "ln_final": {"scale": t(base_final), "bias": t(base_final + 1)},
        "head": {"kernel": t(base_final + 2).T.copy(), "bias": t(base_final + 3)},
    }
    return params if dtype is np.float32 else cast_tree(params, dtype)


def load_reference_weights(
    weight_dir,
    cfg: ViTConfig = VIT_B_16,
    round_to_6dp: bool = True,
    allow_synth: bool = False,
    synth_seed: int = 0,
):
    """A Weight_*.bin directory -> the params tree."""
    if cfg.distilled:
        raise ValueError(
            f"config {cfg.name} is DeiT-distilled; the reference Weight_*.bin "
            "layout (torchvision ViT tensors) has no distillation token — load "
            "from .npz instead"
        )
    tensors = load_reference_tensors(Path(weight_dir), cfg, round_to_6dp, allow_synth, synth_seed)
    return params_from_tensors(tensors, cfg)


def tensors_from_params(params, cfg: ViTConfig = VIT_B_16) -> Dict[int, np.ndarray]:
    """Inverse of :func:`params_from_tensors`: a params tree (numpy, or
    torch tensors) -> the indexed torchvision-layout tensors, matrices back
    to [out, in], the packed QKV rows back to (3, H, Dh)-major, the layers
    unstacked.  DeiT params are refused: the layout has no distillation
    token."""
    if "dist_token" in params:
        raise ValueError(
            "DeiT-distilled params (dist_token/head_dist) cannot round-trip "
            "the torchvision-ViT 152-tensor layout (reference Weight_*.bin "
            "and .pth exports) — it has no distillation token; export to "
            ".npz/Orbax instead"
        )
    d, hd, nh, L = cfg.embed_dim, cfg.head_dim, cfg.num_heads, cfg.depth
    blocks = params["blocks"]

    def np32(a):
        if hasattr(a, "detach"):  # a torch tensor
            a = a.detach().cpu().float().numpy()
        return np.asarray(a, dtype=np.float32)

    def qkv_unorder(w):
        """rows (H, {q,k,v}, Dh)-major -> torchvision's (3, H, Dh)-major."""
        return w.reshape(nh, 3, hd, *w.shape[1:]).transpose(1, 0, *range(2, w.ndim + 2)).reshape(
            w.shape)

    out: Dict[int, np.ndarray] = {
        0: np32(params["cls_token"]),
        1: np32(params["patch_embed"]["kernel"]).T.reshape(d, cfg.in_channels, cfg.patch_size,
                                                           cfg.patch_size),
        2: np32(params["patch_embed"]["bias"]),
        3: np32(params["pos_embed"]),
    }
    for l in range(L):
        base = 4 + WEIGHTS_PER_LAYER * l
        out[base + 0] = np32(blocks["ln1_scale"][l])
        out[base + 1] = np32(blocks["ln1_bias"][l])
        out[base + 2] = qkv_unorder(np32(blocks["wqkv"][l]).T.copy())
        out[base + 3] = qkv_unorder(np32(blocks["bqkv"][l]))
        out[base + 4] = np32(blocks["wo"][l]).T.copy()
        out[base + 5] = np32(blocks["bo"][l])
        out[base + 6] = np32(blocks["ln2_scale"][l])
        out[base + 7] = np32(blocks["ln2_bias"][l])
        out[base + 8] = np32(blocks["w1"][l]).T.copy()
        out[base + 9] = np32(blocks["b1"][l])
        out[base + 10] = np32(blocks["w2"][l]).T.copy()
        out[base + 11] = np32(blocks["b2"][l])
    base = 4 + WEIGHTS_PER_LAYER * L
    out[base + 0] = np32(params["ln_final"]["scale"])
    out[base + 1] = np32(params["ln_final"]["bias"])
    out[base + 2] = np32(params["head"]["kernel"]).T.copy()
    out[base + 3] = np32(params["head"]["bias"])
    return out


def save_reference_weights(tensors: Dict[int, np.ndarray], weight_dir,
                           cfg: ViTConfig = VIT_B_16) -> None:
    """Write indexed tensors as ``weight_dir/Weight_{idx}_{name}.bin``: raw
    little-endian fp32, no header (the directory is made if missing)."""
    weight_dir = Path(weight_dir)
    weight_dir.mkdir(parents=True, exist_ok=True)
    names = {idx: name for idx, name, _ in reference_tensor_specs(cfg)}
    for idx, arr in tensors.items():
        np.asarray(arr, dtype="<f4").tofile(weight_dir / f"Weight_{idx}_{names[idx]}.bin")

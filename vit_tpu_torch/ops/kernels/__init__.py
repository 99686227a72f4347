"""Hand-written CUDA kernels, each module holding one kernel's wrapper, its
plain PyTorch twin and its launch counter.  Sources: ``vit_tpu_torch/csrc``;
build and binding: ``_build.py``."""

import importlib

# the module of a wrapper whose name is not its module's
_MODULE_OF = {"flash_attention_fwd": "flash_attention", "ln_qkv_q8": "ln_qkv_attn_q8",
              "scaled_dot_product_attention": "attention", "adamw_update": "adamw",
              "ln_qkv_attn_q8a": "ln_qkv_attn_q8"}


def wrapper(name: str):
    """The kernel wrapper ``name`` (it carries ``launches``)."""
    module = importlib.import_module(f"{__name__}.{_MODULE_OF.get(name, name)}")
    return getattr(module, name)


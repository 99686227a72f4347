"""Hand-written CUDA kernels, each module holding one kernel's wrapper, its
plain PyTorch twin and its launch counter.  Sources: ``vit_tpu_torch/csrc``;
build and binding: ``_build.py``."""

import importlib

# the module of a wrapper whose name is not its module's
_MODULE_OF = {"flash_attention_fwd": "flash_attention"}


def wrapper(name: str):
    """The kernel wrapper ``name`` (it carries ``launches``)."""
    module = importlib.import_module(f"{__name__}.{_MODULE_OF.get(name, name)}")
    return getattr(module, name)


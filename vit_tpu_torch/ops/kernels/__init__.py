"""Hand-written CUDA kernels, each module holding one kernel's wrapper, its
plain PyTorch twin and its launch counter.  Sources: ``vit_tpu_torch/csrc``;
build and binding: ``_build.py``."""

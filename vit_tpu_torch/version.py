"""The port's version: the JAX package's (``vit_tpu.version``)."""

__version__ = "0.1.0"

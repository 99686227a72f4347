"""vit_tpu_torch — the PyTorch + CUDA port of ``vit_tpu`` for NVIDIA Hopper.

The JAX package ``vit_tpu`` is the reference; every module here mirrors its
counterpart's path and names so a reader finds each twin:

  - ``vit_tpu_torch.ops.reference``  <- ``vit_tpu.ops.reference`` (the
    ``eager`` tier, counterpart of ``xla``)
  - ``vit_tpu_torch.ops.dispatch``   <- ``vit_tpu.ops.dispatch``
  - ``vit_tpu_torch.ops.fused``      <- ``vit_tpu.ops.pallas.FUSED_OPS``
  - ``vit_tpu_torch.ops.fused_block`` <- ``vit_tpu.ops.pallas.fused_block``
  - ``vit_tpu_torch.ops.kernels``    hand-written CUDA kernels (sources in
    ``csrc/``), each beside its plain PyTorch twin
  - ``vit_tpu_torch.models.vit``     <- ``vit_tpu.models.vit`` (inference)
  - ``vit_tpu_torch.runtime.engine`` <- ``vit_tpu.runtime.engine``
  - ``vit_tpu_torch.cli.main``       <- ``vit_tpu.cli.main``
  - ``vit_tpu_torch.config``, ``io`` <- ``vit_tpu.config``, ``vit_tpu.io``
    (the routes the port's entry points take by default)

The package imports ``torch`` and never ``jax``.  Its classify and train
paths load nothing of ``vit_tpu``; only the classify CLI's reference-format
weight directories, raw ``--images`` and ``--golden`` read through the JAX
package's numpy-only ``io`` and ``eval.comparator`` modules.
"""

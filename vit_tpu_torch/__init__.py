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
  - ``vit_tpu_torch.ops.trainable``, ``ops.backward`` <- their namesakes
    under ``vit_tpu.ops.pallas`` (the ``fused_train`` block, plain and
    regularized)
  - ``vit_tpu_torch.models.vit``     <- ``vit_tpu.models.vit``
  - ``vit_tpu_torch.runtime``        <- ``vit_tpu.runtime`` (engine, trainer,
    distributed)
  - ``vit_tpu_torch.parallel``       <- ``vit_tpu.parallel`` (mesh, sharding
    rules, tensor- and data-parallel inference)
  - ``vit_tpu_torch.cli``            <- ``vit_tpu.cli`` (classify, train) and
    ``scripts/bench_kernels.py`` (``cli.bench_kernels``)
  - ``vit_tpu_torch.config``, ``io``, ``eval`` <- ``vit_tpu.config``,
    ``vit_tpu.io``, ``vit_tpu.eval.comparator``

The package imports ``torch`` and never ``jax`` nor anything of
``vit_tpu``: it keeps its own copies of the JAX-free modules it needs.
"""

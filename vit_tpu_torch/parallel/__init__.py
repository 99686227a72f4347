"""Parallelism: a rank mesh with named axes and the sharding rules, over
``torch.distributed`` (one process per rank) — counterpart of
``vit_tpu.parallel``.  ``shard_forward.py`` runs a forward data-parallel,
``tp_forward.py`` the fused and W8A8 kernel paths tensor-parallel,
``pipeline.py`` the layer stack pipelined over stages and ``sequence.py``
the tokens over a ring (ring attention)."""

from vit_tpu_torch.parallel.mesh import make_mesh, mesh_shape_for
from vit_tpu_torch.parallel.pipeline import make_pp_train_step, pp_param_pspecs, shard_forward_pp
from vit_tpu_torch.parallel.sequence import attention_sp, make_sp_train_step, shard_forward_sp
from vit_tpu_torch.parallel.sharding import param_pspecs, shard_params

__all__ = ["make_mesh", "mesh_shape_for", "param_pspecs", "shard_params", "pp_param_pspecs",
           "shard_forward_pp", "make_pp_train_step", "attention_sp", "shard_forward_sp",
           "make_sp_train_step"]

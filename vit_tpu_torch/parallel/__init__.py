"""Parallelism: a rank mesh with named axes and the tensor-parallel sharding
rules, over ``torch.distributed`` (one process per rank) — counterpart of
``vit_tpu.parallel``.  ``shard_forward.py`` runs a forward data-parallel,
``tp_forward.py`` the fused and W8A8 kernel paths tensor-parallel."""

from vit_tpu_torch.parallel.mesh import make_mesh, mesh_shape_for
from vit_tpu_torch.parallel.sharding import param_pspecs, shard_params

__all__ = ["make_mesh", "mesh_shape_for", "param_pspecs", "shard_params"]

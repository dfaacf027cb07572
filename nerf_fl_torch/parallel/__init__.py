"""Data- and tensor-parallel jobs over ``torch.distributed``: the
counterpart of ``nerf_fl_tpu/parallel/`` (``mesh``, ``multihost``) and the
launcher of a host's ranks (``launch``)."""
from . import launch, multihost  # noqa: F401
from .mesh import (  # noqa: F401
    Mesh, make_mesh, param_shardings, place_params, shard_batch,
    whole_params,
)

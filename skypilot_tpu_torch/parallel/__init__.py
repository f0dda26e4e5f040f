"""The port's parallel layer: meshes, sharding rules, the collectives
autograd differentiates and the replicated scheduler's control channel.

Ports `skypilot_tpu/parallel/__init__.py`'s exports (mesh.py and
sharding.py). `named_sharding` and `shard` have no counterpart here:
each rank holds its own slice and the forward writes its collectives
out (`parallel/sharding.py`, `parallel/collectives.py`). `pipeline.py`
is the next slice.
"""
from skypilot_tpu_torch.parallel.mesh import (AXIS_ORDER, Mesh, MeshSpec,
                                              initialize_distributed,
                                              make_hybrid_mesh, make_mesh,
                                              mesh_from_env,
                                              tensor_parallel, use_mesh)
from skypilot_tpu_torch.parallel.sharding import (DEFAULT_RULES, Shard,
                                                  kv_page_axes, spec_for,
                                                  tree_map, tree_shardings)

__all__ = [
    'AXIS_ORDER', 'Mesh', 'MeshSpec', 'initialize_distributed',
    'make_hybrid_mesh', 'make_mesh', 'mesh_from_env', 'tensor_parallel',
    'use_mesh', 'DEFAULT_RULES',
    'Shard', 'kv_page_axes', 'spec_for', 'tree_map', 'tree_shardings',
]

"""The mesh substrate on ``torch.distributed``.

Counterpart of ``sntc_tpu/parallel/``: :mod:`.mesh` (meshes, placement,
``map_at``/``reduce_at``, the collective evidence), :mod:`.collectives`
(``shard_batch`` and ``make_tree_aggregate`` with its resize and OOM
split), :mod:`.context` (the default and the serve mesh) and
:mod:`.distributed` (process groups).  The names exported are the JAX
package's.
"""

from sntc_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MESH_AXES,
    MODEL_AXIS,
    data_sharding,
    default_mesh,
    hybrid_mesh,
    make_mesh,
    map_at,
    map_reduce_at,
    reduce_at,
    replicated_sharding,
    sharded_jit,
)
from sntc_tpu_torch.parallel.collectives import (
    get_collective_domain,
    make_tree_aggregate,
    pad_rows,
    set_collective_domain,
    shard_batch,
    shard_weights,
    tree_aggregate,
)
from sntc_tpu_torch.parallel.distributed import (
    global_mesh,
    initialize,
    process_info,
)

__all__ = [
    "DATA_AXIS",
    "MESH_AXES",
    "MODEL_AXIS",
    "default_mesh",
    "hybrid_mesh",
    "make_mesh",
    "map_at",
    "map_reduce_at",
    "reduce_at",
    "data_sharding",
    "replicated_sharding",
    "sharded_jit",
    "pad_rows",
    "shard_batch",
    "shard_weights",
    "tree_aggregate",
    "make_tree_aggregate",
    "get_collective_domain",
    "set_collective_domain",
    "initialize",
    "global_mesh",
    "process_info",
]

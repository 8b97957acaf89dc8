"""Multi-GPU execution over torch.distributed (counterpart of
vireo_tpu/parallel): the (vars, cells) mesh and its collectives
(`mesh`), per-rank cell ranges (`loader`), the launcher of spawned
ranks (`launch`) and the multi-rank dry run (`dryrun`).

Importing this package imports none of its modules' dependencies
beyond torch: `mesh` imports the counts and model modules inside the
functions that need them, so that `ops/packed.py` can build on
`mesh.ShardedCounts`.
"""

from .mesh import (CELL_AXIS, VAR_AXIS, Mesh, Layout, ShardedCounts,
                   make_mesh, make_mesh2d, count_spec, n_cell_shards,
                   initialize_distributed)

__all__ = ["CELL_AXIS", "VAR_AXIS", "Mesh", "Layout", "ShardedCounts",
           "make_mesh", "make_mesh2d", "count_spec", "n_cell_shards",
           "initialize_distributed"]

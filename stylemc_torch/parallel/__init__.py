from .mesh import (DataMesh, all_gather_rows, all_reduce_sum, best_zoo_mesh,
                   data_mesh, initialize_distributed, replicate, shard_batch,
                   zoo_mesh)
from . import stats

__all__ = ["DataMesh", "data_mesh", "zoo_mesh", "best_zoo_mesh",
           "replicate", "shard_batch", "initialize_distributed",
           "all_reduce_sum", "all_gather_rows", "stats"]

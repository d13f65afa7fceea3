"""Multi-device parallelism: meshes, shardings, sharded time-axis scans.

Port of ``waveformanalysis_tpu/parallel``: a mesh is a grid of
``torch.device`` objects driven from one process (``parallel/mesh.py``).
"""

from waveformanalysis_tpu_torch.parallel.mesh import (
    data_sharding,
    make_mesh,
    pad_to_shards,
    replicated,
)
from waveformanalysis_tpu_torch.parallel.scan import (
    make_sharded_pipeline,
    shard_halo_exchange,
    shard_table_arrays,
)

__all__ = [
    "make_mesh",
    "data_sharding",
    "replicated",
    "pad_to_shards",
    "make_sharded_pipeline",
    "shard_halo_exchange",
    "shard_table_arrays",
]

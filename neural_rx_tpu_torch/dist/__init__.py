"""Several GPUs: a ("data", "grid") mesh of `torch.distributed` ranks
(`mesh.py`), process start-up and per-rank generators (`multihost.py`),
and the stack and iteration kernels on subcarrier shards with halo
exchange (`fused_sharded.py`)."""

from .mesh import batch_grid_sharding, constrain, make_mesh

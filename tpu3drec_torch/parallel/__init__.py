"""Process mesh, sharding helpers, ring collectives, multi-process runtime."""

from tpu3drec_torch.parallel.mesh import MESH_AXES, make_mesh, shard_batch

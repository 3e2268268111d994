"""Data parallelism over ``torch.distributed`` (replicated parameters,
batch rows sharded over the ranks): ``mesh`` and ``multihost``."""

from depth_image_captioning_pub_torch.parallel.mesh import (
    make_mesh, shard_batch, replicate, batch_sharding)

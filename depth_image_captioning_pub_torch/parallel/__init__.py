"""Parallelism over ``torch.distributed``: data parallelism (replicated
parameters, batch rows sharded over the ranks: ``mesh`` and
``multihost``), tensor and sequence parallelism over a (data, model) grid
of ranks (``tp``) and a GPipe pipeline over a stage axis (``pp``)."""

from depth_image_captioning_pub_torch.parallel.mesh import (
    make_mesh, shard_batch, replicate, batch_sharding)

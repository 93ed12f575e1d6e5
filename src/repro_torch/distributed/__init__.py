"""Distributed restore: mesh-sharded archives, per-rank decode.

Port of ``src/repro/distributed``.  ``ShardedWriter`` partitions tensors
by their partition specs into per-host ``.szt`` shard archives plus a
JSON manifest (byte-identical with the reference's); ``ShardedRestorer``
decodes the shards concurrently and lands every entry directly in a
target ``NamedSharding`` as a ``DTensor`` -- the layout is
host-count-agnostic, so any write topology restores at any read topology.
"""

from repro_torch.distributed.partition import (axis_sizes_of, extract_slice,
                                               spec_parts, tile_extents,
                                               tile_slice)
from repro_torch.distributed.restore import ShardedRestorer
from repro_torch.distributed.shards import (ShardedWriter, ShardManifestError,
                                            chunk_name, load_manifest)

__all__ = [
    "ShardedWriter", "ShardedRestorer", "ShardManifestError",
    "axis_sizes_of", "spec_parts", "tile_extents", "tile_slice",
    "extract_slice", "chunk_name", "load_manifest",
]

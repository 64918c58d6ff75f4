"""Packed-record data plane: sharded record files, deterministic global
shuffle, per-host input sharding.

A copy of ``dexiraft_tpu/data/records`` over the port's own data modules;
a pack written by either package reads in the other, byte for byte.

The streaming-scale answer to the raw-file loader: an offline packer
(``python -m dexiraft_tpu_torch pack_records``) decodes a fetch_dataset
stage ONCE into self-describing CRC-framed shard files + a JSON
manifest, and RecordLoader serves the exact Loader.batches() contract
from them — O(1) seek for exact-resume, disjoint per-host slices for
multi-host meshes, augmentation still fresh per (seed, epoch, index) in
the worker pool. Everything here is numpy + stdlib: no torch import, safe for
process-pool workers and offline tooling.
"""

from dexiraft_tpu_torch.data.records.dataset import (
    RecordMember,
    ShardedRecordSet,
    open_records,
)
from dexiraft_tpu_torch.data.records.format import (
    RecordCorruptError,
    RecordShardReader,
    RecordShardWriter,
)
from dexiraft_tpu_torch.data.records.loader import (
    RecordLoader,
    RecordPipelineStats,
)
from dexiraft_tpu_torch.data.records.manifest import (
    Manifest,
    MemberInfo,
    ShardInfo,
    load_manifest,
    save_manifest,
)
from dexiraft_tpu_torch.data.records.packer import (
    pack_dataset,
    verify_records,
)

__all__ = [
    "Manifest",
    "MemberInfo",
    "RecordCorruptError",
    "RecordLoader",
    "RecordMember",
    "RecordPipelineStats",
    "RecordShardReader",
    "RecordShardWriter",
    "ShardInfo",
    "ShardedRecordSet",
    "load_manifest",
    "open_records",
    "pack_dataset",
    "save_manifest",
    "verify_records",
]

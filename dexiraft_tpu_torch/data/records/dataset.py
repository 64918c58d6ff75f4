"""Record-backed datasets: the packed mirror of datasets.fetch_dataset.

``open_records(records_dir)`` rebuilds the packed stage's mixture
structure from the manifest — one ``RecordMember`` per original member,
with the same length (repeat expanded), the same sparse flag, and an
augmentor rebuilt from the same four recipe knobs — composed through the
ordinary ``ConcatFlowDataset``. Because ``FlowDataset.sample`` is
`_load_raw -> augment(rng, ...)` and the records hold byte-identical
``_load_raw`` output, a RecordDataset sample is bit-exact against the
raw stage's for any (index, rng): the raw loader and the record loader
feed the same training run.

Record ids map to shards by contiguous ranges (manifest order); the
record set resolves id -> (shard, local) with one searchsorted over the
cumulative counts and each shard read is O(1) via the shard's trailing
index. Readers are thread-safe (positioned pread) and pickle down to
paths for process-pool workers.
"""

from __future__ import annotations

import os.path as osp
from typing import List, Optional

import numpy as np

from dexiraft_tpu_torch.data.datasets import (
    ConcatFlowDataset,
    FlowDataset,
    Sample,
)
from dexiraft_tpu_torch.data.records.format import RecordShardReader
from dexiraft_tpu_torch.data.records.manifest import Manifest, load_manifest


class ShardedRecordSet:
    """Flat record-id address space over a directory of shards."""

    def __init__(self, records_dir: str, manifest: Optional[Manifest] = None):
        self.records_dir = records_dir
        self.manifest = manifest or load_manifest(records_dir)
        self._readers = [RecordShardReader(osp.join(records_dir, s.file))
                         for s in self.manifest.shards]
        # cumulative record counts: record id r lives in the shard whose
        # range [starts[s], starts[s+1]) contains it
        self._starts = np.cumsum(
            [0] + [s.records for s in self.manifest.shards])

    def __len__(self) -> int:
        return self.manifest.num_records

    def read(self, record_id: int) -> Sample:
        if not 0 <= record_id < len(self):
            raise IndexError(
                f"record {record_id} out of range [0, {len(self)})")
        s = int(np.searchsorted(self._starts, record_id, side="right")) - 1
        return self._readers[s].read(record_id - int(self._starts[s]))

    def close(self) -> None:
        for r in self._readers:
            r.close()


class RecordMember(FlowDataset):
    """One packed mixture member: FlowDataset semantics (augment,
    repeat, sparse) with ``_load_raw`` served from the record set."""

    def __init__(self, recordset: ShardedRecordSet, lo: int, n_raw: int,
                 repeat: int, sparse: bool, aug_params: Optional[dict]):
        super().__init__(aug_params, sparse=sparse)
        self.recordset = recordset
        self.lo = lo
        self.n_raw = n_raw
        self.repeat = repeat

    def __len__(self) -> int:
        return self.n_raw * self.repeat

    def _load_raw(self, index: int) -> Sample:
        return self.recordset.read(self.lo + index % self.n_raw)


def open_records(records_dir: str, *, augment: bool = True):
    """Open a packed dataset for training.

    Returns a FlowDataset-shaped object (RecordMember, or a
    ConcatFlowDataset of them for mixtures) with ``.manifest`` and
    ``.recordset`` attached. ``augment=False`` drops every member's
    augmentor — raw decoded arrays out, for verification and benches.
    """
    recordset = ShardedRecordSet(records_dir)
    manifest = recordset.manifest
    members: List[RecordMember] = []
    for m in manifest.members:
        aug = dict(m.aug) if (augment and m.aug is not None) else None
        members.append(RecordMember(recordset, m.records[0], m.n_raw,
                                    m.repeat, m.sparse, aug))
    ds = members[0] if len(members) == 1 else ConcatFlowDataset(members)
    ds.manifest = manifest
    ds.recordset = recordset
    return ds


__all__ = ["ShardedRecordSet", "RecordMember", "open_records"]

"""RecordLoader: the packed-record implementation of the Loader contract.

Identical batch semantics to ``data.loader.Loader`` — the exact
``batches(start_epoch=, start_offset=)`` stream, the epoch-seeded
``epoch_permutation`` global shuffle, the static ``(host_id, num_hosts)``
partition of every global batch, augmentation in the worker pool, and
the bounded retry/skip/count fault discipline — but ``_load_raw`` is
an O(1) indexed shard read instead of a raw-file decode. The two
loaders produce the identical batch stream for the same stage and seed
(pinned by test), so FRESH runs can pick either path freely — but a
mid-trajectory --resume never swaps planes: the checkpoint's stream
record carries the ``loader_kind`` and the pack's fingerprint, and a
swap is refused loudly, by design (resilience.stream.LoaderKindMismatch).

What records adds on top of the base loader is visibility:
``RecordPipelineStats`` extends PipelineStats with ``records/*``
counters — reads that succeeded and CRC/framing failures — so a pack
quietly rotting on disk shows up in the training log's pipeline line,
not just as mysterious retries.
"""

from __future__ import annotations

from typing import Dict, Union

from dexiraft_tpu_torch.data.loader import Loader, PipelineStats
from dexiraft_tpu_torch.data.records.dataset import open_records
from dexiraft_tpu_torch.data.records.format import RecordCorruptError


class RecordPipelineStats(PipelineStats):
    """PipelineStats + the record plane's own fault/health counters."""

    def reset(self) -> None:
        super().reset()
        self.record_reads = 0         # samples served from shards
        self.record_crc_failures = 0  # CRC/framing violations observed
                                      # (each also charges one retry)

    def as_dict(self) -> Dict[str, int]:
        d = super().as_dict()
        d["records/reads"] = self.record_reads
        d["records/crc_failures"] = self.record_crc_failures
        return d

    def summary(self) -> str:
        base = super().summary()
        if not self.record_crc_failures:
            return base
        return (f"{base}; {self.record_crc_failures} record CRC "
                f"failure(s) over {self.record_reads} record reads")


class RecordLoader(Loader):
    """Loader over a packed-records directory (or an already-open
    record dataset from ``open_records``)."""

    def __init__(self, records: Union[str, object], batch_size: int,
                 **loader_kwargs):
        if isinstance(records, str):
            records = open_records(records)
        if not hasattr(records, "manifest"):
            raise TypeError(
                "RecordLoader needs a records directory path or a dataset "
                "from open_records(); for raw-file datasets use Loader")
        super().__init__(records, batch_size, **loader_kwargs)
        self.manifest = records.manifest
        self.stats = RecordPipelineStats()

    def _note_decode_ok(self) -> None:
        self.stats.record_reads += 1

    def _note_decode_error(self, exc: BaseException) -> None:
        if isinstance(exc, RecordCorruptError):
            self.stats.record_crc_failures += 1

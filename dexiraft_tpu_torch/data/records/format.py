"""Sharded record-file format: the on-disk unit of the packed data plane.

One shard is a self-describing append-only file of decoded samples:

  header   32 B   magic "DXRREC1\\n", format version, flags, record count
  records  per record: payload length (u64 LE), crc32 (u32 LE), payload
                 — the payload is a standard uncompressed .npz archive of
                 the sample's arrays (np.savez), so a shard is readable
                 with nothing but numpy and this 40-line framing
  index    u64 byte-offset per record, then a 24 B trailer
                 (index offset, record count, magic "DXRIDX1\\n")

The trailing index is what makes ``seek(i)`` O(1): a reader maps record
id -> byte offset with one array lookup, so exact-resume positions a
shard without touching any earlier record (the raw-file loader pays a
full decode per sample instead). Reads go through ``os.pread`` on one
shared fd — positioned, syscall-level reads with no shared file cursor,
so a thread-pool of decode workers needs no locking; process-pool
workers re-open the fd lazily after pickling (``__getstate__`` drops it).

Corruption discipline: every framing violation — bad magic,
truncated record, CRC mismatch, malformed npz — raises
``RecordCorruptError``, which the loader's bounded retry/skip/count
machinery treats like any other decode fault. A flipped bit degrades
one sample, never the run.
"""

from __future__ import annotations

import io
import os
import struct
import threading
import zlib
from typing import Dict, List, Optional

import numpy as np

MAGIC = b"DXRREC1\n"
INDEX_MAGIC = b"DXRIDX1\n"
FORMAT_VERSION = 1

_HEADER = struct.Struct("<8sIIQQ")      # magic, version, flags, count, reserved
_REC_HEAD = struct.Struct("<QI")        # payload length, crc32
_TRAILER = struct.Struct("<QQ8s")       # index offset, count, magic

Sample = Dict[str, np.ndarray]


class RecordCorruptError(RuntimeError):
    """A record (or its shard framing) failed an integrity check."""


def encode_sample(sample: Sample) -> bytes:
    """Sample dict -> uncompressed npz bytes (bit-exact round-trip)."""
    buf = io.BytesIO()
    np.savez(buf, **sample)
    return buf.getvalue()


_EOCD_SIG = b"PK\x05\x06"
_CDIR_SIG = b"PK\x01\x02"


def _fast_npz_entries(payload: bytes):
    """Parse a ZIP_STORED npz's central directory by hand: (name, data
    slice) per entry, or None when the layout is anything but the plain
    stored zip np.savez writes (the caller then falls back to np.load).

    Why: zipfile re-CRCs every entry on read, but the record framing
    already CRC'd the WHOLE payload — going through ZipFile costs a
    second integrity pass plus its object machinery per record, which
    benchmarked as the majority of the packed plane's decode time.
    """
    eocd = payload.rfind(_EOCD_SIG, max(0, len(payload) - 65557))
    if eocd < 0 or len(payload) < eocd + 22:
        return None
    n_entries = int.from_bytes(payload[eocd + 10:eocd + 12], "little")
    cdir_off = int.from_bytes(payload[eocd + 16:eocd + 20], "little")
    entries = []
    pos = cdir_off
    for _ in range(n_entries):
        if payload[pos:pos + 4] != _CDIR_SIG:
            return None
        method = int.from_bytes(payload[pos + 10:pos + 12], "little")
        csize = int.from_bytes(payload[pos + 20:pos + 24], "little")
        name_len = int.from_bytes(payload[pos + 28:pos + 30], "little")
        extra_len = int.from_bytes(payload[pos + 30:pos + 32], "little")
        comment_len = int.from_bytes(payload[pos + 32:pos + 34], "little")
        local_off = int.from_bytes(payload[pos + 42:pos + 46], "little")
        if method != 0 or csize == 0xFFFFFFFF or local_off == 0xFFFFFFFF:
            return None  # compressed or zip64-indirected: not our writer
        name = payload[pos + 46:pos + 46 + name_len].decode("ascii",
                                                            "replace")
        # local header: 30 fixed bytes + its OWN name/extra lengths
        ln = int.from_bytes(payload[local_off + 26:local_off + 28],
                            "little")
        le = int.from_bytes(payload[local_off + 28:local_off + 30],
                            "little")
        data_off = local_off + 30 + ln + le
        if data_off + csize > len(payload):
            return None
        entries.append((name, payload[data_off:data_off + csize]))
        pos += 46 + name_len + extra_len + comment_len
    return entries


def decode_sample(payload: bytes) -> Sample:
    try:
        entries = _fast_npz_entries(payload)
        if entries is not None:
            out = {}
            for name, blob in entries:
                key = name[:-4] if name.endswith(".npy") else name
                out[key] = np.lib.format.read_array(io.BytesIO(blob),
                                                    allow_pickle=False)
            return out
        with np.load(io.BytesIO(payload), allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except Exception as e:  # zipfile/numpy raise a zoo of types here
        raise RecordCorruptError(f"undecodable record payload: {e}") from e


class RecordShardWriter:
    """Sequential writer; ``close()`` appends the index and patches the
    header count, so a crash mid-pack leaves an obviously-invalid shard
    (count 0, no trailer) rather than a silently short one."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "wb")
        self._offsets: List[int] = []
        self._f.write(_HEADER.pack(MAGIC, FORMAT_VERSION, 0, 0, 0))
        self._closed = False

    def append(self, sample: Sample) -> int:
        payload = encode_sample(sample)
        self._offsets.append(self._f.tell())
        self._f.write(_REC_HEAD.pack(len(payload), zlib.crc32(payload)))
        self._f.write(payload)
        return len(self._offsets) - 1

    @property
    def num_records(self) -> int:
        return len(self._offsets)

    @property
    def num_bytes(self) -> int:
        return self._f.tell()

    def close(self) -> None:
        if self._closed:
            return
        index_offset = self._f.tell()
        if self._offsets:
            self._f.write(np.asarray(self._offsets, "<u8").tobytes())
        self._f.write(_TRAILER.pack(index_offset, len(self._offsets),
                                    INDEX_MAGIC))
        self._f.seek(0)
        self._f.write(_HEADER.pack(MAGIC, FORMAT_VERSION, 0,
                                   len(self._offsets), 0))
        self._f.close()
        self._closed = True

    def __enter__(self) -> "RecordShardWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class RecordShardReader:
    """Random-access reader over one shard.

    ``read(i)`` is an O(1) index lookup + one positioned read;
    ``seek(i)`` just sets the sequential cursor for ``next()``/iteration.
    Thread-safe by construction (os.pread, no shared cursor state beyond
    the explicit sequential position) and pickle-safe for process-pool
    workers (the fd and index reload lazily on first use).
    """

    def __init__(self, path: str):
        self.path = path
        self._fd: Optional[int] = None
        self._offsets: Optional[np.ndarray] = None
        self._num_records: Optional[int] = None
        self._pos = 0
        self._lock = threading.Lock()

    # -- lazy state (survives pickling to process workers) --

    def __getstate__(self):
        return {"path": self.path, "_pos": self._pos}

    def __setstate__(self, state):
        self.__init__(state["path"])
        self._pos = state["_pos"]

    def _file(self) -> int:
        if self._fd is None:
            with self._lock:
                if self._fd is None:
                    self._fd = os.open(self.path, os.O_RDONLY)
        return self._fd

    def _pread(self, n: int, offset: int) -> bytes:
        data = os.pread(self._file(), n, offset)
        if len(data) != n:
            raise RecordCorruptError(
                f"{self.path}: truncated read at offset {offset} "
                f"(wanted {n} bytes, got {len(data)})")
        return data

    def _load_index(self) -> np.ndarray:
        if self._offsets is not None:
            return self._offsets
        size = os.fstat(self._file()).st_size
        if size < _HEADER.size + _TRAILER.size:
            raise RecordCorruptError(f"{self.path}: file too short ({size} B)")
        magic, version, _flags, count, _ = _HEADER.unpack(
            self._pread(_HEADER.size, 0))
        if magic != MAGIC:
            raise RecordCorruptError(f"{self.path}: bad shard magic {magic!r}")
        if version != FORMAT_VERSION:
            raise RecordCorruptError(
                f"{self.path}: unsupported format version {version}")
        index_offset, trailer_count, index_magic = _TRAILER.unpack(
            self._pread(_TRAILER.size, size - _TRAILER.size))
        if index_magic != INDEX_MAGIC or trailer_count != count:
            raise RecordCorruptError(
                f"{self.path}: bad index trailer (magic {index_magic!r}, "
                f"header count {count}, trailer count {trailer_count}) — "
                f"the shard was not closed cleanly")
        raw = self._pread(8 * count, index_offset)
        self._offsets = np.frombuffer(raw, "<u8")
        self._num_records = int(count)
        return self._offsets

    def __len__(self) -> int:
        if self._num_records is None:
            self._load_index()
        return self._num_records

    def read(self, i: int) -> Sample:
        """Record ``i``, CRC-verified. O(1) w.r.t. the shard size."""
        offsets = self._load_index()
        if not 0 <= i < len(offsets):
            raise IndexError(f"record {i} out of range [0, {len(offsets)})")
        off = int(offsets[i])
        length, crc = _REC_HEAD.unpack(self._pread(_REC_HEAD.size, off))
        payload = self._pread(int(length), off + _REC_HEAD.size)
        if zlib.crc32(payload) != crc:
            raise RecordCorruptError(
                f"{self.path}: CRC mismatch on record {i} "
                f"(offset {off}, {length} B)")
        return decode_sample(payload)

    def seek(self, i: int) -> None:
        """Position the sequential cursor at record ``i`` (O(1))."""
        if not 0 <= i <= len(self):
            raise IndexError(f"seek({i}) out of range [0, {len(self)}]")
        self._pos = i

    def __iter__(self):
        while self._pos < len(self):
            out = self.read(self._pos)
            self._pos += 1
            yield out

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None

    def __enter__(self) -> "RecordShardReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

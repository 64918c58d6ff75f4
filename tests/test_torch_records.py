"""The port's packed-record data plane (dexiraft_tpu_torch/data/records)
held against the JAX package's (dexiraft_tpu/data/records) on the CPU.

One small chairs tree (6 pairs at 96x128, written by the port's
data/synthetic.py), mixed twice (``2 * ds``) and cropped to 64x96, is
packed by both packages into 3 shards. np.savez stamps every archive
member with the wall clock (2 s resolution), so both packs are written
under one frozen clock; then the shard files are byte-equal and the
manifests equal, fingerprint included. Each package reads the other's
pack, and every sample is bit-exact against ``FlyingChairs.sample``. The
port's ``RecordLoader`` serves the batches, bit for bit, of the JAX
package's ``RecordLoader`` and of the port's raw ``Loader``, for 1, 2 and
4 hosts and after a mid-epoch seek.
"""

import filecmp
import json
import os
import shutil
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest

from dexiraft_tpu.data import records as j_records
from dexiraft_tpu.data.datasets import FlyingChairs as JFlyingChairs
from dexiraft_tpu.data.loader import epoch_permutation as j_permutation
from dexiraft_tpu.resilience import stream as j_stream
from dexiraft_tpu_torch.data import records
from dexiraft_tpu_torch.data.datasets import FlyingChairs
from dexiraft_tpu_torch.data.loader import Loader, epoch_permutation
from dexiraft_tpu_torch.data.synthetic import write_chairs_tree
from dexiraft_tpu_torch.resilience.stream import (LoaderKindMismatch,
                                                  StreamPosition,
                                                  position_extra,
                                                  position_from_extra)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUG = dict(crop_size=(64, 96), min_scale=-0.1, max_scale=1.0, do_flip=True)
FROZEN_CLOCK = 1.7e9  # np.savez's member timestamps, for byte equality


def _pack(pack_fn, ds, out, **kw):
    with mock.patch("time.time", return_value=FROZEN_CLOCK):
        return pack_fn(2 * ds, out, num_shards=3, stage="chairs",
                       image_size=AUG["crop_size"], **kw)


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    """The tree, both packages' datasets over it and both packs."""
    root = tmp_path_factory.mktemp("torch_records")
    data = write_chairs_tree(str(root), n_train=6, n_val=0, hw=(96, 128))
    ds = FlyingChairs(AUG, split="training", root=data)
    j_ds = JFlyingChairs(AUG, split="training", root=data)
    port_dir, jax_dir = str(root / "port"), str(root / "jax")
    man = _pack(records.pack_dataset, ds, port_dir)
    j_man = _pack(j_records.pack_dataset, j_ds, jax_dir)
    return dict(root=root, ds=ds, j_ds=j_ds, port=port_dir, jax=jax_dir,
                man=man, j_man=j_man)


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_packs_are_byte_equal_with_equal_manifests(packs):
    man, j_man = packs["man"], packs["j_man"]
    assert man.as_dict() == j_man.as_dict()
    assert man.fingerprint == j_man.fingerprint
    assert [s.records for s in man.shards] == [2, 2, 2]
    assert man.num_records == 6 and man.num_samples == 12
    for s in man.shards:
        assert filecmp.cmp(os.path.join(packs["port"], s.file),
                           os.path.join(packs["jax"], s.file),
                           shallow=False), s.file
    with open(os.path.join(packs["port"], "manifest.json")) as f, \
            open(os.path.join(packs["jax"], "manifest.json")) as g:
        assert json.load(f) == json.load(g)


@pytest.mark.parametrize("pack", ["port", "jax"])
def test_each_package_reads_either_pack_bit_exact(packs, pack):
    """Both readers over ``pack``: every sample equals the raw stage's
    ``FlyingChairs.sample`` for the same (index, rng), in both packages,
    repeats and augmentation included."""
    rds = records.open_records(packs[pack])
    j_rds = j_records.open_records(packs[pack])
    raw, j_raw = 2 * packs["ds"], 2 * packs["j_ds"]
    assert len(rds) == len(j_rds) == len(raw) == 12
    for i in range(len(rds)):
        key = (7, 0, i)
        want = raw.sample(i, np.random.default_rng(key))
        _assert_same(want, j_raw.sample(i, np.random.default_rng(key)))
        _assert_same(want, rds.sample(i, np.random.default_rng(key)))
        _assert_same(want, j_rds.sample(i, np.random.default_rng(key)))
    plain = records.open_records(packs[pack], augment=False)
    _assert_same(packs["ds"]._load_raw(3), plain._load_raw(3))
    assert plain._load_raw(3)["image1"].dtype == np.uint8


def test_reader_seek_and_random_access(packs):
    man = packs["man"]
    path = os.path.join(packs["port"], man.shards[0].file)
    with records.RecordShardReader(path) as r:
        sequential = list(iter(r))
        assert len(sequential) == len(r) == 2
        for i in (1, 0, 1):
            _assert_same(r.read(i), sequential[i])
        r.seek(1)  # O(1) reposition of the sequential cursor
        _assert_same(next(iter(r)), sequential[1])
        with pytest.raises(IndexError):
            r.seek(3)
    rs = records.ShardedRecordSet(packs["port"])
    _assert_same(rs.read(5), packs["ds"]._load_raw(5))
    rs.close()


def _flip_byte(src, dst, shard, offset):
    shutil.copytree(src, dst)
    path = os.path.join(dst, shard)
    blob = bytearray(open(path, "rb").read())
    blob[offset] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(blob))
    return path


def test_crc_flip_is_caught_counted_skipped_and_backfilled(packs, tmp_path):
    man = packs["man"]
    assert records.verify_records(packs["port"]) == []
    bad = str(tmp_path / "bad")
    path = _flip_byte(packs["port"], bad, man.shards[0].file, 100)
    problems = records.verify_records(bad)
    assert problems and any("CRC" in p for p in problems)
    assert j_records.verify_records(bad) == problems
    with pytest.raises(records.RecordCorruptError):
        r = records.RecordShardReader(path)
        for i in range(len(r)):
            r.read(i)
    loader = records.RecordLoader(bad, 12, seed=3, num_workers=2,
                                  max_retries=1, retry_backoff_s=0.0)
    it = loader.batches()
    batch = next(it)  # every sample requested; the corrupt one backfilled
    it.close()
    assert batch["image1"].shape[0] == 12
    st = loader.stats
    assert st.record_crc_failures >= 1 and st.skipped_samples >= 1
    assert st.retries >= 1
    d = st.as_dict()
    assert d["records/crc_failures"] == st.record_crc_failures
    assert d["records/reads"] > 0 and "CRC" in st.summary()


def test_repack_removes_stale_shards_and_names_the_true_count(packs,
                                                              tmp_path):
    out = str(tmp_path / "repack")
    records.pack_dataset(2 * packs["ds"], out, num_shards=6)
    m = records.pack_dataset(packs["ds"], out, num_shards=4)
    # 6 records at --shards 4 packs 3 shards of 2, every one "-of-00003"
    assert [s.records for s in m.shards] == [2, 2, 2]
    assert sorted(os.listdir(out)) == sorted(
        [s.file for s in m.shards] + ["manifest.json"])
    assert all(s.file.endswith("-of-00003.rec") for s in m.shards)
    assert records.verify_records(out) == []


def _batches(loader, n, **kw):
    it = loader.batches(**kw)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_global_shuffle_and_host_slices_equal_jax(packs, hosts):
    """The epoch permutation is JAX's, and each host's slice of the first
    global batches equals the JAX RecordLoader's for that host."""
    for seed, epoch, n in ((11, 0, 12), (123, 4, 17)):
        np.testing.assert_array_equal(epoch_permutation(seed, epoch, n),
                                      j_permutation(seed, epoch, n))
    seen = []
    for h in range(hosts):
        kw = dict(seed=11, process_index=h, process_count=hosts,
                  num_workers=1)
        got = _batches(records.RecordLoader(packs["port"], 4, **kw), 3)
        want = _batches(j_records.RecordLoader(packs["jax"], 4, **kw), 3)
        for a, b in zip(got, want):
            _assert_same(a, b)
            assert a["image1"].shape[0] == 4 // hosts
        seen.append(got)
    if hosts > 1:  # the hosts' slices are disjoint samples
        assert not np.array_equal(seen[0][0]["image1"],
                                  seen[1][0]["image1"])


def test_record_loader_equals_jax_and_raw_loader(packs):
    """Port RecordLoader == JAX RecordLoader == port raw Loader, bit for
    bit, over an epoch boundary and after a mid-epoch seek."""
    mk = [lambda: records.RecordLoader(packs["port"], 4, seed=5,
                                       num_workers=2),
          lambda: j_records.RecordLoader(packs["jax"], 4, seed=5,
                                         num_workers=2),
          lambda: Loader(2 * packs["ds"], 4, seed=5, num_workers=2)]
    full = [_batches(m(), 5) for m in mk]
    for i in range(5):
        _assert_same(full[0][i], full[1][i])
        _assert_same(full[0][i], full[2][i])
    # 12 samples at batch 4: 3 batches an epoch, so (1, 1) is batch 4
    resumed = [_batches(m(), 1, start_epoch=1, start_offset=1)[0]
               for m in mk]
    for r in resumed:
        _assert_same(r, full[0][4])
    loader = mk[0]()
    it = loader.batches()
    next(it)
    next(it)
    it.close()
    assert list(loader.positions) == [(0, 0), (0, 1)]


def test_loader_kind_mismatch_kind_fingerprint_and_legacy(tmp_path):
    """The checkpoint's stream entries refuse a raw<->records swap and a
    different pack with the JAX package's messages; entries without a
    kind (older checkpoints) resume under either loader."""
    d = str(tmp_path)
    cases = [  # (saved kind, saved fp, current kind, current fp)
        ("raw", None, "records", "a" * 40),
        ("records", "a" * 40, "raw", None),
        ("records", "a" * 40, "records", "b" * 40),
    ]
    for step, (kind, fp, now, now_fp) in enumerate(cases, 1):
        pos = StreamPosition(2, step)
        extra = position_extra(pos, seed=1, loader_kind=kind,
                               fingerprint=fp)
        assert extra["stream"] == (2, step)
        j_stream.save_position(d, step, j_stream.StreamPosition(2, step),
                               seed=1, loader_kind=kind, fingerprint=fp)
        with pytest.raises(LoaderKindMismatch) as got:
            position_from_extra(extra, step, seed=1, loader_kind=now,
                                fingerprint=now_fp)
        with pytest.raises(j_stream.LoaderKindMismatch) as want:
            j_stream.load_position(d, step, seed=1, loader_kind=now,
                                   fingerprint=now_fp)
        assert str(got.value) == str(want.value)
    with pytest.raises(LoaderKindMismatch, match="drop --records_dir"):
        position_from_extra(position_extra(StreamPosition(),
                                           loader_kind="raw"),
                            1, loader_kind="records")
    # matching kind and pack resume; a legacy entry resumes either way
    same = position_extra(StreamPosition(1, 3), seed=1,
                          loader_kind="records", fingerprint="a" * 40)
    assert position_from_extra(same, 9, seed=1, loader_kind="records",
                                fingerprint="a" * 40) == StreamPosition(1, 3)
    legacy = {"stream": (1, 2)}
    for kind, fp in (("raw", None), ("records", "c" * 40)):
        assert position_from_extra(legacy, 9, seed=1, loader_kind=kind,
                                   fingerprint=fp) == StreamPosition(1, 2)
    assert position_from_extra({}, 9, loader_kind="raw") is None
    assert StreamPosition(0, 2).advance(1, 3) == StreamPosition(1, 0)


def test_crop_recipe_changes_fingerprint(packs, tmp_path):
    import copy

    other = copy.copy(packs["ds"])
    other.augmentor = type(packs["ds"].augmentor)(
        crop_size=(32, 48), min_scale=-0.1, max_scale=1.0, do_flip=True)
    m2 = records.pack_dataset(other, str(tmp_path / "crop"), num_shards=1)
    assert m2.fingerprint != packs["man"].fingerprint


def test_pack_records_cli_packs_verifies_and_fails_on_corruption(
        packs, tmp_path, monkeypatch, capsys):
    from dexiraft_tpu_torch import pack_records

    monkeypatch.setenv("DEXIRAFT_DATA_DIR", str(packs["root"]))
    out = str(tmp_path / "cli")
    assert pack_records.main(["--stage", "chairs", "--image_size", "64",
                              "96", "--shards", "2", "--out", out,
                              "--verify"]) == 0
    text = capsys.readouterr().out
    assert "[pack] 6 records (6 logical samples) -> 2 shard(s)" in text
    assert "[verify] OK" in text
    m = records.load_manifest(out)
    assert (m.stage, m.image_size, m.train_ds) == ("chairs", (64, 96),
                                                   "C+T+K+S+H")
    _flip_byte(out, str(tmp_path / "cli_bad"), m.shards[1].file, 200)
    proc = subprocess.run(
        [sys.executable, "-m", "dexiraft_tpu_torch", "pack_records",
         "--verify_only", "--out", str(tmp_path / "cli_bad")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and "[verify] FAIL" in proc.stderr

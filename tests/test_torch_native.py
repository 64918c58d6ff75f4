"""The port's native decode bridge (dexiraft_tpu_torch/data/native.py) on
the CPU: the shared C++ codecs of native/dexiraft_native.cpp against the
port's pure-Python codecs and against the JAX package's bridge, single
files and batches; declined files, a batch with a file of other dims,
DEXIRAFT_NO_NATIVE=1, where the library is built, and flow_io's routing.

The cases that need the build skip only where there is no g++.
"""

import os
import shutil

import numpy as np
import pytest

from dexiraft_tpu.data import native as j_native
from dexiraft_tpu_torch.data import flow_io, native

PKG = os.path.dirname(os.path.abspath(native.__file__ + "/.."))
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ to build the native library")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Three .flo and three PPM files of 24x40, one PPM of other dims."""
    root = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(0)
    out = {"flo": [], "ppm": [], "flow": [], "img": []}
    for i in range(3):
        flow = rng.normal(size=(24, 40, 2)).astype(np.float32)
        img = rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)
        out["flo"].append(str(root / f"{i}.flo"))
        out["ppm"].append(str(root / f"{i}.ppm"))
        flow_io.write_flo(out["flo"][-1], flow)
        flow_io.write_ppm(out["ppm"][-1], img)
        out["flow"].append(flow)
        out["img"].append(img)
    out["odd"] = str(root / "odd.ppm")
    flow_io.write_ppm(out["odd"], rng.integers(0, 256, (20, 40, 3),
                                               dtype=np.uint8))
    out["root"] = root
    return out


def _pure(monkeypatch, fn, path):
    with monkeypatch.context() as m:
        m.setenv("DEXIRAFT_NO_NATIVE", "1")
        return fn(path)


@needs_gxx
def test_single_files_native_equal_pure_python_and_jax(files, monkeypatch):
    assert native.get_lib() is not None
    for path, want in zip(files["flo"], files["flow"]):
        got = native.read_flo_native(path)
        assert got.dtype == np.float32 and got.shape == (24, 40, 2)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, _pure(monkeypatch,
                                                 flow_io.read_flo, path))
        np.testing.assert_array_equal(got, j_native.read_flo_native(path))
    for path, want in zip(files["ppm"], files["img"]):
        got = native.read_ppm_native(path)
        assert got.dtype == np.uint8 and got.shape == (24, 40, 3)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, _pure(monkeypatch,
                                                 flow_io.read_ppm, path))
        np.testing.assert_array_equal(got, j_native.read_ppm_native(path))


@needs_gxx
def test_batches_native_equal_singles_and_jax(files):
    flows = native.read_flo_batch(files["flo"], 24, 40, nthreads=3)
    imgs = native.read_ppm_batch(files["ppm"], 24, 40, nthreads=3)
    assert flows.shape == (3, 24, 40, 2) and imgs.shape == (3, 24, 40, 3)
    np.testing.assert_array_equal(flows, np.stack(files["flow"]))
    np.testing.assert_array_equal(imgs, np.stack(files["img"]))
    np.testing.assert_array_equal(
        flows, j_native.read_flo_batch(files["flo"], 24, 40, nthreads=3))
    np.testing.assert_array_equal(
        imgs, j_native.read_ppm_batch(files["ppm"], 24, 40, nthreads=3))
    # a file of other dims in the batch is reported, not decoded into it
    with pytest.raises(IOError, match=r"\(-5\)"):
        native.read_ppm_batch(files["ppm"][:2] + [files["odd"]], 24, 40)
    with pytest.raises(IOError, match=r"\(-1\)"):
        native.read_flo_batch([str(files["root"] / "missing.flo")], 24, 40)


@needs_gxx
def test_bad_files_are_declined_not_raised(files, tmp_path):
    bad_flo = tmp_path / "bad.flo"
    bad_flo.write_bytes(b"not a flow file at all")
    ascii_ppm = tmp_path / "ascii.ppm"
    ascii_ppm.write_bytes(b"P3\n2 1\n255\n0 0 0 255 255 255\n")
    short_ppm = tmp_path / "short.ppm"
    short_ppm.write_bytes(b"P6\n4 4\n255\n" + bytes(10))
    assert native.read_flo_native(str(bad_flo)) is None
    assert native.read_flo_native(str(tmp_path / "missing.flo")) is None
    assert native.read_ppm_native(str(ascii_ppm)) is None
    assert native.read_ppm_native(str(short_ppm)) is None
    # the Python codec then owns the descriptive error
    with pytest.raises(ValueError, match="magic"):
        flow_io.read_flo(str(bad_flo))
    with pytest.raises(ValueError, match="not a binary PPM"):
        flow_io.read_ppm(str(ascii_ppm))
    with pytest.raises(ValueError, match="truncated"):
        flow_io.read_ppm(str(short_ppm))


def test_no_native_env_is_honoured(files, monkeypatch):
    monkeypatch.setenv("DEXIRAFT_NO_NATIVE", "1")
    assert native.get_lib() is None
    assert native.read_flo_native(files["flo"][0]) is None
    assert native.read_ppm_native(files["ppm"][0]) is None
    assert native.read_flo_batch(files["flo"], 24, 40) is None
    assert native.read_ppm_batch(files["ppm"], 24, 40) is None
    np.testing.assert_array_equal(flow_io.read_flo(files["flo"][0]),
                                  files["flow"][0])
    np.testing.assert_array_equal(flow_io.read_image(files["ppm"][0]),
                                  files["img"][0])


@needs_gxx
def test_library_is_built_under_the_port_build_dir(tmp_path, monkeypatch):
    """The port builds into dexiraft_tpu_torch/_build/native/ (never the
    JAX package's native/build/), through a private temp file published
    by rename."""
    path = native._SO
    assert path == os.path.join(PKG, "_build", "native",
                                "libdexiraft_native.so")
    assert os.path.join("native", "build") not in path
    lib = native.get_lib()
    assert lib is not None and os.path.samefile(lib._name, path)
    # a fresh build, into a scratch copy of that layout
    so = str(tmp_path / "_build" / "native" / "libdexiraft_native.so")
    monkeypatch.setattr(native, "_SO", so)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    fresh = native.get_lib()
    assert fresh is not None and os.path.samefile(fresh._name, so)
    assert os.listdir(os.path.dirname(so)) == ["libdexiraft_native.so"]
    # no g++ on the path: the build is declined, the codecs fall back
    monkeypatch.setattr(native, "_SO", str(tmp_path / "none" / "x.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert native.get_lib() is None


def test_flow_io_routes_through_the_bridge(files, monkeypatch):
    sentinel_flo = np.zeros((1, 1, 2), np.float32)
    sentinel_ppm = np.zeros((1, 1, 3), np.uint8)
    monkeypatch.setattr(native, "read_flo_native", lambda p: sentinel_flo)
    monkeypatch.setattr(native, "read_ppm_native", lambda p: sentinel_ppm)
    assert flow_io.read_flo(files["flo"][0]) is sentinel_flo
    assert flow_io.read_ppm(files["ppm"][0]) is sentinel_ppm
    assert flow_io.read_image(files["ppm"][0]) is sentinel_ppm
    assert flow_io.read_gen(files["flo"][0]) is sentinel_flo

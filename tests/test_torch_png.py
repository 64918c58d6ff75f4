"""The port's PNG codec (dexiraft_tpu_torch/data/png.py) against PIL and
cv2, and the port's PNG readers against the JAX package's.

Decoding is bit-exact: every file PIL or cv2 writes decodes to what they
read back, and every file the port writes reads back through them as the
array it was given. The five row filters all occur: four in PIL's adaptive
filter choice over a mixed image (PIL never picks Average), all five in a
hand-built file. The
dataset readers (KITTI, HD1K) give the JAX package's samples exactly
(JAX reads its frames through imageio and its 16-bit flow through cv2),
and a child process in which PIL, cv2 and imageio cannot be imported
validates and writes KITTI with the port on the CPU.
"""

import os
import struct
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from dexiraft_tpu_torch.data import png
from dexiraft_tpu_torch.data.flow_io import read_disp_kitti, \
    read_flow_kitti, read_image, write_flow_kitti
from dexiraft_tpu_torch.data.png import read_png, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mixed_image(h=96, w=128, seed=0):
    """Bands of noise, gradients, flat colour and a ramp texture, so that
    PIL's adaptive encoder picks each of its filter types somewhere."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 0.3 + yy * 0.1) % 256,
                    np.sin(xx / 30) * 100 + 128,
                    rng.integers(0, 256, (h, w))], -1)
    img[h // 4:h // 2] = (xx[h // 4:h // 2, :, None] * 2) % 256
    img[h // 2:5 * h // 8] = 77
    img[5 * h // 8:] += rng.integers(0, 4, (h - 5 * h // 8, w, 3))
    img[0] = 0
    return (img % 256).astype(np.uint8)


def _filter_types(path):
    """The filter type byte of every row of a (non-interlaced) PNG."""
    data = open(path, "rb").read()
    chunks = dict(png._chunks(path, data))
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    idat = b"".join(p for k, p in png._chunks(path, data) if k == b"IDAT")
    stride = w * png._CHANNELS[ctype] * depth // 8
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(h, stride + 1)[:, 0].tolist())


_PIL_MODES = {
    "L": lambda im: im[..., 0],
    "RGB": lambda im: im,
    "LA": lambda im: im[..., :2],
    "RGBA": lambda im: np.concatenate([im, im[..., :1]], -1),
}


@pytest.mark.parametrize("mode", ["L", "RGB", "P", "LA", "RGBA"])
@pytest.mark.parametrize("save", [dict(compress_level=0),
                                  dict(compress_level=1),
                                  dict(compress_level=6),
                                  dict(compress_level=9),
                                  dict(optimize=True)],
                         ids=["level0", "level1", "level6", "level9",
                              "optimize"])
def test_decodes_pil_files_bit_exact(tmp_path, mode, save):
    path = str(tmp_path / "a.png")
    img = _mixed_image()
    if mode == "P":
        Image.fromarray(img).convert("P").save(path, **save)
        want = np.asarray(Image.open(path).convert("RGB"))
    else:
        Image.fromarray(_PIL_MODES[mode](img), mode).save(path, **save)
        want = np.asarray(Image.open(path))
    got = read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_pil_files_use_every_filter_type_pil_writes(tmp_path):
    """The files of the test above carry None, Sub, Up and Paeth rows
    between them (PIL chooses one per row), so each type's decode was
    held. PIL's choice never takes Average, even on rows where it
    predicts exactly; the hand-built files below carry it."""
    seen = set()
    img = _mixed_image()
    for mode, view in _PIL_MODES.items():
        for level in (1, 6, 9):
            path = str(tmp_path / f"{mode}{level}.png")
            Image.fromarray(view(img), mode).save(path, compress_level=level)
            seen |= _filter_types(path)
    assert seen == {0, 1, 2, 4}


@pytest.mark.parametrize("shape", [(37, 53, 3), (375, 124, 3), (41, 29)])
def test_decodes_cv2_16bit_files_bit_exact(tmp_path, shape):
    """16-bit files as cv2 writes them (KITTI's flow and disparity)."""
    path = str(tmp_path / "k.png")
    rng = np.random.default_rng(len(shape))
    arr = rng.integers(0, 65536, shape, dtype=np.uint16)
    arr[: shape[0] // 2] = arr[: shape[0] // 2] // 64 + 2 ** 15  # smooth rows
    cv2.imwrite(path, arr)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if want.ndim == 3:
        want = want[..., ::-1]  # cv2 reads B, G, R
    got = read_png(path)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 3])
def test_hand_built_file_with_every_filter_type(tmp_path, dtype, channels):
    """One row of each filter type (0..4), then again in another order:
    the port decodes it, and so do PIL (8-bit) and cv2 (16-bit)."""
    path = str(tmp_path / "f.png")
    rng = np.random.default_rng(3)
    shape = (10, 23) + ((channels,) if channels == 3 else ())
    arr = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)
    order = [0, 1, 2, 3, 4, 4, 3, 2, 1, 0]
    write_png(path, arr, filters=order)
    raw = np.frombuffer(zlib.decompress(b"".join(
        p for k, p in png._chunks(path, open(path, "rb").read())
        if k == b"IDAT")), np.uint8)
    row = arr[0].size * arr.itemsize + 1
    assert raw[::row].tolist() == order
    np.testing.assert_array_equal(read_png(path), arr)
    if dtype == np.uint8:
        np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
    else:
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(
            want[..., ::-1] if want.ndim == 3 else want, arr)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("shape", [(20, 31), (20, 31, 1), (375, 62, 3)])
def test_port_files_read_back_through_pil_and_cv2(tmp_path, dtype, shape):
    path = str(tmp_path / "w.png")
    arr = np.random.default_rng(4).integers(0, np.iinfo(dtype).max + 1,
                                            shape, dtype=dtype)
    write_png(path, arr)
    flat = arr[..., 0] if arr.ndim == 3 and arr.shape[2] == 1 else arr
    np.testing.assert_array_equal(read_png(path), flat)
    cv = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(cv[..., ::-1] if cv.ndim == 3 else cv,
                                  flat)
    if dtype == np.uint8:
        np.testing.assert_array_equal(np.asarray(Image.open(path)), flat)


def _raw_png(path, w, h, depth, ctype, interlace, body=b""):
    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))
    with open(path, "wb") as f:
        f.write(png._SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                           0, 0, interlace)))
        f.write(chunk(b"IDAT", zlib.compress(body)))
        f.write(chunk(b"IEND", b""))


def test_refuses_interlaced_and_sub_byte_depths(tmp_path):
    bad = []
    p = str(tmp_path / "interlaced.png")
    _raw_png(p, 4, 4, 8, 2, 1)
    bad.append(p)
    for bits in (1, 2, 4):
        p = str(tmp_path / f"gray{bits}.png")
        _raw_png(p, 4, 4, bits, 0, 0)
        bad.append(p)
    p = str(tmp_path / "pil_1bit.png")
    Image.fromarray(np.eye(8, dtype=bool)).save(p)  # mode "1": 1-bit gray
    bad.append(p)
    p = str(tmp_path / "pil_4bit.png")
    Image.fromarray(_mixed_image(8, 8)).convert(
        "P", palette=Image.ADAPTIVE, colors=16).save(p, bits=4)
    bad.append(p)
    for p in bad:
        with pytest.raises(ValueError, match="bit depth") as e:
            read_png(p)
        assert p in str(e.value)


def test_corrupt_files_are_refused(tmp_path):
    p = str(tmp_path / "a.png")
    write_png(p, np.zeros((4, 4), np.uint8))
    data = bytearray(open(p, "rb").read())
    data[40] ^= 0xFF  # inside IDAT
    open(p, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_png(p)
    open(p, "wb").write(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(p)


def test_read_image_promotes_gray_and_drops_alpha(tmp_path):
    img = _mixed_image(16, 24)
    for mode, view in _PIL_MODES.items():
        p = str(tmp_path / f"{mode}.png")
        Image.fromarray(view(img), mode).save(p)
        got = read_image(p)
        want = img if mode in ("RGB", "RGBA") else np.repeat(
            img[..., :1], 3, -1)
        assert got.shape == (16, 24, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_kitti_codecs_equal_cv2(tmp_path):
    """read/write_flow_kitti and read_disp_kitti against the JAX
    package's cv2 versions, both ways."""
    from dexiraft_tpu.data import flow_io as jio
    rng = np.random.default_rng(5)
    flow = rng.normal(0, 20, (31, 45, 2)).astype(np.float32)
    valid = (rng.uniform(size=(31, 45)) < 0.4).astype(np.float32)
    write_flow_kitti(tmp_path / "port.png", flow, valid)
    jio.write_flow_kitti(str(tmp_path / "jax.png"), flow, valid)
    for name in ("port.png", "jax.png"):
        f1, v1 = read_flow_kitti(tmp_path / name)
        f2, v2 = jio.read_flow_kitti(str(tmp_path / name))
        np.testing.assert_array_equal(f1, f2)
        np.testing.assert_array_equal(v1, v2)
    disp = rng.integers(0, 2 ** 16, (31, 45), dtype=np.uint16)
    cv2.imwrite(str(tmp_path / "d.png"), disp)
    for a, b in zip(read_disp_kitti(tmp_path / "d.png"),
                    jio.read_disp_kitti(str(tmp_path / "d.png"))):
        np.testing.assert_array_equal(a, b)


def test_kitti_and_hd1k_samples_equal_jax(tmp_path, monkeypatch):
    from dexiraft_tpu.data import datasets as jds
    from dexiraft_tpu_torch.data import datasets as tds
    from dexiraft_tpu_torch.data.synthetic import write_hd1k_tree, \
        write_kitti_tree
    write_kitti_tree(str(tmp_path), "training", n=2, hw=(37, 61), empty=1)
    write_kitti_tree(str(tmp_path), "testing", n=2, hw=(37, 61), seed=1)
    write_hd1k_tree(str(tmp_path), sequences=2, n_frames=3, hw=(29, 47))
    monkeypatch.setenv("DEXIRAFT_DATA_DIR", str(tmp_path))
    pairs = [(tds.KITTI(split="training"), jds.KITTI(split="training")),
             (tds.KITTI(split="testing"), jds.KITTI(split="testing")),
             (tds.HD1K(), jds.HD1K())]
    for port, ref in pairs:
        assert len(port) == len(ref) and len(port) > 0
        for i in range(len(port)):
            a, b = port.sample(i), ref.sample(i)
            assert a.keys() == b.keys()
            for k in a:
                if k == "extra_info":
                    assert list(a[k]) == list(b[k])
                else:
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert not pairs[0][0].sample(1)["valid"].any()  # the empty frame


_NO_IMAGE_LIBS = r"""
import sys
for name in ("PIL", "cv2", "imageio"):
    sys.modules[name] = None  # any import of them raises ImportError
import os
import numpy as np
from dexiraft_tpu_torch.config import raft_v1
from dexiraft_tpu_torch.data.datasets import KITTI
from dexiraft_tpu_torch.data.flow_io import read_flow_kitti
from dexiraft_tpu_torch.data.synthetic import write_kitti_tree
from dexiraft_tpu_torch.eval import create_kitti_submission, validate_kitti
from dexiraft_tpu_torch.models.raft import create_model
from dexiraft_tpu_torch.train.step import make_eval_step
root = sys.argv[1]
write_kitti_tree(root, "training", n=2, hw=(37, 61), empty=1)
write_kitti_tree(root, "testing", n=1, hw=(37, 61), seed=1)
os.environ["DEXIRAFT_DATA_DIR"] = root
step = make_eval_step(create_model(raft_v1(small=True), seed=0,
                                   device="cpu"), iters=2, device="cpu")
res = validate_kitti(step)
assert np.isfinite(list(res.values())).all(), res
create_kitti_submission(step, os.path.join(root, "sub"),
                        KITTI(split="testing"))
flow, valid = read_flow_kitti(os.path.join(root, "sub", "000000_10.png"))
assert flow.shape == (37, 61, 2) and valid.all()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("PIL", "cv2", "imageio")
             and sys.modules[m] is not None)
print("loaded:", bad)
"""


def test_kitti_path_runs_without_image_libraries(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", _NO_IMAGE_LIBS,
                           str(tmp_path)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "loaded: []" in proc.stdout
    assert "Validation KITTI" in proc.stdout
    assert "1 empty-mask frames skipped" in proc.stdout

"""Flow-field and image file I/O.

Covers the reference's formats (core/utils/frame_utils.py):
  .flo        Middlebury: 'PIEH' float tag, int32 w/h, interleaved u,v rows
  .pfm        portable float map (FlyingThings3D flow), bottom-up scanlines
  KITTI .png  16-bit RGB: u,v encoded as uint16 (value*64 + 2^15), B=valid
plus an extension-dispatch reader.

A copy of ``dexiraft_tpu/data/flow_io.py``. ``.flo`` flows and binary
PPMs (the FlyingChairs format) go through the native decode bridge
(data/native.py, the shared C++ codecs) when it builds, and through the
numpy codecs below otherwise (no g++, DEXIRAFT_NO_NATIVE=1, or a file
the native codec declines); both decode bit-equal. PNG frames and
KITTI's 16-bit flow and disparity PNGs go through the port's own codec
(data/png.py) on every machine, in the layout cv2 gives the JAX
package; only other image formats (JPEG) need PIL.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple, Union

import numpy as np

from dexiraft_tpu_torch.data.png import read_png, write_png

FLO_MAGIC = 202021.25  # 'PIEH' interpreted as float32


def read_flo(path: Union[str, os.PathLike]) -> np.ndarray:
    """Middlebury .flo -> (H, W, 2) float32 (native decoder when built)."""
    from dexiraft_tpu_torch.data import native

    out = native.read_flo_native(path)
    if out is not None:
        return out
    with open(path, "rb") as f:
        magic = np.frombuffer(f.read(4), np.float32)[0]
        if magic != np.float32(FLO_MAGIC):
            raise ValueError(f"{path}: bad .flo magic {magic!r}")
        w, h = np.frombuffer(f.read(8), np.int32)
        data = np.frombuffer(f.read(int(w) * int(h) * 8), np.float32)
    return data.reshape(int(h), int(w), 2).copy()


def write_flo(path: Union[str, os.PathLike], flow: np.ndarray) -> None:
    """(H, W, 2) float32 -> Middlebury .flo."""
    flow = np.asarray(flow, np.float32)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.float32(FLO_MAGIC).tofile(f)
        np.int32(w).tofile(f)
        np.int32(h).tofile(f)
        flow.tofile(f)


def read_pfm(path: Union[str, os.PathLike]) -> np.ndarray:
    """PFM -> (H, W[, 3]) float32, top-down row order."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")
        dims = re.match(rb"^(\d+)\s+(\d+)\s*$", f.readline())
        if not dims:
            raise ValueError(f"{path}: malformed PFM dimensions")
        w, h = int(dims.group(1)), int(dims.group(2))
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if channels == 3 else (h, w)
    # PFM scanlines are stored bottom-to-top
    return np.flipud(data.reshape(shape)).astype(np.float32)


def write_pfm(path: Union[str, os.PathLike], data: np.ndarray) -> None:
    """(H, W[, 3]) float32 -> little-endian PFM."""
    data = np.asarray(data, np.float32)
    if data.ndim == 3 and data.shape[2] == 3:
        header = b"PF"
    elif data.ndim == 2:
        header = b"Pf"
    else:
        raise ValueError(f"PFM needs (H,W) or (H,W,3), got {data.shape}")
    h, w = data.shape[:2]
    with open(path, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")
        np.flipud(data).astype("<f4").tofile(f)


def read_flow_kitti(path: Union[str, os.PathLike]) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI 16-bit flow PNG -> ((H, W, 2) float32 flow, (H, W) float32 valid).

    Encoding (KITTI devkit, core/utils/frame_utils.py:102-107):
    uint16 channels R=u, G=v with value = flow*64 + 2^15; B = valid mask.
    (cv2 reads the file as B, G, R; the JAX package flips it back.)
    """
    raw = read_png(path)
    if raw.ndim != 3 or raw.shape[2] < 3:
        raise ValueError(f"{path}: a KITTI flow PNG has 3 channels, got "
                         f"shape {raw.shape}")
    raw = raw[:, :, :3].astype(np.float32)
    flow = (raw[:, :, :2] - 2**15) / 64.0
    valid = raw[:, :, 2]
    return flow, valid


def write_flow_kitti(path: Union[str, os.PathLike], flow: np.ndarray,
                     valid: Optional[np.ndarray] = None) -> None:
    """(H, W, 2) flow -> KITTI 16-bit PNG; ``valid`` (H, W) marks the
    measured pixels (KITTI GT is sparse), default all-valid."""
    flow = np.asarray(flow, np.float32)
    enc = 64.0 * flow + 2**15
    if valid is None:
        valid = np.ones(flow.shape[:2], np.float32)
    out = np.concatenate(
        [enc, np.asarray(valid, np.float32)[..., None]],
        axis=-1).astype(np.uint16)
    write_png(path, out)


def read_disp_kitti(path: Union[str, os.PathLike]) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI 16-bit disparity PNG -> ((H,W,2) flow [-disp, 0], valid)."""
    disp = read_png(path)
    if disp.ndim != 2:
        raise ValueError(f"{path}: a KITTI disparity PNG is single-channel, "
                         f"got shape {disp.shape}")
    disp = disp.astype(np.float32) / 256.0
    valid = (disp > 0.0).astype(np.float32)
    flow = np.stack([-disp, np.zeros_like(disp)], axis=-1)
    return flow, valid


def _ppm_token(f) -> bytes:
    """The next whitespace-separated header token of a PPM, comments
    skipped; consumes the one whitespace byte after it."""
    tok = b""
    while True:
        c = f.read(1)
        if not c:
            return tok
        if c == b"#" and not tok:
            f.readline()
        elif c.isspace():
            if tok:
                return tok
        else:
            tok += c


def read_ppm(path: Union[str, os.PathLike]) -> np.ndarray:
    """Binary 8-bit PPM (P6) -> (H, W, 3) uint8 (native decoder when
    built)."""
    from dexiraft_tpu_torch.data import native

    out = native.read_ppm_native(path)
    if out is not None:
        return out
    with open(path, "rb") as f:
        magic = _ppm_token(f)
        if magic != b"P6":
            raise ValueError(f"{path}: not a binary PPM (magic {magic!r})")
        w, h, maxval = (int(_ppm_token(f)) for _ in range(3))
        if maxval > 255:
            raise ValueError(f"{path}: 16-bit PPM is not supported")
        data = np.frombuffer(f.read(w * h * 3), np.uint8)
    if data.size != w * h * 3:
        raise ValueError(f"{path}: truncated PPM")
    return data.reshape(h, w, 3).copy()


def write_ppm(path: Union[str, os.PathLike], img: np.ndarray) -> None:
    """(H, W, 3) uint8 -> binary PPM (P6)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"image must be (H, W, 3), got {img.shape}")
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.tobytes())


def read_image(path: Union[str, os.PathLike]) -> np.ndarray:
    """8-bit image -> (H, W, 3) uint8 (grayscale promoted, alpha dropped).
    PPM and PNG are decoded by the port's own codecs; other formats
    through PIL."""
    name = os.fspath(path).lower()
    if name.endswith(".ppm"):
        return read_ppm(path)
    if name.endswith(".png"):
        img = read_png(path)
        if img.ndim == 3 and img.shape[2] == 2:  # gray + alpha
            img = img[..., 0]
    else:
        from PIL import Image

        with Image.open(os.fspath(path)) as im:
            img = np.asarray(im)
    if img.ndim == 2:
        img = np.tile(img[..., None], (1, 1, 3))
    return np.ascontiguousarray(img[..., :3]).astype(np.uint8)


def read_gen(path: Union[str, os.PathLike]) -> Optional[np.ndarray]:
    """Extension-dispatch reader (core/utils/frame_utils.py:123-137)."""
    ext = os.path.splitext(os.fspath(path))[-1].lower()
    if ext in (".png", ".jpeg", ".jpg", ".ppm"):
        return read_image(path)
    if ext in (".bin", ".raw"):
        return np.load(path)
    if ext == ".flo":
        return read_flo(path)
    if ext == ".pfm":
        flow = read_pfm(path)
        return flow[:, :, :-1] if flow.ndim == 3 else flow
    return None

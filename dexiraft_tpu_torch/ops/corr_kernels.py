"""The correlation kernels and their plain PyTorch versions.

Counterpart of ``dexiraft_tpu/ops/pallas_corr.py``. Two formulations of
the same two functions, each a hand-written CUDA kernel:

  * ``flash_fused_step`` (B1) / ``pallas_fused_step`` (B3): every pyramid
    level's (2r+1)^2 window lookup contracted with the motion encoder's
    1x1 corr conv, plus bias, in one kernel launch per refinement
    iteration;
  * ``flash_local_corr_level`` (B2) / ``pallas_local_corr_level`` (B4):
    one level's window lookup alone;
  * ``fused_reference``: the plain version of B1 and B3 (per-level
    local_corr_level windows, then the 1x1 conv as a contraction);
    ``local_corr_level`` is the plain version of B2 and B4.

The flash kernels live in ``csrc/flash_corr.cu``, two instances of one
kernel: a 4x8 tile of query pixels per block stages the f2 patch its
lattices share once per level through cp.async (or reads each pixel's rows
from global memory when the patch is too large); B1 contracts the windows
with W, B2 writes them. B3/B4 live in ``csrc/pallas_corr.cu``: a 4x8 tile of
query pixels per block whose shared f2 box is staged channel chunk by chunk
by TMA from tensor maps encoded per call (a box too large for shared
memory is read pixel by pixel from global memory). A tensor map the driver
refuses raises like a failed launch.
On CUDA tensors the wrappers launch their kernel; a failure to build or
launch raises. On CPU tensors (the caller chose ``device="cpu"``) they run
the plain version. There is no other case and no fallback between the two.

Division of labor for the linear factors, as in the JAX package: the
kernel applies 1/sqrt(C) itself; per-level int8 scales are the caller's
(folded into the weight rows for B1/B3, multiplied onto the window for
B2/B4).

Gradients: forward-only kernels in ``torch.autograd.Function``s whose
backward recomputes through the plain version (the custom-VJP contract of
the JAX package): coords get a zero gradient, int8 levels none.

Each kernel wrapper counts its launches in ``LAUNCHES`` (the count moves
only where a kernel is launched), so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Sequence

import torch

from dexiraft_tpu_torch.ops.local_corr import local_corr_level

# kernel library -> (sources under csrc/, C entry point); one nvcc call each
KERNEL_LIBRARIES = {
    "flash_corr": (("flash_corr.cu", "flash_corr.cpp"), "dexiraft_flash_corr"),
    "pallas_corr": (("pallas_corr.cu", "pallas_corr.cpp"),
                    "dexiraft_pallas_corr"),
}
# kernel wrapper -> the library holding its kernel
KERNEL_LIBRARY_OF = {
    "flash_fused_step": "flash_corr",
    "flash_local_corr_level": "flash_corr",
    "pallas_fused_step": "pallas_corr",
    "pallas_local_corr_level": "pallas_corr",
}
LAUNCHES = {name: 0 for name in KERNEL_LIBRARY_OF}
# the service launches from several threads (the scheduler's dispatcher,
# the streaming handlers): each count moves under this lock
_LAUNCHES_LOCK = threading.Lock()
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_LEVELS = 8


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def fused_reference(fmap1, fmap2_levels, coords, weight, bias, radius,
                    row_chunk=None):
    """Plain version of B1/B3: (B,H,W,C) x L levels x level-0 coords
    (B,H,W,2) x weight (L*(2r+1)^2, F) x bias (F,) -> (B,H,W,F) float32.
    Levels may be stored bf16/int8 and are upcast; int8 scales must
    already be folded into ``weight``."""
    outs = [local_corr_level(fmap1, f2.to(torch.float32),
                             coords / (2.0 ** lvl), radius, row_chunk)
            for lvl, f2 in enumerate(fmap2_levels)]
    corr = torch.cat(outs, dim=-1)
    return (torch.einsum("bhwc,cf->bhwf", corr, weight.to(torch.float32))
            + bias.to(torch.float32))


def _use_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("correlation kernel inputs span several CUDA "
                             f"devices: {sorted({str(t.device) for t in tensors})}")
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError("correlation kernel inputs must all be on one CUDA "
                     f"device or all on the CPU, got {sorted(kinds)}")


def _argtypes():
    """The argument types of either library's C entry point (both take the
    query grid H, W)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return [p, p, p, p, p, ctypes.POINTER(p), ctypes.POINTER(i),
            ctypes.POINTER(i), ctypes.POINTER(ctypes.c_float),
            i, i, i, i, i, i, i, i, i, p]


def _entry_point(library: str):
    """The library's C entry point (built and loaded at first use) and the
    library itself."""
    from dexiraft_tpu_torch.ops.cuda_build import load_library

    sources, entry = KERNEL_LIBRARIES[library]
    lib = load_library(library, sources)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        # without argtypes ctypes would pass each pointer as a 32-bit int
        fn.argtypes = _argtypes()
        fn.restype = ctypes.c_int
        lib.dexiraft_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dexiraft_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib


def _launch_error(rc: int, lib) -> str:
    """What a nonzero return code of an entry point means: -1 a refused
    argument, -2 no tensor-map encoder in the driver, -1000 - CUresult a
    tensor map the driver refused (pallas library), > 0 a cudaError_t."""
    if rc == -1:
        return "bad argument"
    if rc == -2:
        return "the driver has no cuTensorMapEncodeTiled"
    if rc <= -1000:
        return f"cuTensorMapEncodeTiled failed with CUresult {-1000 - rc}"
    return lib.dexiraft_cuda_error_string(rc).decode()


def _box_limit(library: str, dtype: torch.dtype, fused: bool, radius: int,
               c: int, feat: int) -> int:
    _, lib = _entry_point(library)
    fn = getattr(lib, f"dexiraft_{library.split('_')[0]}_box_limit")
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    limit = fn(_DTYPE_CODES[dtype], int(fused), radius, c, feat)
    if limit <= 0:
        raise ValueError(f"no box limit for {dtype} C={c} r={radius} F={feat}")
    return limit


def pallas_box_limit(dtype: torch.dtype, fused: bool, radius: int, c: int,
                     feat: int = 0) -> int:
    """The most f2 box positions one B3 (``fused``) or B4 tile stages at
    once for levels stored in ``dtype``; a larger box takes the per-pixel
    branch (ops/tiles.py). Builds and loads the pallas library."""
    return _box_limit("pallas_corr", dtype, fused, radius, c, feat)


def flash_box_limit(dtype: torch.dtype, fused: bool, radius: int, c: int,
                    feat: int = 0) -> int:
    """The most f2 box positions (columns rounded up to odd, times rows) one
    B1 (``fused``) or B2 tile stages at once for levels stored in ``dtype``;
    a larger box takes the per-pixel branch (ops/tiles.py). Builds and loads
    the flash library."""
    return _box_limit("flash_corr", dtype, fused, radius, c, feat)


def build_kernels() -> Dict[str, str]:
    """Build every kernel library now, one nvcc process each, started
    together (they are otherwise built at first launch); returns library
    name -> path of the shared library."""
    from dexiraft_tpu_torch.ops.cuda_build import build_libraries

    return build_libraries({name: srcs for name, (srcs, _) in
                            KERNEL_LIBRARIES.items()})


def _launch(name: str, fmap1: torch.Tensor, levels: Sequence[torch.Tensor],
            coords: torch.Tensor, coord_scales: Sequence[float], radius: int,
            weight: Optional[torch.Tensor] = None,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel of wrapper ``name``; returns (B, H, W, out_ch) as
    a view of a channels-first (B, out_ch, H, W) buffer (the model's
    layout). Each check formats its message only when it fails: this runs
    on the host once per kernel launch."""
    fused = weight is not None
    if not (fmap1.dim() == 4 and fmap1.dtype == torch.float32):
        raise ValueError(f"fmap1 must be (B, H, W, C) float32, got "
                         f"{tuple(fmap1.shape)} {fmap1.dtype}")
    b, h, w, c = fmap1.shape
    if c % 16:
        raise ValueError(f"{name} needs C % 16 == 0, got C={c}")
    if not 1 <= len(levels) <= _MAX_LEVELS:
        raise ValueError(f"1..{_MAX_LEVELS} pyramid levels, got {len(levels)}")
    if coords.shape != (b, h, w, 2):
        raise ValueError(f"coords must be {(b, h, w, 2)}, got "
                         f"{tuple(coords.shape)}")
    dtype = levels[0].dtype
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"level dtype must be float32, bfloat16 or int8, "
                         f"got {dtype}")
    for lv in levels:
        if not (lv.dtype == dtype and lv.dim() == 4 and lv.shape[0] == b
                and lv.shape[3] == c):
            raise ValueError(f"level {tuple(lv.shape)} {lv.dtype} does not "
                             f"match fmap1 {tuple(fmap1.shape)} / {dtype}")
        if not lv.is_contiguous():
            raise ValueError("pyramid levels must be contiguous")
        if lv.numel() and lv.data_ptr() % 16:
            raise ValueError("pyramid levels must be 16-byte aligned")
    kk = (2 * radius + 1) ** 2
    f1 = fmap1.contiguous()
    if f1.data_ptr() % 16:  # the kernels read f1 in 16-byte units
        f1 = f1.clone()
    co = coords.to(torch.float32).contiguous()
    if fused:
        if not (weight.dtype == torch.float32 and bias.dtype == torch.float32):
            raise ValueError("weight and bias must be float32")
        if not (weight.dim() == 2 and weight.shape[0] == len(levels) * kk):
            raise ValueError(f"weight must be ({len(levels) * kk}, F), got "
                             f"{tuple(weight.shape)}")
        feat = weight.shape[1]
        if bias.shape != (feat,):
            raise ValueError(f"bias must be ({feat},)")
        weight, bias = weight.contiguous(), bias.contiguous()
        out_ch = feat
    else:
        feat = 0
        out_ch = len(levels) * kk
    out = torch.empty((b, out_ch, h, w), dtype=torch.float32,
                      device=fmap1.device)
    n_lvl = len(levels)
    ptrs = (ctypes.c_void_p * n_lvl)(*[lv.data_ptr() or None for lv in levels])
    h2 = (ctypes.c_int * n_lvl)(*[lv.shape[1] for lv in levels])
    w2 = (ctypes.c_int * n_lvl)(*[lv.shape[2] for lv in levels])
    sc = (ctypes.c_float * n_lvl)(*coord_scales)
    library = KERNEL_LIBRARY_OF[name]
    fn, lib = _entry_point(library)
    with torch.cuda.device(fmap1.device):
        stream = torch.cuda.current_stream(fmap1.device).cuda_stream
        rc = fn(f1.data_ptr(), co.data_ptr(),
                weight.data_ptr() if fused else None,
                bias.data_ptr() if fused else None,
                out.data_ptr(), ptrs, h2, w2, sc,
                n_lvl, b, h, w, c, radius, feat, _DTYPE_CODES[dtype],
                int(fused), stream)
    if rc != 0:
        raise RuntimeError(f"{name}: {library} kernel launch failed "
                           f"({rc}: {_launch_error(rc, lib)})")
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1
    return out.permute(0, 2, 3, 1)


def _level_grads(levels, grads):
    """Map the recompute's gradients back onto the level list: None for
    the int8 levels, which took no part in differentiation."""
    it = iter(grads)
    return [next(it) if lv.is_floating_point() else None for lv in levels]


class _FusedStep(torch.autograd.Function):
    """B1 or B3 (``name``) forward; backward through fused_reference."""

    @staticmethod
    def forward(ctx, name, fmap1, coords, weight, bias, radius, row_chunk,
                *levels):
        ctx.radius, ctx.row_chunk = radius, row_chunk
        ctx.save_for_backward(fmap1, coords, weight, bias, *levels)
        if _use_kernel(fmap1, coords, weight, bias, *levels):
            return _launch(name, fmap1, levels, coords,
                           [2.0 ** -lvl for lvl in range(len(levels))],
                           radius, weight, bias)
        return fused_reference(fmap1, levels, coords, weight, bias, radius,
                               row_chunk)

    @staticmethod
    def backward(ctx, g):
        fmap1, coords, weight, bias, *levels = ctx.saved_tensors
        with torch.enable_grad():
            f1 = fmap1.detach().requires_grad_()
            w = weight.detach().requires_grad_()
            bb = bias.detach().requires_grad_()
            lv = [x.detach().requires_grad_() if x.is_floating_point()
                  else x.detach() for x in levels]
            out = fused_reference(f1, lv, coords.detach(), w, bb,
                                  ctx.radius, ctx.row_chunk)
            grads = torch.autograd.grad(
                out, [f1, w, bb] + [x for x in lv if x.requires_grad], g)
        return (None, grads[0], torch.zeros_like(coords), grads[1], grads[2],
                None, None, *_level_grads(levels, grads[3:]))


class _LevelLookup(torch.autograd.Function):
    """B2 or B4 (``name``) forward; backward through local_corr_level."""

    @staticmethod
    def forward(ctx, name, fmap1, fmap2, coords, radius, row_chunk):
        ctx.radius, ctx.row_chunk = radius, row_chunk
        ctx.save_for_backward(fmap1, fmap2, coords)
        if _use_kernel(fmap1, fmap2, coords):
            return _launch(name, fmap1, [fmap2], coords, [1.0], radius)
        return local_corr_level(fmap1, fmap2, coords, radius, row_chunk)

    @staticmethod
    def backward(ctx, g):
        fmap1, fmap2, coords = ctx.saved_tensors
        with torch.enable_grad():
            f1 = fmap1.detach().requires_grad_()
            f2 = fmap2.detach()
            if f2.is_floating_point():
                f2.requires_grad_()
            out = local_corr_level(f1, f2, coords.detach(), ctx.radius,
                                   ctx.row_chunk)
            grads = torch.autograd.grad(
                out, [f1] + ([f2] if f2.requires_grad else []), g)
        return (None, grads[0], grads[1] if len(grads) > 1 else None,
                torch.zeros_like(coords), None, None)


def flash_fused_step(fmap1: torch.Tensor, fmap2_levels: Sequence[torch.Tensor],
                     coords: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, radius: int,
                     row_chunk: Optional[int] = 8) -> torch.Tensor:
    """B1: (B,H,W,C) x L levels (B,H>>l,W>>l,C) x level-0 coords (B,H,W,2)
    x weight (L*(2r+1)^2, F) x bias (F,) -> (B,H,W,F) float32.
    ``row_chunk`` bounds the plain version's transient block."""
    return _FusedStep.apply("flash_fused_step", fmap1, coords, weight, bias,
                            radius, row_chunk, *fmap2_levels)


def pallas_fused_step(fmap1: torch.Tensor, fmap2_levels: Sequence[torch.Tensor],
                      coords: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, radius: int,
                      row_chunk: Optional[int] = 8) -> torch.Tensor:
    """B3: the function of B1, computed by the per-pixel kernel."""
    return _FusedStep.apply("pallas_fused_step", fmap1, coords, weight, bias,
                            radius, row_chunk, *fmap2_levels)


def flash_local_corr_level(fmap1: torch.Tensor, fmap2: torch.Tensor,
                           coords: torch.Tensor, radius: int,
                           row_chunk: Optional[int] = 8) -> torch.Tensor:
    """B2: one level's window lookup, coords in LEVEL pixels
    -> (B,H,W,(2r+1)^2) float32; a degenerate level gives zeros."""
    return _LevelLookup.apply("flash_local_corr_level", fmap1, fmap2, coords,
                              radius, row_chunk)


def pallas_local_corr_level(fmap1: torch.Tensor, fmap2: torch.Tensor,
                            coords: torch.Tensor, radius: int,
                            row_chunk: Optional[int] = 8) -> torch.Tensor:
    """B4: the function of B2, computed by the per-pixel kernel."""
    return _LevelLookup.apply("pallas_local_corr_level", fmap1, fmap2,
                              coords, radius, row_chunk)


# the fused step and the lookup of each LocalCorr kernel name
FUSED_STEPS = {"flash": flash_fused_step, "pallas": pallas_fused_step}
LEVEL_LOOKUPS = {"flash": flash_local_corr_level,
                 "pallas": pallas_local_corr_level}

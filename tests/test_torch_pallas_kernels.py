"""The per-pixel correlation kernels' wrappers (B3, B4) against the JAX package.

On the CPU the port's ``pallas_fused_step`` and ``pallas_local_corr_level``
run their plain PyTorch versions (``fused_reference``, ``local_corr_level``);
here they are held against the JAX package's Pallas ``pallas_fused_step`` /
``pallas_local_corr_level`` in interpret mode (both B4 variants, "loop" and
"batched", and B3 with its per-level VMEM split forced) and against its
``fused_reference``, at r=2 and r=4, with fp32/bf16/int8 levels, far
out-of-frame coords and a degenerate level. Gradients are held against the
JAX custom VJPs (zero coords gradient, none to int8 levels).
Both wrappers are also held against the JAX kernels on the coordinate
fields the card's kernels branch on: a smooth shift (one staged box per
tile), coords scattered over the frame (the per-pixel branch), and integer
centers on the clip limits and edges of each level's frame (where the
kernels' zero fill outside the frame must agree). ``ops/tiles.py``, the
box each kernel tile stages, is held against a box taken pixel by pixel.
Tolerance: max abs error <= 1e-3, the bound the JAX package holds its own
kernels to (tests/test_zzzfused_corr.py).

The CUDA kernel itself runs only on the card: ``test_kernels_match_plain_on_gpu``
carries the ``gpu`` marker and skips without one.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexiraft_tpu.ops import pallas_corr as jpc
from dexiraft_tpu_torch.ops import corr_kernels as ck
from dexiraft_tpu_torch.ops import tiles
from dexiraft_tpu_torch.ops.local_corr import build_local_corr as t_build
from test_torch_corr_kernels import (FIELDS, REPO, _coords, _fold, _maxerr,
                                     _pyramids, _setup)
from test_torch_train_ops import few_torch_threads  # noqa: F401

TOL = 1e-3


@pytest.fixture(autouse=True)
def _two_threads(few_torch_threads):  # noqa: F811
    """2 torch threads: the suite runs 6 workers at once on 8 cores."""
    yield


@pytest.fixture(autouse=True)
def _interpret_small_blocks(monkeypatch):
    """Interpret-mode Pallas pays per padded pixel: a 16-pixel block for
    the 48-pixel fixtures (the knob never changes values)."""
    monkeypatch.setenv("DEXIRAFT_PALLAS_PIXEL_BLOCK", "16")


def _jax_fused(jp, co, w, bias, radius):
    return jpc.pallas_fused_step(jp.fmap1, jp.fmap2_pyramid, jnp.asarray(co),
                                 jnp.asarray(w), jnp.asarray(bias), radius,
                                 True)


class TestPallasFusedStep:
    @pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
    @pytest.mark.parametrize("radius", [2, 4])
    def test_matches_jax_kernel_and_reference(self, radius, dtype):
        f1, f2, co, weight, bias = _setup(100 + radius, radius=radius)
        tp, jp = _pyramids(f1, f2, 3, radius, dtype)
        w = _fold(weight, None if jp.scales is None
                  else [np.asarray(s) for s in jp.scales], 2 * radius + 1)
        out = ck.pallas_fused_step(tp.fmap1, tp.fmap2_pyramid,
                                   torch.from_numpy(co), torch.from_numpy(w),
                                   torch.from_numpy(bias), radius)
        j_kernel = _jax_fused(jp, co, w, bias, radius)
        j_ref = jpc.fused_reference(jp.fmap1, jp.fmap2_pyramid,
                                    jnp.asarray(co), jnp.asarray(w),
                                    jnp.asarray(bias), radius)
        assert tuple(out.shape) == (1, 6, 8, 16)
        assert _maxerr(out, j_kernel) <= TOL
        assert _maxerr(out, j_ref) <= TOL
        # the far row reads only the bias
        np.testing.assert_allclose(out[0, 0].numpy(),
                                   np.broadcast_to(bias, (8, 16)), atol=1e-6)

    def test_matches_jax_level_split(self, monkeypatch):
        """JAX's B3 splits into one call per level over its VMEM budget; a
        1-byte budget forces the split, and the port (no split) matches it
        up to summation order."""
        radius = 2
        monkeypatch.setattr(jpc, "_FUSED_LEVELS_VMEM_BYTES", 1)
        f1, f2, co, weight, bias = _setup(110, radius=radius)
        tp, jp = _pyramids(f1, f2, 3, radius, "fp32")
        out = ck.pallas_fused_step(tp.fmap1, tp.fmap2_pyramid,
                                   torch.from_numpy(co),
                                   torch.from_numpy(weight),
                                   torch.from_numpy(bias), radius)
        assert _maxerr(out, _jax_fused(jp, co, weight, bias, radius)) <= TOL

    def test_degenerate_level(self):
        """6x8 at level 0 pools to a 0-row 4th level: it contributes
        nothing, in the port as in the JAX kernel."""
        radius = 2
        f1, f2, co, weight, bias = _setup(111, levels=4, radius=radius)
        tp, jp = _pyramids(f1, f2, 4, radius, "fp32")
        assert tp.fmap2_pyramid[3].shape[1] == 0
        out = ck.pallas_fused_step(tp.fmap1, tp.fmap2_pyramid,
                                   torch.from_numpy(co),
                                   torch.from_numpy(weight),
                                   torch.from_numpy(bias), radius)
        assert _maxerr(out, _jax_fused(jp, co, weight, bias, radius)) <= TOL

    @pytest.mark.parametrize("dtype", ["fp32", "int8"])
    def test_gradients_match_jax_vjp(self, dtype):
        """Backward recomputes through the plain version: fmap1, float
        levels, weight and bias get the gradients of JAX's custom VJP
        (``_fused_bwd``), coords a zero gradient, int8 levels none."""
        radius = 2
        f1, f2, co, weight, bias = _setup(112, h=4, w=6, c=16, radius=radius,
                                          far=False)
        tp, jp = _pyramids(f1, f2, 3, radius, dtype)
        t_f1 = tp.fmap1.clone().requires_grad_()
        t_lv = [x.clone().requires_grad_() if x.is_floating_point() else x
                for x in tp.fmap2_pyramid]
        t_co = torch.from_numpy(co).requires_grad_()
        t_w = torch.from_numpy(weight).requires_grad_()
        t_b = torch.from_numpy(bias).requires_grad_()
        (ck.pallas_fused_step(t_f1, t_lv, t_co, t_w, t_b, radius) ** 2
         ).sum().backward()

        float_lv = dtype != "int8"

        def loss(f1_, co_, w_, b_, *lv):
            lv = lv if float_lv else jp.fmap2_pyramid
            return jnp.sum(jpc.pallas_fused_step(
                f1_, tuple(lv), co_, w_, b_, radius, True) ** 2)

        argnums = (0, 1, 2, 3) + ((4, 5, 6) if float_lv else ())
        g = jax.grad(loss, argnums=argnums)(
            jp.fmap1, jnp.asarray(co), jnp.asarray(weight), jnp.asarray(bias),
            *jp.fmap2_pyramid)
        for t, j in zip([t_f1.grad, t_w.grad, t_b.grad], (g[0], g[2], g[3])):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-3,
                                       atol=1e-3)
        np.testing.assert_array_equal(np.asarray(g[1]), 0.0)
        assert not t_co.grad.any()
        if float_lv:
            for t, j in zip(t_lv, g[4:]):
                np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                           rtol=1e-3, atol=1e-3)
        else:
            assert all(not x.requires_grad for x in t_lv)


class TestPallasLookupLevel:
    @pytest.mark.parametrize("variant", ["loop", "batched"])
    @pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
    @pytest.mark.parametrize("radius", [2, 4])
    def test_matches_jax_kernel(self, radius, dtype, variant, monkeypatch):
        """Both JAX B4 variants (two TPU tunings of one function) against
        the port's one lookup, level by level, after the int8 scale the
        lookup path applies."""
        monkeypatch.setenv("DEXIRAFT_PALLAS_VARIANT", variant)
        f1, f2, co, _, _ = _setup(120 + radius, radius=radius)
        tp, jp = _pyramids(f1, f2, 2, radius, dtype)
        for lvl in range(2):
            scale = 1.0 if jp.scales is None else float(jp.scales[lvl])
            tco = torch.from_numpy(co) / 2.0 ** lvl
            out = ck.pallas_local_corr_level(tp.fmap1, tp.fmap2_pyramid[lvl],
                                             tco, radius) * scale
            ref = jpc.pallas_local_corr_level(
                jp.fmap1, jp.fmap2_pyramid[lvl], jnp.asarray(co) / 2.0 ** lvl,
                radius, True) * scale
            assert tuple(out.shape) == (1, 6, 8, (2 * radius + 1) ** 2)
            assert _maxerr(out, ref) <= TOL
            assert float(out[0, 0].abs().max()) == 0.0  # far row

    def test_degenerate_level_is_zero(self):
        radius = 2
        f1, f2, co, _, _ = _setup(130, radius=radius)
        tp, jp = _pyramids(f1, f2, 4, radius, "fp32")
        out = ck.pallas_local_corr_level(tp.fmap1, tp.fmap2_pyramid[3],
                                         torch.from_numpy(co) / 8.0, radius)
        ref = jpc.pallas_local_corr_level(jp.fmap1, jp.fmap2_pyramid[3],
                                          jnp.asarray(co) / 8.0, radius, True)
        assert tuple(out.shape) == (1, 6, 8, 25)
        assert not out.any()
        np.testing.assert_array_equal(np.asarray(ref), 0.0)

    def test_gradients_match_jax_vjp(self):
        radius = 2
        f1, f2, co, _, _ = _setup(131, h=4, w=6, c=16, radius=radius,
                                  far=False)
        a = torch.from_numpy(f1).requires_grad_()
        b = torch.from_numpy(f2).requires_grad_()
        c = torch.from_numpy(co).requires_grad_()
        ck.pallas_local_corr_level(a, b, c, radius).square().sum().backward()
        g = jax.grad(lambda x, y, z: jnp.sum(jpc.pallas_local_corr_level(
            x, y, z, radius, True) ** 2), argnums=(0, 1, 2))(
                jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(co))
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g[0]), atol=1e-3)
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(g[1]), atol=1e-3)
        np.testing.assert_array_equal(np.asarray(g[2]), 0.0)
        assert not c.grad.any()


def test_lookup_path_dispatches_pallas():
    """A "pallas" pyramid's lookup and fused step are the B4/B3 wrappers
    (their plain versions here), and match the plain pyramid."""
    radius = 2
    f1, f2, co, weight, bias = _setup(140, radius=radius)
    plain = t_build(torch.from_numpy(f1), torch.from_numpy(f2), 3, radius)
    pallas = t_build(torch.from_numpy(f1), torch.from_numpy(f2), 3, radius,
                     kernel="pallas")
    tco = torch.from_numpy(co)
    torch.testing.assert_close(pallas(tco), plain(tco), rtol=0, atol=0)
    assert ck.FUSED_STEPS[pallas.kernel] is ck.pallas_fused_step
    ck.reset_launches()
    ck.FUSED_STEPS[pallas.kernel](pallas.fmap1, pallas.fmap2_pyramid, tco,
                                  torch.from_numpy(weight),
                                  torch.from_numpy(bias), radius)
    assert not any(ck.LAUNCHES.values())  # the CPU runs no kernel


@pytest.mark.gpu
def test_kernels_match_plain_on_gpu():
    """On the card: B3/B4 against their plain versions and against B1/B2
    (every storage dtype, a degenerate level, the jitter, smooth,
    scattered and edge fields: the TMA patch branch, its zero fill
    outside the frame and the per-pixel branch), max abs error <= 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    for dtype in ("fp32", "bf16", "int8"):
        f1, f2, co, weight, bias = _setup(150, b=2, h=12, w=16, levels=4,
                                          radius=4)
        pyr = t_build(torch.from_numpy(f1).to(dev),
                      torch.from_numpy(f2).to(dev), 4, 4, dtype=dtype)
        w = torch.from_numpy(weight).to(dev)
        b = torch.from_numpy(bias).to(dev)
        for field in ("jitter",) + FIELDS:
            co_d = torch.from_numpy(_coords(co, field, 151, 4, 4)).to(dev)
            out = ck.pallas_fused_step(pyr.fmap1, pyr.fmap2_pyramid, co_d, w,
                                       b, 4)
            ref = ck.fused_reference(pyr.fmap1, pyr.fmap2_pyramid, co_d, w,
                                     b, 4)
            b1 = ck.flash_fused_step(pyr.fmap1, pyr.fmap2_pyramid, co_d, w,
                                     b, 4)
            assert float((out - ref).abs().max()) <= TOL
            assert float((out - b1).abs().max()) <= TOL
            for lvl, f2l in enumerate(pyr.fmap2_pyramid):
                c_l = co_d / 2.0 ** lvl
                out = ck.pallas_local_corr_level(pyr.fmap1, f2l, c_l, 4)
                ref = ck.local_corr_level(pyr.fmap1, f2l.float(), c_l, 4)
                b2 = ck.flash_local_corr_level(pyr.fmap1, f2l, c_l, 4)
                assert float((out - ref).abs().max()) <= TOL
                assert float((out - b2).abs().max()) <= TOL

class TestCoordFields:
    """B3/B4's wrappers (their plain versions here) against the JAX kernels
    in interpret mode on the fields the card's kernels branch on."""

    @pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
    @pytest.mark.parametrize("field", FIELDS)
    def test_fused_matches_jax_kernel(self, field, dtype):
        radius, levels = 2, 3
        f1, f2, co, weight, bias = _setup(160, radius=radius)
        co = _coords(co, field, 161, radius, levels)
        tp, jp = _pyramids(f1, f2, levels, radius, dtype)
        w = _fold(weight, None if jp.scales is None
                  else [np.asarray(s) for s in jp.scales], 2 * radius + 1)
        out = ck.pallas_fused_step(tp.fmap1, tp.fmap2_pyramid,
                                   torch.from_numpy(co), torch.from_numpy(w),
                                   torch.from_numpy(bias), radius)
        j_ref = jpc.fused_reference(jp.fmap1, jp.fmap2_pyramid,
                                    jnp.asarray(co), jnp.asarray(w),
                                    jnp.asarray(bias), radius)
        assert _maxerr(out, _jax_fused(jp, co, w, bias, radius)) <= TOL
        assert _maxerr(out, j_ref) <= TOL

    @pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
    @pytest.mark.parametrize("field", FIELDS)
    def test_lookup_matches_jax_kernel(self, field, dtype):
        radius, levels = 2, 2
        f1, f2, co, _, _ = _setup(170, radius=radius)
        co = _coords(co, field, 171, radius, levels)
        tp, jp = _pyramids(f1, f2, levels, radius, dtype)
        for lvl in range(levels):
            scale = 1.0 if jp.scales is None else float(jp.scales[lvl])
            out = ck.pallas_local_corr_level(
                tp.fmap1, tp.fmap2_pyramid[lvl],
                torch.from_numpy(co) / 2.0 ** lvl, radius) * scale
            ref = jpc.pallas_local_corr_level(
                jp.fmap1, jp.fmap2_pyramid[lvl], jnp.asarray(co) / 2.0 ** lvl,
                radius, True) * scale
            assert _maxerr(out, ref) <= TOL

    def test_edge_field_hits_the_clip_limits(self):
        """The edge field puts centers exactly on -r-1 and size+r, where
        the window is all zero, and on integers."""
        radius = 2
        _, _, co, _, _ = _setup(172, b=2, h=8, w=16, radius=radius)
        co = _coords(co, "edge", 173, radius, 1)
        xs = co[..., 0]
        assert (xs == -(radius + 1)).any() and (xs == 16 + radius).any()
        assert ((xs >= 0) & (xs < 16)).mean() >= 0.4
        np.testing.assert_array_equal(co, np.round(co))


def _brute_boxes(co, shape, scale, radius, tile, whole):
    """tile_boxes taken pixel by pixel: each pixel's clipped, floored
    center, its effective lattice and liveness, and per tile the min/max
    over the live pixels."""
    h2, w2 = shape
    k1 = 2 * radius + 2
    b, h, w, _ = co.shape
    th, tw = tile
    cols, rows = [], []
    for bi in range(b):
        for ty in range(0, h, th):
            for tx in range(0, w, tw):
                lo = [np.inf, np.inf]
                hi = [-np.inf, -np.inf]
                for y in range(ty, min(ty + th, h)):
                    for x in range(tx, min(tx + tw, w)):
                        ext = []
                        for a, size in ((0, w2), (1, h2)):
                            t = float(co[bi, y, x, a]) * scale
                            if np.isnan(t):
                                t = -(radius + 1.0)
                            t = min(max(t, -(radius + 1.0)), size + radius)
                            g0 = np.floor(t) - radius
                            end = g0 + k1 - (1 if t == np.floor(t) else 0)
                            live = end > 0 and g0 < size and size > 0
                            if whole:
                                ext.append((g0, g0 + k1, live))
                            else:
                                ext.append((max(g0, 0), min(end, size), live))
                        if ext[0][2] and ext[1][2]:
                            for a in (0, 1):
                                lo[a] = min(lo[a], ext[a][0])
                                hi[a] = max(hi[a], ext[a][1])
                if lo[0] < np.inf:
                    cols.append(hi[0] - lo[0])
                    rows.append(hi[1] - lo[1])
    return np.asarray(cols, np.int64), np.asarray(rows, np.int64)


class TestTileBoxes:
    @pytest.mark.parametrize("whole", [False, True])
    @pytest.mark.parametrize("tile", [(4, 8), (2, 4), (3, 5)])
    @pytest.mark.parametrize("field", ["jitter", "edge", "scattered"])
    def test_matches_pixel_by_pixel_box(self, field, tile, whole):
        """Per level (one degenerate), over ragged tiles, with far and NaN
        pixels and tiles with no live pixel."""
        radius = 2
        _, _, co, _, _ = _setup(180, b=2, h=10, w=13, radius=radius)
        co = _coords(co, field, 181, radius, 4)
        co[:, 1, :3] = np.nan
        for lvl, shape in enumerate([(10, 13), (5, 6), (2, 3), (0, 1)]):
            got = tiles.tile_boxes(torch.from_numpy(co), shape, 2.0 ** -lvl,
                                   radius, tile=tile, whole=whole)
            want = _brute_boxes(co, shape, 2.0 ** -lvl, radius, tile, whole)
            np.testing.assert_array_equal(got[0].numpy(), want[0])
            np.testing.assert_array_equal(got[1].numpy(), want[1])

    def test_tma_staging(self):
        """The narrowest TMA box width that spans the columns, the rows
        rounded up to the box height; too wide or too many positions go
        per pixel."""
        cols = torch.tensor([10, 16, 17, 24, 25, 32, 33, 30])
        rows = torch.tensor([10, 11, 13, 14, 2, 27, 5, 30])
        staged, per_pixel = tiles.tma_staging(cols, rows, limit=900)
        assert staged.tolist() == [160, 192, 336, 336, 64, 896, 0, 960]
        assert per_pixel.tolist() == [False] * 6 + [True, True]

    def test_flash_staging(self):
        """B1/B2 stage their box with the columns rounded up to an odd row
        stride; more positions than the limit go per pixel."""
        cols = torch.tensor([10, 13, 24, 1, 31])
        rows = torch.tensor([14, 17, 28, 3, 31])
        staged, per_pixel = tiles.flash_staging(cols, rows, limit=928)
        assert staged.tolist() == [154, 221, 700, 3, 961]
        assert per_pixel.tolist() == [False] * 4 + [True]


class TestEntryPoints:
    @pytest.mark.parametrize("library", sorted(ck.KERNEL_LIBRARIES))
    def test_argtypes_match_the_c_signature(self, library):
        """Each library's ctypes argument list has one entry per parameter
        of its C entry point (both take the query grid H, W), and the
        library exports the box limit its wrapper reads."""
        srcs, entry = ck.KERNEL_LIBRARIES[library]
        text = "".join(open(os.path.join(REPO, "dexiraft_tpu_torch", "csrc",
                                         s)).read() for s in srcs)
        params = re.search(rf"int {entry}\(([^)]*)\)", text).group(1)
        assert len(ck._argtypes()) == len(params.split(","))
        assert "int hq, int wq" in params
        limit = re.search(rf"int dexiraft_{library.split('_')[0]}_box_limit"
                          r"\(([^)]*)\)", text).group(1)
        assert len(limit.split(",")) == 5

    def test_launch_errors_are_named(self):
        """A refused tensor map names its CUresult; nothing is retried."""

        class Lib:
            @staticmethod
            def dexiraft_cuda_error_string(rc):
                return b"cuda error %d" % rc

        assert ck._launch_error(-1, Lib) == "bad argument"
        assert "cuTensorMapEncodeTiled" in ck._launch_error(-2, Lib)
        assert ck._launch_error(-1001, Lib).endswith("CUresult 1")
        assert ck._launch_error(700, Lib) == "cuda error 700"

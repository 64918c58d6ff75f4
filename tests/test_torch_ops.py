"""The port's plain ops against the JAX package's, on the same inputs.

Inputs come from a numpy seed and go through both the JAX function and
its PyTorch counterpart (dexiraft_tpu_torch, on the CPU). Tolerance:
atol 1e-5 in fp32 (the same arithmetic in another summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexiraft_tpu.ops import corr as jcorr
from dexiraft_tpu.ops import grid as jgrid
from dexiraft_tpu.ops import local_corr as jlocal
from dexiraft_tpu.ops import quant as jquant
from dexiraft_tpu.ops import upsample as jup
from dexiraft_tpu_torch.ops import corr as tcorr
from dexiraft_tpu_torch.ops import grid as tgrid
from dexiraft_tpu_torch.ops import local_corr as tlocal
from dexiraft_tpu_torch.ops import quant as tquant
from dexiraft_tpu_torch.ops import upsample as tup

ATOL = 1e-5


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy() if hasattr(t, "detach") else t,
                               np.asarray(j, np.float32), rtol=0, atol=atol)


def _coords(rng, b, h, w, spread=2.0):
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.stack([xs, ys], -1)[None].repeat(b, 0).astype(np.float32)
    return grid + rng.uniform(-spread, spread, (b, h, w, 2)).astype(np.float32)


class TestGrid:
    def test_coords_grid(self):
        _close(tgrid.coords_grid(2, 5, 7), jgrid.coords_grid(2, 5, 7))

    @pytest.mark.parametrize("hw", [(5, 7), (1, 3)])
    def test_resize_and_upflow8(self, hw):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2,) + hw + (2,)).astype(np.float32)
        _close(tgrid.resize_bilinear_align_corners(torch.from_numpy(x), 11, 9),
               jgrid.resize_bilinear_align_corners(jnp.asarray(x), 11, 9))
        _close(tgrid.upflow8(torch.from_numpy(x)),
               jgrid.upflow8(jnp.asarray(x)), atol=1e-4)


class TestCorr:
    def test_all_pairs_correlation(self):
        rng = np.random.default_rng(1)
        f1 = rng.standard_normal((2, 4, 5, 16)).astype(np.float32)
        f2 = rng.standard_normal((2, 3, 6, 16)).astype(np.float32)
        _close(tcorr.all_pairs_correlation(torch.from_numpy(f1), torch.from_numpy(f2)),
               jcorr.all_pairs_correlation(jnp.asarray(f1), jnp.asarray(f2)))

    @pytest.mark.parametrize("hw", [(6, 8), (5, 7), (1, 3)])
    def test_avg_pool_valid(self, hw):
        rng = np.random.default_rng(2)
        x = rng.standard_normal((2,) + hw + (3,)).astype(np.float32)
        out = tcorr.avg_pool_2x2(torch.from_numpy(x))
        assert tuple(out.shape) == (2, hw[0] // 2, hw[1] // 2, 3)
        _close(out, jcorr.avg_pool_2x2(jnp.asarray(x)))

    @pytest.mark.parametrize("radius", [2, 4])
    def test_window_delta_and_axis_matrix(self, radius):
        _close(tcorr._window_delta(radius), jcorr._window_delta(radius))
        c = np.array([0.3, -2.5, 7.75], np.float32)
        _close(tcorr._axis_interp_matrix(torch.from_numpy(c), radius, 9),
               jcorr._axis_interp_matrix(jnp.asarray(c), radius, 9))

    @pytest.mark.parametrize("radius", [2, 4])
    def test_interp_window(self, radius):
        rng = np.random.default_rng(3)
        vol = rng.standard_normal((10, 7, 9)).astype(np.float32)
        cen = rng.uniform(-3, 11, (10, 2)).astype(np.float32)
        scale = np.float32(0.37)
        _close(tcorr.interp_window(torch.from_numpy(vol), torch.from_numpy(cen),
                                   radius, torch.tensor(scale)),
               jcorr.interp_window(jnp.asarray(vol), jnp.asarray(cen), radius,
                                   jnp.asarray(scale)))

    def test_interp_window_channel_order_x_slow(self):
        """A single 1 at (x=cx+dx, y=cy+dy) must land on channel
        (dx+r)*(2r+1) + (dy+r): the reference's transposed window."""
        r, win = 2, 5
        vol = np.zeros((1, 9, 9), np.float32)
        cx, cy, dx, dy = 4, 4, 2, -1
        vol[0, cy + dy, cx + dx] = 1.0
        cen = np.array([[cx, cy]], np.float32)
        out = tcorr.interp_window(torch.from_numpy(vol), torch.from_numpy(cen), r)
        ref = np.asarray(jcorr.interp_window(jnp.asarray(vol), jnp.asarray(cen), r))
        k = (dx + r) * win + (dy + r)
        assert out[0].argmax().item() == k == int(ref[0].argmax())
        assert out[0, k].item() == 1.0


class TestLocalCorr:
    @pytest.mark.parametrize("row_chunk", [None, 3])
    @pytest.mark.parametrize("radius", [2, 4])
    def test_local_corr_level(self, radius, row_chunk):
        rng = np.random.default_rng(4)
        f1 = rng.standard_normal((2, 7, 8, 16)).astype(np.float32)
        f2 = rng.standard_normal((2, 7, 8, 16)).astype(np.float32)
        co = _coords(rng, 2, 7, 8)
        co[0, 0, 0] = (500.0, -400.0)  # far out of frame: zero window
        out = tlocal.local_corr_level(torch.from_numpy(f1), torch.from_numpy(f2),
                                      torch.from_numpy(co), radius, row_chunk)
        ref = jlocal.local_corr_level(jnp.asarray(f1), jnp.asarray(f2),
                                      jnp.asarray(co), radius, row_chunk)
        _close(out, ref)
        assert float(out[0, 0, 0].abs().max()) == 0.0

    @pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
    def test_build_and_lookup_pyramid(self, dtype):
        """Pooled-fmap2 pyramid (down to a degenerate 0-row level) and the
        multi-level lookup at coords / 2**l, with int8 scales applied."""
        rng = np.random.default_rng(5)
        f1 = rng.standard_normal((1, 6, 8, 16)).astype(np.float32)
        f2 = rng.standard_normal((1, 6, 8, 16)).astype(np.float32)
        co = _coords(rng, 1, 6, 8)
        tp = tlocal.build_local_corr(torch.from_numpy(f1), torch.from_numpy(f2),
                                     4, 2, row_chunk=4, dtype=dtype)
        jp = jlocal.build_local_corr(jnp.asarray(f1), jnp.asarray(f2), 4, 2,
                                     row_chunk=4, dtype=dtype)
        assert [tuple(x.shape) for x in tp.fmap2_pyramid] == \
            [tuple(x.shape) for x in jp.fmap2_pyramid]
        assert tp.fmap2_pyramid[3].shape[1] == 0
        for a, b in zip(tp.fmap2_pyramid, jp.fmap2_pyramid):
            _close(a.to(torch.float32), np.asarray(b, np.float32))
        _close(tp(torch.from_numpy(co)), jp(jnp.asarray(co)))


class TestQuant:
    @pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
    def test_store_corr(self, dtype):
        rng = np.random.default_rng(6)
        x = (rng.standard_normal((2, 3, 4, 16)) * 3).astype(np.float32)
        tq, ts = tquant.store_corr(torch.from_numpy(x), dtype)
        jq, js = jquant.store_corr(jnp.asarray(x), dtype)
        assert (ts is None) == (js is None)
        _close(tq.to(torch.float32), np.asarray(jq, np.float32))
        if ts is not None:
            _close(ts, js, atol=0)

    def test_empty_level_scale_and_zero_guard(self):
        q, s = tquant.quantize_symmetric(torch.zeros((1, 0, 1, 16)))
        assert q.dtype == torch.int8 and float(s) == 1.0
        q, s = tquant.quantize_symmetric(torch.zeros((1, 2, 2, 16)))
        assert float(s) == pytest.approx(1e-12 / 127.0) and not q.any()
        with pytest.raises(ValueError):
            tquant.store_corr(torch.zeros(1), "fp16")


class TestUpsample:
    def test_convex_upsample(self):
        rng = np.random.default_rng(7)
        flow = rng.standard_normal((2, 3, 5, 2)).astype(np.float32)
        mask = rng.standard_normal((2, 3, 5, 576)).astype(np.float32)
        _close(tup.upsample_flow_convex(torch.from_numpy(flow), torch.from_numpy(mask)),
               jup.upsample_flow_convex(jnp.asarray(flow), jnp.asarray(mask)))

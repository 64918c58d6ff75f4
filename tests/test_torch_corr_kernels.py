"""The flash correlation kernels' wrappers against the JAX package.

On the CPU the port's ``flash_fused_step`` and ``flash_local_corr_level``
run their plain PyTorch versions; here they are held against the JAX
package's ``fused_reference`` and against its Pallas ``flash_fused_step``
/ ``flash_local_corr_level`` run in interpret mode, at r=2 and r=4, with
fp32/bf16/int8 levels, far out-of-frame coords and a degenerate level.
Tolerance: max abs error <= 1e-3, the bound the JAX package holds its own
kernel to (tests/test_zzzflashcorr.py).

The CUDA kernel itself runs only on the card: ``test_kernel_matches_plain_on_gpu``
carries the ``gpu`` marker and skips without one.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexiraft_tpu.ops.local_corr import build_local_corr as j_build
from dexiraft_tpu.ops.local_corr import local_corr_level as j_level
from dexiraft_tpu.ops.pallas_corr import flash_fused_step as j_flash_fused
from dexiraft_tpu.ops.pallas_corr import flash_local_corr_level as j_flash_level
from dexiraft_tpu.ops.pallas_corr import fused_reference as j_fused_ref
from dexiraft_tpu_torch.ops import corr_kernels as ck
from dexiraft_tpu_torch.ops.local_corr import build_local_corr as t_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-3


@pytest.fixture(autouse=True)
def _small_flash_blocks(monkeypatch):
    """Interpret-mode Pallas pays per grid step: tiny blocks for tiny
    fixtures (the knobs never change values)."""
    monkeypatch.setenv("DEXIRAFT_FLASH_PIXEL_BLOCK", "16")
    monkeypatch.setenv("DEXIRAFT_FLASH_ROWS", "2")


def _setup(seed, b=1, h=6, w=8, c=32, levels=3, radius=2, feat=16, far=True):
    rng = np.random.default_rng(seed)
    f1 = rng.standard_normal((b, h, w, c)).astype(np.float32)
    f2 = rng.standard_normal((b, h, w, c)).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    co = (np.stack([xs, ys], -1)[None].repeat(b, 0)
          + rng.uniform(-2, 2, (b, h, w, 2))).astype(np.float32)
    if far:  # one row of far out-of-frame coords
        co[:, 0, :, 0] += 1000.0
        co[:, 0, : w // 2, 1] -= 5000.0
    win = 2 * radius + 1
    weight = (rng.standard_normal((levels * win * win, feat)) * 0.05
              ).astype(np.float32)
    bias = (rng.standard_normal(feat) * 0.1).astype(np.float32)
    return f1, f2, co, weight, bias


def _pyramids(f1, f2, levels, radius, dtype):
    tp = t_build(torch.from_numpy(f1), torch.from_numpy(f2), levels, radius,
                 dtype=dtype)
    jp = j_build(jnp.asarray(f1), jnp.asarray(f2), levels, radius, dtype=dtype)
    return tp, jp


def _fold(weight, scales, win):
    """Fold per-level int8 scales into the weight rows (the caller's job)."""
    if scales is None:
        return weight
    kk = win * win
    return np.concatenate([weight[i * kk:(i + 1) * kk] * np.float32(s)
                           for i, s in enumerate(scales)])


def _maxerr(t, j):
    return float(np.max(np.abs(t.detach().numpy() - np.asarray(j))))


class TestFusedStep:
    @pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
    @pytest.mark.parametrize("radius", [2, 4])
    def test_matches_jax_flash_and_reference(self, radius, dtype):
        f1, f2, co, weight, bias = _setup(radius, radius=radius)
        tp, jp = _pyramids(f1, f2, 3, radius, dtype)
        win = 2 * radius + 1
        w = _fold(weight, None if jp.scales is None
                  else [np.asarray(s) for s in jp.scales], win)
        out = ck.flash_fused_step(tp.fmap1, tp.fmap2_pyramid,
                                  torch.from_numpy(co), torch.from_numpy(w),
                                  torch.from_numpy(bias), radius)
        plain = ck.fused_reference(tp.fmap1, tp.fmap2_pyramid,
                                   torch.from_numpy(co), torch.from_numpy(w),
                                   torch.from_numpy(bias), radius)
        jw, jb, jco = jnp.asarray(w), jnp.asarray(bias), jnp.asarray(co)
        j_kernel = j_flash_fused(jp.fmap1, jp.fmap2_pyramid, jco, jw, jb,
                                 radius, True)
        j_ref = j_fused_ref(jp.fmap1, jp.fmap2_pyramid, jco, jw, jb, radius)
        assert tuple(out.shape) == (1, 6, 8, 16)
        assert _maxerr(out, j_kernel) <= TOL
        assert _maxerr(plain, j_ref) <= TOL
        # the far row reads only the bias
        np.testing.assert_allclose(out[0, 0].detach().numpy(),
                                   np.broadcast_to(bias, (8, 16)), atol=1e-6)

    def test_degenerate_level(self):
        """6x8 at level 0 pools to a 0-row 4th level: it contributes
        nothing, in the plain path as in the JAX kernel."""
        radius = 2
        f1, f2, co, weight, bias = _setup(11, levels=4, radius=radius)
        tp, jp = _pyramids(f1, f2, 4, radius, "fp32")
        assert tp.fmap2_pyramid[3].shape[1] == 0
        out = ck.flash_fused_step(tp.fmap1, tp.fmap2_pyramid,
                                  torch.from_numpy(co), torch.from_numpy(weight),
                                  torch.from_numpy(bias), radius)
        ref = j_flash_fused(jp.fmap1, jp.fmap2_pyramid, jnp.asarray(co),
                            jnp.asarray(weight), jnp.asarray(bias), radius,
                            True)
        assert _maxerr(out, ref) <= TOL

    @pytest.mark.parametrize("dtype", ["bf16", "int8"])
    def test_gradients_match_jax(self, dtype):
        """Backward recomputes through the plain version: fmap1, float
        levels, weight and bias get the JAX package's gradients, coords a
        zero gradient, int8 levels none."""
        radius = 2
        f1, f2, co, weight, bias = _setup(12, h=4, w=6, c=16, radius=radius,
                                          far=False)
        tp, jp = _pyramids(f1, f2, 3, radius, dtype)
        t_f1 = tp.fmap1.clone().requires_grad_()
        t_lv = [x.clone().requires_grad_() if x.is_floating_point() else x
                for x in tp.fmap2_pyramid]
        t_co = torch.from_numpy(co).requires_grad_()
        t_w = torch.from_numpy(weight).requires_grad_()
        t_b = torch.from_numpy(bias).requires_grad_()
        out = ck.flash_fused_step(t_f1, t_lv, t_co, t_w, t_b, radius)
        (out ** 2).sum().backward()

        def loss(f1_, w_, b_, *lv):
            return jnp.sum(j_fused_ref(f1_, lv, jnp.asarray(co), w_, b_,
                                       radius) ** 2)

        float_lv = dtype != "int8"
        argnums = (0, 1, 2) + ((3, 4, 5) if float_lv else ())
        g = jax.grad(loss, argnums=argnums)(
            jp.fmap1, jnp.asarray(weight), jnp.asarray(bias),
            *jp.fmap2_pyramid)
        for t, j in zip([t_f1.grad, t_w.grad, t_b.grad], g[:3]):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-3,
                                       atol=1e-3)
        if float_lv:
            for t, j in zip(t_lv, g[3:]):
                np.testing.assert_allclose(t.grad.float().numpy(),
                                           np.asarray(j, np.float32),
                                           rtol=2e-2, atol=2e-2)
        else:
            assert all(not x.requires_grad for x in t_lv)
        assert not t_co.grad.any()


class TestLookupLevel:
    @pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
    @pytest.mark.parametrize("radius", [2, 4])
    def test_matches_jax_flash_level(self, radius, dtype):
        f1, f2, co, _, _ = _setup(20 + radius, radius=radius)
        tp, jp = _pyramids(f1, f2, 2, radius, dtype)
        for lvl in range(2):
            tco = torch.from_numpy(co) / 2.0 ** lvl
            out = ck.flash_local_corr_level(tp.fmap1, tp.fmap2_pyramid[lvl],
                                            tco, radius)
            ref = j_flash_level(jp.fmap1, jp.fmap2_pyramid[lvl],
                                jnp.asarray(co) / 2.0 ** lvl, radius, True)
            assert _maxerr(out, ref) <= TOL
            assert float(out[0, 0].abs().max()) == 0.0  # far row

    def test_degenerate_level_is_zero(self):
        radius = 2
        f1, f2, co, _, _ = _setup(30, radius=radius)
        tp, jp = _pyramids(f1, f2, 4, radius, "fp32")
        out = ck.flash_local_corr_level(tp.fmap1, tp.fmap2_pyramid[3],
                                        torch.from_numpy(co) / 8.0, radius)
        ref = j_flash_level(jp.fmap1, jp.fmap2_pyramid[3],
                            jnp.asarray(co) / 8.0, radius, True)
        assert tuple(out.shape) == (1, 6, 8, 25)
        assert not out.any()
        np.testing.assert_array_equal(np.asarray(ref), 0.0)

    def test_lookup_gradients_zero_coords(self):
        radius = 2
        f1, f2, co, _, _ = _setup(31, h=4, w=6, c=16, radius=radius, far=False)
        a = torch.from_numpy(f1).requires_grad_()
        b = torch.from_numpy(f2).requires_grad_()
        c = torch.from_numpy(co).requires_grad_()
        ck.flash_local_corr_level(a, b, c, radius).square().sum().backward()
        g = jax.grad(lambda x, y: jnp.sum(j_level(x, y, jnp.asarray(co),
                                                  radius) ** 2),
                     argnums=(0, 1))(jnp.asarray(f1), jnp.asarray(f2))
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g[0]), atol=1e-3)
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(g[1]), atol=1e-3)
        assert not c.grad.any()


class TestDispatch:
    def test_mixed_devices_refused(self):
        f1, f2, co, _, _ = _setup(40)
        with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
            ck.flash_local_corr_level(torch.from_numpy(f1),
                                      torch.from_numpy(f2).to("meta"),
                                      torch.from_numpy(co), 2)

    def test_launch_counts_untouched_by_plain_path(self):
        ck.reset_launches()
        f1, f2, co, _, _ = _setup(41)
        ck.flash_local_corr_level(torch.from_numpy(f1), torch.from_numpy(f2),
                                  torch.from_numpy(co), 2)
        assert ck.LAUNCHES == {"flash_fused_step": 0,
                               "flash_local_corr_level": 0,
                               "pallas_fused_step": 0,
                               "pallas_local_corr_level": 0}

    def test_import_does_not_build_or_invoke_nvcc(self, tmp_path):
        """Importing the kernel module (and the model that uses it) must
        not compile anything: no nvcc process, no library loaded."""
        code = (
            "import subprocess, ctypes\n"
            "calls = []\n"
            "orig = subprocess.Popen.__init__\n"
            "def spy(self, *a, **k):\n"
            "    calls.append(a); return orig(self, *a, **k)\n"
            "subprocess.Popen.__init__ = spy\n"
            "import dexiraft_tpu_torch.ops.corr_kernels as ck\n"
            "import dexiraft_tpu_torch.ops.cuda_build as cb\n"
            "import dexiraft_tpu_torch.models.raft\n"
            "assert calls == [], calls\n"
            "assert cb._loaded == {}, cb._loaded\n"
            "print('ok')\n")
        env = dict(os.environ, PATH=str(tmp_path))  # no nvcc reachable either
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.strip() == "ok"


class TestKernelLibraries:
    CSRC = os.path.join(REPO, "dexiraft_tpu_torch", "csrc")

    def test_every_cuda_source_is_built_once(self):
        """Each csrc/*.cu and its binding belong to exactly one kernel
        library, so every kernel is built, and none twice."""
        listed = [s for srcs, _ in ck.KERNEL_LIBRARIES.values() for s in srcs]
        assert len(listed) == len(set(listed))
        on_disk = {f for f in os.listdir(self.CSRC)
                   if f.endswith((".cu", ".cpp"))}
        assert set(listed) == on_disk

    def test_every_wrapper_names_a_library_with_an_entry_point(self):
        """Each kernel wrapper's library exists, exports a C entry point
        defined in its sources, and has a launch count."""
        assert set(ck.KERNEL_LIBRARY_OF.values()) == set(ck.KERNEL_LIBRARIES)
        assert set(ck.LAUNCHES) == set(ck.KERNEL_LIBRARY_OF)
        for srcs, entry in ck.KERNEL_LIBRARIES.values():
            text = "".join(open(os.path.join(self.CSRC, s)).read()
                           for s in srcs)
            assert f"int {entry}(" in text


def _field(co, field, seed):
    """The test coords (grid + U(-2, 2), far row) or one of B1's branch
    fields: a smooth shift per batch item (one staged f2 patch per tile)
    or coords scattered over the frame (level 0 read pixel by pixel)."""
    rng = np.random.default_rng(seed)
    b, h, w, _ = co.shape
    if field == "smooth":
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        grid = np.stack([xs, ys], -1)[None].astype(np.float32)
        return grid + rng.uniform(-3, 3, (b, 1, 1, 2)).astype(np.float32)
    if field == "scattered":
        return (rng.uniform(0, 1, co.shape) * np.array([w, h])
                ).astype(np.float32)
    return co


@pytest.mark.gpu
def test_kernel_matches_plain_on_gpu():
    """On the card: the CUDA kernel against its plain version (B1 and B2,
    every storage dtype, a degenerate level; B1 also on a smooth and a
    scattered field, its two branches), max abs error <= 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in ("fp32", "bf16", "int8"):
        f1, f2, co, weight, bias = _setup(50, b=2, h=40, w=48, levels=4,
                                          radius=4)
        dev = torch.device("cuda")
        pyr = t_build(torch.from_numpy(f1).to(dev), torch.from_numpy(f2).to(dev),
                      4, 4, dtype=dtype)
        w = torch.from_numpy(weight).to(dev)
        b = torch.from_numpy(bias).to(dev)
        for field in ("jitter", "smooth", "scattered"):
            co_f = torch.from_numpy(_field(co, field, 51)).to(dev)
            out = ck.flash_fused_step(pyr.fmap1, pyr.fmap2_pyramid, co_f, w,
                                      b, 4)
            ref = ck.fused_reference(pyr.fmap1, pyr.fmap2_pyramid, co_f, w,
                                     b, 4)
            assert float((out - ref).abs().max()) <= TOL, field
        co_d = torch.from_numpy(co).to(dev)
        for lvl, f2l in enumerate(pyr.fmap2_pyramid):
            c_l = co_d / 2.0 ** lvl
            out = ck.flash_local_corr_level(pyr.fmap1, f2l, c_l, 4)
            ref = ck.local_corr_level(pyr.fmap1, f2l.float(), c_l, 4)
            assert float((out - ref).abs().max()) <= TOL

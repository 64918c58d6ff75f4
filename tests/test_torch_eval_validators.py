"""The port's validators, submission writers and flow viz against the JAX
package's, on the same dataset objects and the same numpy stub eval fn
(as tests/test_eval.py builds them): the logic, not the model.

The stub's flows are per-pixel functions of the (padded) input frames,
so a frame's flow does not depend on its padding or its batch: the
per-image path and the engine at batch 2 see the same per-frame values,
and every dataset below has one frame shape, so the engine yields frames
in input order. The metric dicts must then be EQUAL to JAX's (the same
float32 arithmetic in the same order): per image and through the port's
engine at batch 2, empty-mask skip counts, the HD1K fix and edgesum's
two-pass re-join included.

Submissions: the stub's flow_low adds half its flow_init, so a warm
start shows in the written flows. The splats of the two packages agree
where no two points land in one fine cell (eval/interpolate.py); the
stub's smooth flow_low has no such collisions, so warm-start flow_inits
agree within 1e-5 px (float32 rounding of the splat's coordinates) and
the written flows within 1e-5 px.
"""

import os

import numpy as np
import pytest
import torch

from dexiraft_tpu.data.flow_io import read_flo as j_read_flo
from dexiraft_tpu.eval import flow_viz as j_flow_viz
from dexiraft_tpu.eval import submission as j_sub
from dexiraft_tpu.eval import validate as j_val
from dexiraft_tpu_torch.data.flow_io import read_flo, read_flow_kitti
from dexiraft_tpu_torch.eval import flow_viz, submission, validate

H, W = 44, 60  # pads to 48x64: the stub sees replicated edges


def _images(rng, h=H, w=W):
    return (rng.uniform(0, 255, (h, w, 3)).astype(np.float32),
            rng.uniform(0, 255, (h, w, 3)).astype(np.float32))


class _Dense:
    """Dense samples: random frames and flow (valid everywhere)."""

    def __init__(self, n=3, seed=0, edges=False):
        self.n, self.seed, self.edges = n, seed, edges

    def __len__(self):
        return self.n

    def sample(self, i, rng=None):
        r = np.random.default_rng(1000 * self.seed + i)
        im1, im2 = _images(r)
        s = {"image1": im1, "image2": im2,
             "flow": r.normal(0, 2, (H, W, 2)).astype(np.float32),
             "valid": np.ones((H, W), np.float32)}
        if self.edges:
            s["edges1"], s["edges2"] = _images(r)
        return s


class _Sparse(_Dense):
    """Sparse samples (KITTI/HD1K): ~30% valid; frame ``empty`` has
    none."""

    def __init__(self, n=4, seed=1, empty=2):
        super().__init__(n, seed)
        self.empty = empty

    def sample(self, i, rng=None):
        s = super().sample(i)
        r = np.random.default_rng(7 + i)
        frac = 0.0 if i == self.empty else 0.3
        s["valid"] = (r.uniform(size=(H, W)) < frac).astype(np.float32)
        return s


class _Sequences:
    """Sintel test-split stand-in: sequences of frames with extra_info
    (sequence, frame) and no flow."""

    def __init__(self, lengths=(3, 2, 4), seed=2):
        self.extra_info = [(f"seq{k}", j) for k, n in enumerate(lengths)
                           for j in range(n)]
        self.seed = seed

    def __len__(self):
        return len(self.extra_info)

    def sample(self, i, rng=None):
        r = np.random.default_rng(100 * self.seed + i)
        im1, im2 = _images(r)
        return {"image1": im1, "image2": im2,
                "extra_info": self.extra_info[i]}


class _KittiTest(_Dense):
    def sample(self, i, rng=None):
        s = super().sample(i)
        return {"image1": s["image1"], "image2": s["image2"],
                "extra_info": (f"{i:06d}_10.png",)}


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def stub_eval_fn(im1, im2, flow_init=None):
    """Per-pixel flows of the padded frames: flow_up from the frames,
    flow_low from the 8x-subsampled frames plus flow_init / 2."""
    im1, im2 = np.asarray(im1, np.float32), np.asarray(im2, np.float32)
    up = np.stack([(im1 - im2).mean(-1) / 40.0,
                   im1[..., 0] / 60.0 - 2.0], -1).astype(np.float32)
    low = 0.25 + 0.01 * up[:, 4::8, 4::8]
    if flow_init is not None:
        low = low + 0.5 * _host(flow_init)
    return low.astype(np.float32), up


def _recording(calls):
    def fn(im1, im2, flow_init=None):
        calls.append(None if flow_init is None else _host(flow_init).copy())
        return stub_eval_fn(im1, im2, flow_init)
    return fn


_CASES = {
    "chairs": lambda: _Dense(3, seed=3),
    "sintel": lambda: {"clean": _Dense(3, seed=4), "final": _Dense(2, 5)},
    "kitti": lambda: _Sparse(4, seed=6, empty=2),
    "hd1k": lambda: _Sparse(3, seed=8, empty=0),
    "edgesum": lambda: _Dense(3, seed=9, edges=True),
}


@pytest.mark.parametrize("name", sorted(_CASES))
@pytest.mark.parametrize("batch_size", [1, 2])
def test_validators_return_jax_metrics_exactly(name, batch_size, capsys):
    want = j_val.VALIDATORS[name](stub_eval_fn, _CASES[name]())
    want_out = capsys.readouterr().out
    got = validate.run_validation(name, stub_eval_fn, _CASES[name](),
                                  batch_size=batch_size)
    got_out = capsys.readouterr().out
    assert got == want  # keys and float values, exactly
    assert got_out == want_out  # the same printed lines
    if name in ("kitti", "hd1k"):
        assert "(1 empty-mask frames skipped)" in got_out


def test_validators_through_a_caller_engine():
    """A caller-built engine (eval_cli's --serve) gives the same dicts."""
    from dexiraft_tpu_torch.serve.engine import InferenceEngine, ServeConfig
    for name in ("chairs", "kitti"):
        mode = "kitti" if name == "kitti" else "sintel"
        engine = InferenceEngine(stub_eval_fn,
                                 ServeConfig(batch_size=2, mode=mode))
        assert validate.run_validation(name, stub_eval_fn, _CASES[name](),
                                       engine=engine) == \
            j_val.VALIDATORS[name](stub_eval_fn, _CASES[name]())
        assert engine.stats.frames == len(_CASES[name]())


def test_all_empty_masks_raise_as_jax():
    ds = _Sparse(2, empty=0)
    ds.sample = lambda i, rng=None, _s=ds.sample: {
        **_s(i), "valid": np.zeros((H, W), np.float32)}
    for fn in (j_val.validate_kitti, validate.validate_kitti):
        with pytest.raises(ValueError, match="empty valid mask"):
            fn(stub_eval_fn, ds)


def test_edgesum_needs_a_dataset():
    with pytest.raises(ValueError, match="edge-pair dataset"):
        validate.validate_edgesum(stub_eval_fn)


@pytest.mark.parametrize("kw", [{}, dict(rad_max=3.0), dict(clip_flow=2.5),
                                dict(convert_to_bgr=True)])
def test_flow_to_image_byte_equal(kw):
    flow = np.random.default_rng(11).normal(0, 3, (33, 47, 2))
    flow[0, 0] = 0.0
    got = flow_viz.flow_to_image(flow.astype(np.float32), **kw)
    want = j_flow_viz.flow_to_image(flow.astype(np.float32), **kw)
    assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()


def _flo_tree(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            out[os.path.relpath(p, root)] = p
    return out


@pytest.mark.parametrize("warm_start", [False, True])
@pytest.mark.parametrize("batch_size", [1, 2])
def test_sintel_submission_writes_jax_files(tmp_path, warm_start,
                                            batch_size):
    ds = {"clean": _Sequences(), "final": _Sequences((2, 3), seed=3)}
    j_calls, t_calls = [], []
    j_sub.create_sintel_submission(_recording(j_calls), str(tmp_path / "j"),
                                   warm_start=warm_start, datasets=ds,
                                   batch_size=batch_size)
    submission.create_sintel_submission(
        _recording(t_calls), str(tmp_path / "t"), warm_start=warm_start,
        datasets=ds, batch_size=batch_size)
    j_files, t_files = _flo_tree(tmp_path / "j"), _flo_tree(tmp_path / "t")
    assert sorted(t_files) == sorted(j_files) and len(t_files) == 14
    for rel in j_files:
        np.testing.assert_allclose(read_flo(t_files[rel]),
                                   j_read_flo(j_files[rel]), rtol=0,
                                   atol=1e-5, err_msg=rel)
    assert len(t_calls) == len(j_calls)
    warm = 0
    for a, b in zip(t_calls, j_calls):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
            warm += int((np.abs(a).reshape(len(a), -1).max(1) > 0).sum())
    # every frame after a sequence's first is warm-started (rows of a
    # batch counted one by one; the engine's filler rows are cold)
    assert warm == (9 if warm_start else 0)


@pytest.mark.parametrize("batch_size", [1, 2])
def test_kitti_submission_writes_jax_files(tmp_path, batch_size):
    import cv2
    ds = _KittiTest(3, seed=12)
    j_sub.create_kitti_submission(stub_eval_fn, str(tmp_path / "j"), ds,
                                  batch_size=batch_size)
    submission.create_kitti_submission(stub_eval_fn, str(tmp_path / "t"),
                                       ds, batch_size=batch_size)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 3
    for n in names:
        j_raw = cv2.imread(str(tmp_path / "j" / n), cv2.IMREAD_UNCHANGED)
        t_raw = cv2.imread(str(tmp_path / "t" / n), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(t_raw, j_raw)
        flow, valid = read_flow_kitti(tmp_path / "t" / n)
        assert flow.shape == (H, W, 2) and valid.all()

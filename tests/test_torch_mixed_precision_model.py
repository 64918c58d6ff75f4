"""Mixed precision, whole model: the port's bf16 forward argued against
JAX's, for v1, v1 small and v5.

The JAX package's own tests only check that a bf16 forward is finite, and
two bf16 forwards cannot agree closely: every rounding point can flip on
an fp32 accumulation-order difference, and through the encoders' norms
and the refinement loop those flips spread (tests/test_torch_mixed_
precision.py holds each module). So the bound is argued from bf16's own
error in the reference. With ``J32`` JAX's fp32 forward, ``J16`` JAX's
``mixed_precision`` forward (both jitted, ``corr_impl="local"``), ``P16``
the port's mixed precision and ``P32`` its fp32 forward, all on the same
seeded weights (the bridge's fp32 state dict):

  e_J = relL2(J16, J32), floored at 2^-9 (half a bf16 ulp, the least error
  a forward that rounds at all can be credited with, so that a forward
  that happened to be exact in bf16 gives no vacuous or impossible bound)

  relL2(P16, J32) <= A * e_J   the port's bf16 is no farther from fp32
                               than JAX's bf16 is, within a factor;
  relL2(P16, J16) <= B * e_J   and no farther from JAX's bf16 than bf16's
                               own error;
  relL2(P16, P32) >= e_J / 2   the port really rounds (an fp32 forward
                               labelled bf16 passes the first two).

Readings, flow_low and flow_up, over 6 seeds each (weights
``_randomize(seed 100..105)``, images ``_images(..., 0..5)``, 3
iterations; v1 and v1 small at 64x64, v5 at 48x64; a CPU run, torch 2.13,
jax 0.9.0):

  variant    e_J              relL2(P16,J32)/e_J   relL2(P16,J16)/e_J
  v1         2.2e-3..1.3e-2   0.876..1.160         0.582..1.087
  v1 small   6.4e-3..1.9e-2   0.874..1.228         0.971..1.210
  v5         3.7e-3..1.2e-2   0.857..1.259         0.520..1.127

The port and JAX land about equally far from fp32, and about that far
from each other: their rounding errors are uncorrelated, so the second
ratio sits near 1 (sqrt(2) if both were equally large and independent;
jitted JAX's is a little smaller, tests/test_torch_mixed_precision.py).
A = B = 1.5 leaves a fifth above the largest reading; the tests run seed
100 / images 0 of each variant. The worst pixel of flow_up differed by
0.52 px (v1 small, where flow_up reaches 33 px).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexiraft_tpu.config import raft_v1 as j_raft_v1
from dexiraft_tpu.config import raft_v5 as j_raft_v5
from dexiraft_tpu.models.raft import RAFT as JRAFT
from dexiraft_tpu_torch.config import raft_v1, raft_v5
from dexiraft_tpu_torch.interop.jax_weights import raft_state_dict_from_jax
from dexiraft_tpu_torch.models.raft import RAFT
from test_torch_raft import _images, _randomize
from test_torch_train_ops import few_torch_threads  # noqa: F401

A = B = 1.5
E_FLOOR = 2.0 ** -9
ITERS = 3
CASES = {
    # name: (JAX config, port config, kwargs, (H, W))
    "v1": (j_raft_v1, raft_v1, {}, (64, 64)),
    "v1_small": (j_raft_v1, raft_v1, {"small": True}, (64, 64)),
    "v5": (j_raft_v5, raft_v5, {}, (48, 64)),
}


@pytest.fixture(autouse=True)
def _two_threads(few_torch_threads):  # noqa: F811
    """2 torch threads: the suite runs 6 workers at once."""
    yield


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def forwards(name, seed=0):
    """{J32, J16, P32, P16: (flow_low, flow_up) NHWC numpy} of one case."""
    jcfg, pcfg, kw, (h, w) = CASES[name]
    img = jnp.zeros((1, 48, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: JRAFT(jcfg(corr_impl="local", **kw)).init(
        jax.random.PRNGKey(0), img, img, iters=1, train=False))
    variables = _randomize(shapes, 100 + seed)
    im1, im2 = _images(h, w, seed)
    out = {}
    for mp in (False, True):
        model = JRAFT(jcfg(corr_impl="local", mixed_precision=mp, **kw))
        run = jax.jit(lambda v, a, b, m=model: m.apply(
            v, a, b, iters=ITERS, train=False, test_mode=True))
        out["J16" if mp else "J32"] = [np.asarray(x) for x in run(
            variables, jnp.asarray(im1), jnp.asarray(im2))]
    cfg = pcfg(corr_impl="local", **kw)
    sd = raft_state_dict_from_jax(variables, cfg=cfg)
    for mp in (False, True):
        m = RAFT(dataclasses.replace(cfg, mixed_precision=mp))
        m.load_state_dict(sd, strict=True)
        with torch.inference_mode():
            low, up = m.eval()(torch.from_numpy(im1).permute(0, 3, 1, 2),
                               torch.from_numpy(im2).permute(0, 3, 1, 2),
                               iters=ITERS)
        assert low.dtype == up.dtype == torch.float32
        out["P16" if mp else "P32"] = [t.permute(0, 2, 3, 1).numpy()
                                       for t in (low, up)]
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_whole_model_meets_the_argued_bound(name):
    out = forwards(name)
    for k, label in enumerate(("flow_low", "flow_up")):
        j32, j16, p32, p16 = (out[x][k] for x in ("J32", "J16", "P32", "P16"))
        assert np.isfinite(p16).all() and np.abs(j32).max() > 1e-1
        # the fp32 forwards agree as the fp32 slice tests hold them
        np.testing.assert_allclose(p32, j32, rtol=1e-2, atol=1e-3)
        e_j = max(rel_l2(j16, j32), E_FLOOR)
        assert rel_l2(p16, j32) <= A * e_j, (label, rel_l2(p16, j32), e_j)
        assert rel_l2(p16, j16) <= B * e_j, (label, rel_l2(p16, j16), e_j)
        assert rel_l2(p16, p32) >= e_j / 2, (label, rel_l2(p16, p32), e_j)

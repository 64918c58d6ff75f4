"""Halo compute sharding and context-parallel correlation of the port
(``dexiraft_tpu_torch/parallel/{halo,context}.py``) against JAX's and
against the port's own unsharded paths.

The ranks (tests/torch_parallel_child.py, gloo on the CPU) run small v1
at 48x64, global batch 4, 2 iterations, from the seeded random weights
of tests/test_torch_train_step.py carried through the weight bridge, on
two meshes: data 1 x fsdp 1 x seq 2 (2 ranks) and data 1 x fsdp 2 x
seq 2 (4 ranks). Each rank runs the halo eval step on the initial
weights (3 iterations), the halo gradient function on the first batch,
then two halo train steps; the 2-rank run also takes the gradient again
under ``remat="per_iter"`` and computes its rows of
``context_parallel_corr`` and ``ring_corr_lookup`` and of two single
convs (``halo_conv``).

  * (a) ``halo_rows()`` and ``chain_halo`` equal JAX's.
  * (b) ``halo_conv`` on 2 ranks equals the unsharded conv to the bit,
    for a stride-1 3x3 conv and the stride-2 7x7 stem, and JAX's
    ``halo_conv`` on a 2-device seq mesh (XLA's conv rounds otherwise:
    1e-5).
  * (c) every refusal of JAX's ``check_halo_support``, mirrored.
  * (d) the padder at seq 2.
  * (e) both context-parallel lookups on 2 ranks against the port's
    unsharded lookup and JAX's ``context_parallel_corr`` /
    ``ring_corr_lookup`` on a 2-device seq mesh (JAX's test bounds,
    1e-4).
  * (f) the halo gradient function against JAX's ``make_halo_train_fn``
    on the same mesh shape: the loss at rtol 1e-4, the gradients at the
    bounds tests/test_torch_fsdp.py holds the fsdp step to (rtol 3e-3,
    atol 3e-5).
  * (g) the same against the port's one-process step (JAX's fence-halo
    bounds, atol 1e-4 / rtol 1e-3): gradients, per-step losses and the
    parameters after two steps; the gradients scaled by n_seq would
    fail the bound.
  * (h) the halo eval step against the port's unsharded forward, within
    1e-3 px.

JAX's halo module passes ``check_rep`` to ``shard_map``, which jax 0.9
spells ``check_vma``: the tests build JAX's functions under
a keyword shim (:func:`jax_halo`) and change nothing in the package. The
children start with the first test that needs them and run while this
process compiles JAX's functions.
"""

import dataclasses
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dexiraft_tpu.config import TrainConfig as JTrainConfig
from dexiraft_tpu.config import raft_v1 as j_raft_v1
from dexiraft_tpu_torch.config import TrainConfig, raft_v1, raft_v5
from dexiraft_tpu_torch.data.padder import InputPadder
from dexiraft_tpu_torch.interop.jax_weights import raft_state_dict_from_jax
from dexiraft_tpu_torch.models.raft import RAFT
from dexiraft_tpu_torch.ops.corr import build_corr_pyramid, corr_lookup
from dexiraft_tpu_torch.ops.grid import coords_grid
from dexiraft_tpu_torch.ops.losses import sequence_loss
from dexiraft_tpu_torch.parallel import halo
from dexiraft_tpu_torch.parallel.distributed import World
from dexiraft_tpu_torch.parallel.layout import FsdpMesh, MeshAxis
from dexiraft_tpu_torch.train.state import create_state
from dexiraft_tpu_torch.train.step import make_eval_step, make_train_step
from test_torch_parallel import _close, free_port, rank_env
from test_torch_train_ops import few_torch_threads  # noqa: F401
from test_torch_train_step import jax_variables, make_batch

HERE = os.path.dirname(os.path.abspath(__file__))
SIZE, ITERS, EVAL_ITERS, STEPS = (48, 64), 2, 3, 2
LR, NUM_STEPS = 1e-4, 200
#: world -> n_fsdp (seq 2 throughout)
LAYOUTS = {2: 1, 4: 2}
CTX_LEVELS, CTX_RADIUS = 3, 3


@pytest.fixture(autouse=True)
def _two_threads(few_torch_threads):  # noqa: F811
    yield


def batches():
    out = []
    for seed in (3, 4):
        b = make_batch(seed, h=SIZE[0], w=SIZE[1], b=4)
        drop = np.random.default_rng(seed).uniform(size=b["valid"][2:].shape)
        b["valid"][2:] *= drop > 0.6
        out.append(b)
    return out


def context_inputs():
    """JAX's test_context_parallel geometry, from numpy: (B, 16, 16, 32)
    maps and coords off the grid by up to 2 px."""
    rng = np.random.default_rng(7)
    f1 = rng.normal(size=(2, 16, 16, 32)).astype(np.float32)
    f2 = rng.normal(size=(2, 16, 16, 32)).astype(np.float32)
    coords = (coords_grid(2, 16, 16).numpy()
              + rng.uniform(-2, 2, (2, 16, 16, 2)).astype(np.float32))
    return dict(f1=f1, f2=f2, coords=coords, levels=CTX_LEVELS,
                radius=CTX_RADIUS)


def conv_cases():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 16, 8)).astype(np.float32)
    cases = {}
    for kh, stride in ((3, 1), (7, 2)):
        cases[(kh, stride)] = (rng.normal(size=(4, 3, kh, kh)).astype(
            np.float32), rng.normal(size=(4,)).astype(np.float32))
    return x, cases


def jax_halo():
    """JAX's halo module with ``shard_map`` taking ``check_rep`` under
    whichever keyword this jax has (a context manager)."""
    from dexiraft_tpu.parallel import halo as jhalo

    patch = pytest.MonkeyPatch.context()
    mp = patch.__enter__()
    if "check_rep" not in inspect.signature(jhalo.shard_map).parameters:
        sm = jhalo.shard_map
        mp.setattr(jhalo, "shard_map",
                   lambda f, *, check_rep=True, **kw: sm(
                       f, check_vma=check_rep, **kw))
    return jhalo, patch


class _Children:
    """The 2-rank and 4-rank halo runs, started at construction."""

    def __init__(self, spec, d):
        self.d, self.procs, self._done = d, {}, {}
        for world, n_fsdp in LAYOUTS.items():
            out = d / f"w{world}"
            out.mkdir()
            extra = {}
            halo_kw = dict(spec["halo"], fsdp=n_fsdp)
            if world == 2:
                extra = dict(context=context_inputs(), convs=conv_cases())
                halo_kw["remat"] = True
            torch.save(dict(spec, halo=halo_kw, **extra), out / "spec.pt")
            port = free_port()
            self.procs[world] = [subprocess.Popen(
                [sys.executable, os.path.join(HERE, "torch_parallel_child.py"),
                 str(out / "spec.pt"), str(out)],
                env=rank_env(r, world, port), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True) for r in range(world)]

    def results(self, world):
        if world not in self._done:
            procs = self.procs[world]
            outs = [p.communicate(timeout=400)[0] for p in procs]
            assert [p.returncode for p in procs] == [0] * world, outs
            self._done[world] = [torch.load(self.d / f"w{world}" /
                                            f"rank{r}.pt", weights_only=False)
                                 for r in range(world)]
        return self._done[world]

    def kill(self):
        for procs in self.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX variables, spec, the running children)."""
    jvars = jax_variables(j_raft_v1(small=True), 11)
    spec = dict(state_dict=raft_state_dict_from_jax(
        jvars, cfg=raft_v1(small=True)), iters=ITERS, size=SIZE,
        batches=batches(), eval_batch=make_batch(5, h=SIZE[0], w=SIZE[1], b=2),
        halo=dict(small=True, steps=STEPS, eval_iters=EVAL_ITERS, lr=LR,
                  num_steps=NUM_STEPS))
    children = _Children(spec, tmp_path_factory.mktemp("halo"))
    yield jvars, spec, children
    children.kill()


def _tc():
    return TrainConfig(iters=ITERS, batch_size=4, image_size=SIZE,
                       num_steps=NUM_STEPS, lr=LR, freeze_bn=True)


@pytest.fixture(scope="module")
def one_process(runs):
    """The port's one-process references on the same weights, at the
    children's 2 threads: the gradient of the first batch's loss (the
    plain model, sequence_loss, backward), the per-step metrics and the
    state after the fence steps, the eval forward."""
    spec = runs[1]
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cfg = raft_v1(small=True)
        model = RAFT(cfg)
        model.load_state_dict(spec["state_dict"], strict=True)
        ev = make_eval_step(model, iters=EVAL_ITERS, device="cpu")
        low, up = ev(spec["eval_batch"]["image1"],
                     spec["eval_batch"]["image2"])
        b = {k: torch.from_numpy(v) for k, v in spec["batches"][0].items()}
        nchw = {k: v.permute(0, 3, 1, 2) for k, v in b.items()
                if k != "valid"}
        model.train()
        preds = model(nchw["image1"], nchw["image2"], iters=ITERS,
                      test_mode=False)
        loss, _ = sequence_loss(preds, nchw["flow"], b["valid"])
        loss.backward()
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        state = create_state(cfg, _tc(), device="cpu", model=RAFT(cfg))
        state.model.load_state_dict(spec["state_dict"], strict=True)
        step = make_train_step(cfg, _tc())
        metrics = []
        for batch in spec["batches"][:STEPS]:
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    finally:
        torch.set_num_threads(n)
    return dict(eval=(low, up), loss=loss.item(), grads=grads,
                metrics=metrics, state_dict=sd)


@pytest.fixture(scope="module")
def jax_grads(runs):
    """JAX's halo gradient function (``make_halo_train_fn``) on each mesh
    shape, on the first batch: (loss, the gradients through the
    bridge)."""
    import jax
    import jax.numpy as jnp

    from dexiraft_tpu.parallel.layout import make_mesh_fsdp

    jvars, spec, _ = runs
    jtc = JTrainConfig(iters=ITERS, batch_size=4, image_size=SIZE,
                       num_steps=NUM_STEPS, lr=LR)
    b = [jnp.asarray(spec["batches"][0][k])
         for k in ("image1", "image2", "flow", "valid")]
    out = {}
    jhalo, patch = jax_halo()
    try:
        for world, n_fsdp in LAYOUTS.items():
            mesh = make_mesh_fsdp(1, n_fsdp, 2)
            fn = jax.jit(jhalo.make_halo_train_fn(j_raft_v1(small=True), jtc,
                                                  mesh, jvars["params"]))
            with mesh:
                loss, _, grads = fn(jvars["params"], {}, *b)
            out[world] = (float(loss), raft_state_dict_from_jax(
                {"params": jax.device_get(grads)}, cfg=raft_v1(small=True)))
    finally:
        patch.__exit__(None, None, None)
    return out


def _grads(rec):
    return rec["grad"]["grads"]


# ---- (a) the halo arithmetic -------------------------------------------


@pytest.mark.parametrize("chain", [((3, 1, 1),), ((7, 2, 3),), ((1, 1, 0),),
                                   ((3, 1, 1), (3, 1, 1)),
                                   ((7, 2, 3), (3, 1, 1))])
def test_chain_halo_equals_jax(chain):
    from dexiraft_tpu.parallel.halo import chain_halo as j_chain_halo

    assert halo.chain_halo(chain) == j_chain_halo(chain)


def test_halo_rows_equal_jax():
    from dexiraft_tpu.parallel.halo import halo_rows as j_halo_rows

    assert halo.halo_rows() == j_halo_rows() == {
        "encoder_basic": 53, "encoder_small": 25, "motion_encoder": 5,
        "gru_sep": 4, "gru_conv": 2, "flow_head": 2, "mask_head": 1,
        "upsample_convex": 1, "upflow8": 1}


# ---- (b) halo_conv -----------------------------------------------------


@pytest.mark.parametrize("kh, stride", [(3, 1), (7, 2)])
def test_halo_conv_bit_equal_to_the_unsharded_conv_and_jax(runs, jax_grads,
                                                          kh, stride):
    """(``jax_grads`` compiles JAX's halo step while the ranks run.)"""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from dexiraft_tpu.parallel.layout import LAYOUT, make_mesh_2d

    x, cases = conv_cases()
    w, b = cases[(kh, stride)]
    jhalo, patch = jax_halo()
    try:
        fn = jax.jit(jhalo.shard_map(
            lambda xl, kl, bl: jhalo.halo_conv(xl, kl, bl, stride=stride,
                                               n_seq=2),
            mesh=make_mesh_2d(1, 2),
            in_specs=(LAYOUT.batch_spatial_compute(), P(), P()),
            out_specs=LAYOUT.batch_spatial_compute()))
        jgot = np.asarray(jax.device_get(fn(
            jnp.asarray(x.transpose(0, 2, 3, 1)),
            jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(b))))
    finally:
        patch.__exit__(None, None, None)
    ref = F.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(b), stride, kh // 2)
    ranks = runs[2].results(2)
    for r, rec in enumerate(ranks):
        got, whole = rec["convs"][(kh, stride)]
        # bit for bit against the same conv unsharded, in the same process
        assert torch.equal(got, halo.slab(whole, MeshAxis(r, 2)))
        torch.testing.assert_close(whole, ref, rtol=1e-6, atol=1e-6)
    got = torch.cat([rec["convs"][(kh, stride)][0] for rec in ranks], dim=2)
    np.testing.assert_allclose(got.numpy(), jgot.transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)


# ---- (c) the support matrix --------------------------------------------


def _meshes():
    """(the port's (data 2, fsdp 2, seq 2) mesh, JAX's)."""
    from dexiraft_tpu.parallel.layout import make_mesh_fsdp

    world = World(0, 8, 0, torch.device("cpu"), "gloo", 8)
    return FsdpMesh(world, 2, 2, n_seq=2), make_mesh_fsdp(2, 2, 2)


def _ok(jax_side):
    if jax_side:
        return (j_raft_v1(small=True),
                JTrainConfig(batch_size=4, image_size=(48, 64), iters=2))
    return raft_v1(small=True), TrainConfig(batch_size=4,
                                            image_size=(48, 64), iters=2)


def _cfg(jax_side, **kw):
    if jax_side:
        from dexiraft_tpu.config import raft_v5 as j_raft_v5

        return {"v5": j_raft_v5}.get(kw.pop("variant", None),
                                     j_raft_v1)(**kw)
    return {"v5": raft_v5}.get(kw.pop("variant", None), raft_v1)(**kw)


#: (name, model config kwargs or None, train config changes or None, the
#: fragment JAX's tests match)
REFUSALS = [
    ("v5", dict(variant="v5"), None, "variant='raft'"),
    ("local", dict(small=True, corr_impl="local"), None, "allpairs"),
    ("int8", dict(small=True, corr_dtype="int8"), None, "allpairs"),
    ("flash_fused", dict(small=True, corr_impl="flash", fused_update=True),
     None, "allpairs"),
    ("mixed", dict(small=True, mixed_precision=True), None, "fp32"),
    ("bf16", None, dict(precision="bf16"), "fp32"),
    ("dropout", dict(small=True, dropout=0.5), None, "dropout"),
    ("noise", None, dict(add_noise=True), "add_noise"),
    ("accum", None, dict(accum_steps=2), "accum_steps=1"),
    ("edge_sum", None, dict(edge_sum_fusion=True), "edge_sum_fusion"),
    ("bn_trains", dict(), None, "freeze_bn"),
    ("batch", None, dict(batch_size=3), "not divisible"),
    ("height", None, dict(image_size=(40, 64)), "divisible by 8"),
    ("rows", None, dict(image_size=(32, 64)), ">= 3"),
]


@pytest.mark.parametrize("name, model_kw, train_kw, fragment", REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_support_matrix_refusals_mirror_jax(name, model_kw, train_kw,
                                            fragment):
    from dexiraft_tpu.parallel.halo import check_halo_support as j_check

    port_mesh, jax_mesh = _meshes()
    messages = []
    for jax_side, check, mesh in ((True, j_check, jax_mesh),
                                  (False, halo.check_halo_support,
                                   port_mesh)):
        cfg, tc = _ok(jax_side)
        if model_kw is not None:
            cfg = _cfg(jax_side, **dict(model_kw))
        if train_kw is not None:
            tc = dataclasses.replace(tc, **train_kw)
        with pytest.raises(ValueError, match=fragment) as err:
            check(cfg, tc, mesh)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_support_matrix_needs_a_seq_axis_and_passes_v1():
    port_mesh, _ = _meshes()
    cfg, tc = _ok(False)
    halo.check_halo_support(cfg, tc, port_mesh)
    halo.check_halo_support(raft_v1(),
                            dataclasses.replace(tc, freeze_bn=True),
                            port_mesh)
    world = World(0, 4, 0, torch.device("cpu"), "gloo", 4)
    for mesh in (None, world, FsdpMesh(world, 2, 2)):
        with pytest.raises(ValueError, match="'seq' axis"):
            halo.check_halo_support(cfg, tc, mesh)
        with pytest.raises(ValueError, match="'seq' axis"):
            make_train_step(cfg, tc, mesh=mesh, compute_sharding="halo")
        with pytest.raises(ValueError, match="'seq' axis"):
            make_eval_step(RAFT(cfg), device="cpu", mesh=mesh,
                           compute_sharding="halo")


def test_fence_step_on_a_seq_mesh_is_refused_naming_a12_2b():
    """A12.2b is ported (tests/test_torch_fence_seq.py): the fence step
    on a seq mesh builds for v1, and what stays refused is v4/v5's
    embedded DexiNed, naming ROADMAP A12.2c."""
    port_mesh, _ = _meshes()
    cfg, tc = _ok(False)
    assert callable(make_train_step(cfg, tc, mesh=port_mesh))
    with pytest.raises(ValueError, match="A12.2c, DexiNed on row slabs"):
        make_train_step(_cfg(False, variant="v5", small=True), tc,
                        mesh=port_mesh)
    with pytest.raises(ValueError, match="adaptive=True"):
        make_eval_step(RAFT(cfg), device="cpu", mesh=port_mesh,
                       compute_sharding="halo", adaptive=True)


# ---- (d) the padder ----------------------------------------------------


@pytest.mark.parametrize("shape, seq, want", [
    ((1, 44, 60, 3), 2, (48, 64)), ((1, 48, 64, 3), 2, (48, 64)),
    ((1, 44, 60, 3), 1, (48, 64)), ((1, 436, 1024, 3), 2, (448, 1024)),
    ((1, 375, 1242, 3), 4, (384, 1248))])
def test_padder_aligns_height_to_stride_times_seq_as_jax(shape, seq, want):
    from dexiraft_tpu.data.padder import InputPadder as JInputPadder

    got = InputPadder(shape, seq=seq)
    assert got.padded_shape == JInputPadder(shape, seq=seq).padded_shape \
        == want
    x = np.random.default_rng(0).uniform(size=shape).astype(np.float32)
    assert np.array_equal(got.unpad(got.pad(x)[0]), x)


def test_padder_refuses_bad_seq_and_unaligned_buckets():
    with pytest.raises(ValueError, match="seq"):
        InputPadder((1, 48, 64, 3), seq=0)
    with pytest.raises(ValueError, match="stride\\*seq"):
        InputPadder((1, 40, 64, 3), target=(40, 64), seq=2)


# ---- (e) context-parallel correlation ----------------------------------


def _unsharded_lookup():
    c = context_inputs()
    pyr = build_corr_pyramid(torch.from_numpy(c["f1"]),
                             torch.from_numpy(c["f2"]), CTX_LEVELS,
                             CTX_RADIUS)
    return corr_lookup(pyr, torch.from_numpy(c["coords"]))


def _jax_lookup(kind):
    import jax
    import jax.numpy as jnp

    from dexiraft_tpu.parallel import context as jcontext
    from dexiraft_tpu.parallel.layout import make_mesh_2d

    c = context_inputs()
    fn = {"context": jcontext.context_parallel_corr,
          "ring": jcontext.ring_corr_lookup}[kind]
    mesh = make_mesh_2d(1, 2)
    out = jax.jit(lambda a, b, co: fn(a, b, co, mesh, num_levels=CTX_LEVELS,
                                      radius=CTX_RADIUS))(
        jnp.asarray(c["f1"]), jnp.asarray(c["f2"]), jnp.asarray(c["coords"]))
    return np.asarray(jax.device_get(out))


@pytest.mark.parametrize("kind", ["context", "ring"])
def test_context_parallel_lookup_equals_unsharded_and_jax(runs, kind):
    want = _jax_lookup(kind)
    got = torch.cat([rec[kind] for rec in runs[2].results(2)], dim=1)
    torch.testing.assert_close(got, _unsharded_lookup(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_ring_lookup_refuses_unaligned_blocks_with_jax_message():
    import jax.numpy as jnp

    from dexiraft_tpu.parallel.context import ring_corr_lookup as j_ring
    from dexiraft_tpu.parallel.context import context_parallel_corr as j_ctx
    from dexiraft_tpu.parallel.layout import make_mesh, make_mesh_2d
    from dexiraft_tpu_torch.parallel import context

    f = np.zeros((1, 12, 8, 4), np.float32)
    c = np.zeros((1, 12, 8, 2), np.float32)
    with pytest.raises(ValueError) as jerr:
        j_ring(jnp.asarray(f), jnp.asarray(f), jnp.asarray(c),
               make_mesh_2d(1, 2), num_levels=3)
    half = torch.zeros(1, 6, 8, 4)
    with pytest.raises(ValueError) as err:
        context.ring_corr_lookup(half, half, torch.zeros(1, 6, 8, 2),
                                 MeshAxis(0, 2), num_levels=3)
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="'seq' axis"):
        j_ctx(jnp.asarray(f), jnp.asarray(f), jnp.asarray(c), make_mesh())
    with pytest.raises(ValueError, match="'seq' axis"):
        context.context_parallel_corr(half, half, half, None)


# ---- the mesh ----------------------------------------------------------


@pytest.mark.parametrize("world", list(LAYOUTS))
def test_seq_is_the_innermost_axis(runs, world):
    """rank r: seq index r % 2, fsdp index r // 2 (JAX's make_mesh_fsdp
    placement)."""
    ranks = runs[2].results(world)
    assert [rec["mesh"] for rec in ranks] == [
        [0, r // 2 % LAYOUTS[world], r % 2] for r in range(world)]


# ---- (f) against JAX's halo step ---------------------------------------


@pytest.mark.parametrize("world", list(LAYOUTS))
def test_halo_gradients_within_jax_halo_step_bounds(runs, jax_grads, world):
    jloss, jgrads = jax_grads[world]
    for rec in runs[2].results(world):
        assert rec["grad"]["loss"] == pytest.approx(jloss, rel=1e-4)
        _close(_grads(rec), jgrads, 3e-3, 3e-5, f"jax halo, {world} ranks",
               counters=False)


# ---- (g) against the port's one-process step ---------------------------


@pytest.mark.parametrize("world", list(LAYOUTS))
def test_halo_gradients_equal_the_one_process_gradient(runs, one_process,
                                                       world):
    """Every rank holds the whole gradient of the global loss (the sum of
    the ranks' shares) at JAX's fence-halo bounds; twice it (a gradient
    counted once per seq rank) does not pass."""
    ref = one_process["grads"]
    for rec in runs[2].results(world):
        assert rec["grad"]["loss"] == pytest.approx(one_process["loss"],
                                                    rel=1e-3, abs=1e-4)
        _close(_grads(rec), ref, 1e-3, 1e-4, f"{world} ranks")
        doubled = {k: 2 * v for k, v in _grads(rec).items()}
        with pytest.raises(AssertionError):
            _close(doubled, ref, 1e-3, 1e-4, "doubled")
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in ref.values()]))
        assert rec["grad"]["norm"] == pytest.approx(float(norm), rel=1e-4)


def test_halo_remat_gradient_equals_the_stored_one_to_the_bit(runs):
    """``remat="per_iter"`` recomputes each iteration in the backward: the
    same gradient bit for bit, as the model's remat, with the
    update block run twice an iteration (forward and recompute)."""
    for rec in runs[2].results(2):
        assert rec["remat_update_calls"] == 2 * ITERS
        assert rec["grad_remat"].keys() == _grads(rec).keys()
        for k, g in _grads(rec).items():
            assert torch.equal(rec["grad_remat"][k], g), k


@pytest.mark.parametrize("world", list(LAYOUTS))
def test_halo_steps_track_the_one_process_steps(runs, one_process, world):
    ranks = runs[2].results(world)
    for rec in ranks:
        assert len(rec["metrics"]) == STEPS
        for g, ref in zip(rec["metrics"], one_process["metrics"]):
            for k in ("loss", "epe"):
                assert g[k] == pytest.approx(ref[k], rel=1e-3, abs=1e-4), k
            assert g["lr"] == ref["lr"]
            assert g["state_finite"] == 1.0
        _close(rec["state_dict"], one_process["state_dict"], 1e-3, 1e-4,
               f"{world} ranks after {STEPS} steps")
        assert rec["metrics"] == ranks[0]["metrics"]


def test_fsdp_inside_halo_stores_the_state_sharded(runs):
    for rec in runs[2].results(4):
        held = rec["bytes"]
        assert held["held"] < 0.75 * held["full"], held
        assert held["resident_sharded"] == 0, held


# ---- (h) eval ----------------------------------------------------------


@pytest.mark.parametrize("world", list(LAYOUTS))
def test_halo_eval_within_a_thousandth_px_of_the_unsharded_forward(
        runs, one_process, world):
    low, up = one_process["eval"]
    for rec in runs[2].results(world):
        got_low, got_up = rec["eval"]
        assert got_low.shape == low.shape and got_up.shape == up.shape
        assert float((got_low - low).abs().max()) < 1e-3
        assert float((got_up - up).abs().max()) < 1e-3

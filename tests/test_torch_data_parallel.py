"""Data-parallel inference in the port: the serve mesh, the mesh steps, the
engine over a mesh and ``--data_parallel`` in the eval and serve CLIs, on
the CPU.

The mesh's entries are CPU entries (``make_serve_mesh(devices=("cpu",) * n)``,
the counterpart of the JAX suite's 8 forced host devices). Models: v1
small on the main path (``corr_impl="flash", fused_update=True``: B1's
plain version on the CPU), 2 iterations, frames of a few dozen pixels.
Held:

  * the mesh eval step (fixed and adaptive), encode and refine steps on 2
    and 8 entries against the one-device steps, per row, atol 1e-5 (an
    entry's batch is smaller, and the CPU's convolutions round a little
    differently per batch size);
  * the mesh step and the sharded engine against JAX's
    ``make_eval_step(mesh=make_serve_mesh(2))`` and its sharded engine on
    the bridged weights, at docs/parity.md's v1 row (rtol 5e-3, atol 1e-4
    px); JAX runs ``test_zserve_engine.py``'s ``small_eval``
    configuration, jitted;
  * the sharded engine against the single one (JAX's own test, atol
    1e-4) and a v5 engine on 2 entries against one device (rtol 1e-2);
  * ``eval --data_parallel 2`` and ``serve --data_parallel 2``
    against their one-device runs.
"""

import dataclasses
import os
import re
import types
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexiraft_tpu.config import raft_v1 as j_raft_v1
from dexiraft_tpu.parallel.mesh import make_serve_mesh as j_make_serve_mesh
from dexiraft_tpu.serve.engine import InferenceEngine as JEngine
from dexiraft_tpu.serve.engine import ServeConfig as JServeConfig
from dexiraft_tpu.train.step import make_eval_step as j_make_eval_step
from dexiraft_tpu_torch import eval_cli, serve_cli
from dexiraft_tpu_torch.config import raft_v1, raft_v5
from dexiraft_tpu_torch.data.synthetic import write_chairs_tree
from dexiraft_tpu_torch.interop.jax_weights import raft_state_dict_from_jax
from dexiraft_tpu_torch.models.raft import RAFT, create_model
from dexiraft_tpu_torch.parallel.distributed import World
from dexiraft_tpu_torch.parallel.layout import (RowShards, batch_putter,
                                                check_serve_mesh,
                                                make_serve_mesh,
                                                replicate, row_blocks,
                                                shard_batch, virtual_mesh)
from dexiraft_tpu_torch.serve.engine import InferenceEngine, ServeConfig
from dexiraft_tpu_torch.serve.server import decode_response, encode_request
from dexiraft_tpu_torch.train.step import (make_encode_step, make_eval_step,
                                           make_refine_step)
from test_torch_raft import _variables
from test_torch_train_ops import few_torch_threads  # noqa: F401

ITERS = 2
V1 = dict(small=True, corr_impl="flash", fused_update=True)
ROW_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _two_threads(few_torch_threads):  # noqa: F811
    """2 torch threads: the suite runs 6 workers at once on 8 cores."""
    yield


def _cpu_mesh(n):
    return make_serve_mesh(devices=("cpu",) * n)


def _batch(b, h, w, seed):
    rng = np.random.default_rng(seed)
    im1 = rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)
    im2 = np.clip(np.roll(im1, 2, axis=2) + rng.normal(0, 4, im1.shape),
                  0, 255).astype(np.float32)
    return im1, im2


def _items(shapes, seed):
    out = []
    for k, (h, w) in enumerate(shapes):
        im1, im2 = _batch(1, h, w, seed + k)
        out.append({"image1": im1[0], "image2": im2[0]})
    return out


@pytest.fixture(scope="module")
def v1_model():
    return create_model(raft_v1(**V1), seed=3, device="cpu")


# ---- the serve mesh ---------------------------------------------------------


def test_serve_mesh_replicate_and_shard_batch(v1_model):
    mesh = make_serve_mesh(devices=("cpu",) * 8)
    assert mesh.size == 8 and mesh.axes == {"data": 8} and not mesh.is_cuda
    assert make_serve_mesh(2, devices=("cpu",) * 8).size == 2
    for n in (0, 9):  # JAX's range refusal
        with pytest.raises(ValueError, match=f"n_chips {n} out of range "
                                             "1..8"):
            make_serve_mesh(n, devices=("cpu",) * 8)
    assert _cpu_mesh(3).devices == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="at least one device"):
        _cpu_mesh(0)
    # a CUDA entry that is not there raises; nothing falls back to the CPU
    with pytest.raises(RuntimeError, match="cuda"):
        make_serve_mesh(devices=(f"cuda:{torch.cuda.device_count()}",))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_serve_mesh(2)
    # train meshes are no serve mesh
    for bad in (object(), virtual_mesh(0, 2, 1),
                World(0, 1, 0, torch.device("cpu"), "gloo")):
        with pytest.raises(TypeError, match="is no ServeMesh"):
            check_serve_mesh(bad)

    # the first entry on the source's device takes the source itself (no
    # second copy there); every other entry a copy equal to the bit
    src_model = RAFT(v1_model.cfg)
    src_model.load_state_dict(v1_model.state_dict())
    reps = replicate(src_model, _cpu_mesh(3))
    assert len(reps) == 3 and reps[0] is src_model
    assert reps[1] is not reps[2] and src_model not in reps[1:]
    src = src_model.state_dict()
    for j, rep in enumerate(reps):
        assert not rep.training
        got = rep.state_dict()
        assert got.keys() == src.keys()
        for k, v in src.items():
            assert torch.equal(got[k], v), k
            assert (got[k].data_ptr() == v.data_ptr()) == (j == 0), k

    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    sh = shard_batch(x, _cpu_mesh(4))
    assert isinstance(sh, RowShards) and sh.rows == row_blocks(8, 4)
    assert sh.shape == (8, 3) and len(sh) == 8
    for (a, b), s in zip(sh.rows, sh.shards):
        np.testing.assert_array_equal(s.numpy(), x[a:b])
    np.testing.assert_array_equal(sh.fetch(), x)
    both = batch_putter(_cpu_mesh(2))({"a": x, "b": None})
    assert both["b"] is None and both["a"].rows == ((0, 4), (4, 8))
    assert batch_putter(None)(x) is x
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(x[:3], _cpu_mesh(2))


# ---- the mesh steps against the one-device steps ----------------------------


def _rows_close(got, want, atol=ROW_ATOL):
    got = got.fetch() if isinstance(got, RowShards) else got
    want = want.numpy() if isinstance(want, torch.Tensor) else want
    assert got.shape == want.shape
    for row in range(want.shape[0]):
        np.testing.assert_allclose(got[row], want[row], rtol=0, atol=atol)


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("n", [2, 8])
def test_mesh_eval_step_equals_one_device(v1_model, n, adaptive):
    im1, im2 = _batch(8, 32, 48, seed=n)
    fi = np.random.default_rng(5).normal(0, 1, (8, 4, 6, 2)).astype(
        np.float32)
    model = v1_model
    if adaptive:
        # a tolerance between the rows' deltas: some rows freeze early,
        # so a shard's loop can end before the whole batch's
        probe = make_eval_step(model, iters=3, device="cpu", adaptive=True)
        delta = probe(im1, im2, fi)[3].numpy()
        model = RAFT(dataclasses.replace(
            model.cfg, converge_tol=float(np.median(delta))))
        model.load_state_dict(v1_model.state_dict())
        iters = 3
    else:
        iters = ITERS
    one = make_eval_step(model, iters=iters, device="cpu", adaptive=adaptive)
    mesh = _cpu_mesh(n)
    step = make_eval_step(model, iters=iters, mesh=mesh, adaptive=adaptive)
    args = (im1, im2, fi) + ((None,) if adaptive else ())
    want, got = one(*args), step(*args)
    assert all(isinstance(g, RowShards) and g.rows == row_blocks(8, n)
               for g in got)
    for g, w in zip(got, want):
        _rows_close(g, w)
    if adaptive:
        used = got[2].fetch()
        np.testing.assert_array_equal(used, want[2].numpy())
        assert len(set(used.tolist())) > 1  # rows froze at different steps
        # one budget for every shard
        capped = step(im1, im2, fi, 1)
        assert (capped[2].fetch() <= 1).all()
        _rows_close(capped[1], one(im1, im2, fi, 1)[1])
    # the batch may come already sharded (the engine's batch_putter)
    again = step(shard_batch(im1, mesh), shard_batch(im2, mesh),
                 shard_batch(fi, mesh), *args[3:])
    _rows_close(again[1], want[1])
    with pytest.raises(ValueError, match="not divisible"):
        step(im1[:n - 1], im2[:n - 1])


def test_mesh_encode_refine_equal_one_device_and_compose(v1_model):
    im1, im2 = _batch(4, 32, 48, seed=9)
    mesh = _cpu_mesh(2)
    reps = replicate(v1_model, mesh)  # steps share one set of replicas
    enc, ref = make_encode_step(reps, mesh=mesh), make_refine_step(
        reps, ITERS, mesh=mesh)
    enc1 = make_encode_step(v1_model, device="cpu")
    ref1 = make_refine_step(v1_model, ITERS, device="cpu")
    f1, f2 = enc(im1), enc(im2)
    g1, g2 = enc1(im1), enc1(im2)
    assert f1.keys() == g1.keys() == {"fmap", "ctx"}
    for k in f1:
        _rows_close(f1[k], g1[k])
    low, up = ref(f1, f2)
    low1, up1 = ref1(g1, g2)
    _rows_close(low, low1)
    _rows_close(up, up1)
    # composed, the eval step's flow
    elow, eup = make_eval_step(reps, ITERS, mesh=mesh)(im1, im2)
    _rows_close(low, elow.fetch())
    _rows_close(up, eup.fetch())
    with pytest.raises(ValueError, match="do not match the mesh"):
        make_eval_step(reps, ITERS, mesh=_cpu_mesh(3))


def test_fence_eval_step_on_a_seq_mesh_stays_refused(v1_model):
    """On a seq mesh the fence eval step is the row-sharded one
    (tests/test_torch_fence_seq.py runs it): v1 builds, and only v4/v5
    stay refused, naming ROADMAP A12.2c."""
    assert callable(make_eval_step(v1_model, ITERS, device="cpu",
                                   mesh=virtual_mesh(0, 1, 1, 2)))
    with pytest.raises(ValueError, match="A12.2c"):
        make_eval_step(RAFT(raft_v5(small=True)), ITERS, device="cpu",
                       mesh=virtual_mesh(0, 1, 1, 2))
    with pytest.raises(TypeError, match="is no ServeMesh"):
        make_eval_step(v1_model, ITERS, mesh=virtual_mesh(0, 2, 1))


# ---- against JAX's data-parallel step and engine ----------------------------


@pytest.fixture(scope="module")
def jax_pair():
    """JAX's small_eval configuration (test_zserve_engine.py) on seeded
    variables, its mesh step on make_serve_mesh(2), and the port's model
    on the bridged weights (the main path's config)."""
    variables = _variables(True, 2)
    mesh = j_make_serve_mesh(2)
    j_step = j_make_eval_step(j_raft_v1(small=True), iters=ITERS, mesh=mesh)
    model = RAFT(raft_v1(**V1))
    model.load_state_dict(raft_state_dict_from_jax(variables, small=True),
                          strict=True)
    return types.SimpleNamespace(
        mesh=mesh, variables=variables, model=model,
        fn=lambda a, b, fi: j_step(variables, jnp.asarray(a),
                                   jnp.asarray(b), None, None,
                                   None if fi is None else jnp.asarray(fi)))


def test_mesh_step_equals_jax_data_parallel_step(jax_pair):
    im1, im2 = _batch(2, 40, 56, seed=11)
    j_low, j_up = jax_pair.fn(im1, im2, None)
    assert len(j_up.sharding.device_set) == 2
    low, up = make_eval_step(jax_pair.model, ITERS, mesh=_cpu_mesh(2))(
        im1, im2)
    np.testing.assert_allclose(low.fetch(), np.asarray(j_low), rtol=5e-3,
                               atol=1e-4)
    np.testing.assert_allclose(up.fetch(), np.asarray(j_up), rtol=5e-3,
                               atol=1e-4)


def test_sharded_engine_equals_jax_sharded_engine(jax_pair):
    items = _items([(37, 53)] * 3, seed=2)
    j_engine = JEngine(jax_pair.fn, JServeConfig(batch_size=2),
                       mesh=jax_pair.mesh)
    mesh = _cpu_mesh(2)
    engine = InferenceEngine(
        make_eval_step(jax_pair.model, ITERS, mesh=mesh),
        ServeConfig(batch_size=2), mesh=mesh)
    want = {r.index: r.flow_up for r in j_engine.stream(dict(it)
                                                         for it in items)}
    got = {r.index: r.flow_up for r in engine.stream(dict(it)
                                                     for it in items)}
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for i in want:
        np.testing.assert_allclose(got[i], want[i], rtol=5e-3, atol=1e-4)


# ---- the engine over a mesh -------------------------------------------------


def test_data_parallel_engine_matches_single_chip(v1_model):
    """JAX's test_zserve_engine.py test of the same name: batch sharded
    over 'data', per-item results identical."""
    mesh = _cpu_mesh(2)
    items = _items([(37, 53)] * 3, seed=2)
    single = InferenceEngine(make_eval_step(v1_model, ITERS, device="cpu"),
                             ServeConfig(batch_size=2))
    sharded = InferenceEngine(make_eval_step(v1_model, ITERS, mesh=mesh),
                              ServeConfig(batch_size=2), mesh=mesh)
    assert sharded.device == torch.device("cpu") and sharded.mesh is mesh
    ref = {r.index: r for r in single.stream(dict(it) for it in items)}
    got = {r.index: r for r in sharded.stream(dict(it) for it in items)}
    for i in ref:
        np.testing.assert_allclose(got[i].flow_up, ref[i].flow_up, atol=1e-4)
        np.testing.assert_allclose(got[i].flow_low, ref[i].flow_low,
                                   atol=1e-4)
    assert sharded.stats.batches == 2 and sharded.stats.pad_frames == 1
    # warm start rides the host carry
    warm = InferenceEngine(make_eval_step(v1_model, ITERS, mesh=mesh),
                           ServeConfig(batch_size=2, warm_start=True),
                           mesh=mesh)
    (r,) = warm.run_batch([dict(items[0], flow_init=got[0].flow_low)])
    (s,) = InferenceEngine(
        make_eval_step(v1_model, ITERS, device="cpu"),
        ServeConfig(batch_size=2, warm_start=True)).run_batch(
        [dict(items[0], flow_init=got[0].flow_low)])
    np.testing.assert_allclose(r.flow_up, s.flow_up, atol=1e-4)
    assert warm.stats.carry_h2d_bytes == got[0].flow_low.nbytes


def test_engine_rejects_indivisible_mesh_batch(v1_model):
    step = make_eval_step(v1_model, ITERS, mesh=_cpu_mesh(2))
    with pytest.raises(ValueError, match="divisible"):
        InferenceEngine(step, ServeConfig(batch_size=3), mesh=_cpu_mesh(2))
    with pytest.raises(ValueError, match="device_carry"):
        InferenceEngine(step, ServeConfig(batch_size=2, device_carry=True),
                        mesh=_cpu_mesh(2))
    with pytest.raises(ValueError, match="not both"):
        InferenceEngine(step, ServeConfig(batch_size=2), mesh=_cpu_mesh(2),
                        device="cpu")


def test_v5_engine_on_two_entries_matches_one_device():
    model = create_model(raft_v5(corr_impl="flash", fused_update=True),
                         seed=0, device="cpu")
    items = _items([(32, 48)] * 2, seed=4)
    mesh = _cpu_mesh(2)
    one = InferenceEngine(make_eval_step(model, ITERS, device="cpu"),
                          ServeConfig(batch_size=2))
    two = InferenceEngine(make_eval_step(model, ITERS, mesh=mesh),
                          ServeConfig(batch_size=2), mesh=mesh)
    want = sorted(one.stream(dict(it) for it in items), key=lambda r: r.index)
    got = sorted(two.stream(dict(it) for it in items), key=lambda r: r.index)
    for g, w in zip(got, want):
        assert np.isfinite(g.flow_up).all()
        np.testing.assert_allclose(g.flow_up, w.flow_up, rtol=1e-2,
                                   atol=1e-4)


# ---- the CLIs -----------------------------------------------------------------


@pytest.fixture(scope="module")
def chairs(tmp_path_factory, v1_model):
    root = str(tmp_path_factory.mktemp("dp_chairs"))
    write_chairs_tree(root, n_train=0, n_val=4, hw=(48, 64), seed=6)
    weights = os.path.join(root, "v1_small.pth")
    torch.save(v1_model.state_dict(), weights)
    return types.SimpleNamespace(root=root, weights=weights)


def _eval(chairs, capsys, monkeypatch, *flags):
    monkeypatch.setenv("DEXIRAFT_DATA_DIR", chairs.root)
    eval_cli.main(["--device", "cpu", "--small", "--corr_impl", "flash",
                   "--fused_update", "--model", chairs.weights, "--iters",
                   "2", "--dataset", "chairs"] + list(flags))
    return capsys.readouterr().out


def _epe(out):
    return [float(x) for x in re.findall(r"EPE: (-?\d+\.\d+)", out)]


def test_eval_cli_data_parallel_equals_default(chairs, capsys, monkeypatch):
    """--data_parallel 2 --batch_size 2 (with --strict too) prints the
    default run's metrics; a batch the mesh does not divide is refused."""
    base = _eval(chairs, capsys, monkeypatch)
    dp = _eval(chairs, capsys, monkeypatch, "--data_parallel", "2",
               "--batch_size", "2")
    strict = _eval(chairs, capsys, monkeypatch, "--data_parallel", "2",
                   "--batch_size", "2", "--strict")
    assert "data-parallel over 2 entries: cpu, cpu" in dp
    assert "engine:" in dp and "engine:" not in base
    assert _epe(base) and _epe(dp) == _epe(base) == _epe(strict)
    with pytest.raises(SystemExit, match="must divide by --data_parallel"):
        _eval(chairs, capsys, monkeypatch, "--batch_size", "3",
              "--data_parallel", "2")


def _serve_answers(monkeypatch, capsys, *flags):
    """serve_cli.main with its builders, a FlowService on port 0 asked for
    two pairs and one warm session request (three chained frames), then
    drained; -> (answers, engine, video, printed)."""
    seen = {}

    def run(args, cfg, dev, engine, service, sessions_on):
        service.start()
        try:
            answers = []
            frames = _items([(40, 56)] * 3, seed=21)
            for k, it in enumerate(frames[:2]):
                answers.append(_post(service.url, it["image1"],
                                     it["image2"]))
            for k in range(2):  # the session: frame k -> k + 1
                answers.append(_post(service.url, frames[k]["image1"],
                                     frames[k + 1]["image1"], session="s"))
        finally:
            service.drain_and_stop(timeout=30)
        seen.update(answers=answers, engine=engine, video=service.video)

    monkeypatch.setattr(serve_cli, "_run_service", run)
    serve_cli.main(["--cpu", "--small", "--synthetic_init", "--iters", "2",
                    "--port", "0", "--batch_size", "2", "--slo_ms", "50",
                    "--corr_impl", "flash", "--fused_update"] + list(flags))
    return seen, capsys.readouterr().out


def _post(url, im1, im2, session=None):
    headers = {} if session is None else {"X-Session-Id": session}
    req = urllib.request.Request(url + "/v1/flow",
                                 data=encode_request(im1, im2),
                                 headers=headers)
    with urllib.request.urlopen(req, timeout=60) as r:
        return (decode_response(r.read()), r.headers.get("X-Warm-Start"))


def test_serve_cli_data_parallel_answers_as_one_device(monkeypatch, capsys):
    one, _ = _serve_answers(monkeypatch, capsys)
    dp, printed = _serve_answers(monkeypatch, capsys, "--data_parallel", "2")
    assert "[serve] data-parallel over 2 entries: cpu, cpu" in printed
    assert ("[serve] streaming endpoint disabled: --data_parallel "
            "(batch-1 chunks do not shard)") in printed
    assert dp["video"] is None and one["video"] is not None
    assert one["engine"].config.device_carry
    assert not dp["engine"].config.device_carry  # host carry, forced
    assert dp["engine"].mesh.size == 2
    assert [w for _, w in dp["answers"]] == [w for _, w in one["answers"]] \
        == ["0", "0", "0", "1"]
    for (a, _), (b, _) in zip(dp["answers"], one["answers"]):
        assert a.shape == (40, 56, 2) and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=1e-4)

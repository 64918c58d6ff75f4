"""The port's standalone DexiNed workload against the JAX package's.

- Losses: every loss of ``dexined/losses.py`` and its gradient with
  respect to the logits, on numpy-seeded inputs whose targets mix 0, 1,
  fractional annotations and don't-care 2s, at rtol 1e-5 (the same fp32
  elementwise arithmetic, summed in another order).
- CoFusion: a ``fusion="cofusion"`` tree through the port's bridge, leaf
  for leaf bitwise and strictly loaded, then the head at 1e-5.
- The train step: the train-mode forward, the multiscale loss and one
  AdamW step against the JAX CLI's step (``model.apply(..., train=True,
  mutable=["batch_stats"])`` and ``optax.adamw``) on the same weights and
  batch: the loss at rtol 1e-5, parameters and batch stats at rtol 1e-4.
  torch's own BatchNorm would put every running variance n/(n-1) off
  here (n = batch x pixels: 8 at the 2x2 deepest map).
- Data and metrics: the datasets' samples bit for bit (one seed, one
  sample), the metrics' counts and scores exactly.
- The CLI in-process on the CPU: train, then test, the file layout, the
  guard's rollback, and ``--stall_timeout`` accepted.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dexiraft_tpu.dexined.losses as jl
import dexiraft_tpu_torch.dexined.losses as tl
from dexiraft_tpu.dexined import data as jdata
from dexiraft_tpu.dexined import metrics as jmetrics
from dexiraft_tpu.models.dexined import CoFusion as JCoFusion
from dexiraft_tpu.models.dexined import DexiNed as JDexiNed
from dexiraft_tpu_torch import dexined_cli as cli
from dexiraft_tpu_torch.dexined import data as tdata
from dexiraft_tpu_torch.dexined import metrics as tmetrics
from dexiraft_tpu_torch.interop.jax_weights import dexined_state_dict_from_jax
from dexiraft_tpu_torch.models.dexined import PRE_BN_BIAS, DexiNed
from dexiraft_tpu_torch.train import checkpoint as ckpt_io
from test_torch_raft import _randomize


@pytest.fixture(autouse=True)
def few_torch_threads():
    """torch's CPU pool at 2 threads, restored after: the suite runs in
    several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


# ---- losses ---------------------------------------------------------------


def _loss_inputs(seed=0, shape=(2, 16, 16, 1)):
    """Logits ~ 2 N(0, 1); targets: 1 (10%), fractional 0.3 / 0.7 (5%
    each), don't-care 2 (5%), else 0."""
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal(shape)).astype(np.float32)
    u = rng.uniform(size=shape)
    t = np.zeros(shape, np.float32)
    t[u < 0.10] = 1.0
    t[(u >= 0.10) & (u < 0.15)] = 0.3
    t[(u >= 0.15) & (u < 0.20)] = 0.7
    t[(u >= 0.20) & (u < 0.25)] = 2.0
    return logits, t


LOSSES = {
    "bdcn_loss2": (lambda m: m.bdcn_loss2, {}),
    "hed_loss2": (lambda m: m.hed_loss2, {}),
    "bdcn_loss_ori": (lambda m: m.bdcn_loss_ori, {}),
    "rcf_loss": (lambda m: m.rcf_loss, {}),
    "cats_plain": (lambda m: m.cats_loss, {"l_weight": (0.0, 0.0)}),
    "cats_full": (lambda m: m.cats_loss, {"l_weight": (0.01, 4.0)}),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_and_grad_equal_jax(name):
    pick, kw = LOSSES[name]
    logits, t = _loss_inputs()
    j_fn = lambda x: pick(jl)(x, jnp.asarray(t), **kw)  # noqa: E731
    j_loss, j_grad = jax.value_and_grad(j_fn)(jnp.asarray(logits))

    x = _nchw(logits).requires_grad_(True)
    t_loss = pick(tl)(x, _nchw(t), **kw)
    t_loss.backward()
    t_loss = float(t_loss.detach())
    assert np.isfinite(t_loss) and t_loss > 0
    np.testing.assert_allclose(t_loss, float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(_nhwc(x.grad), np.asarray(j_grad),
                               rtol=1e-5, atol=1e-7)


def test_multiscale_loss_equal_jax():
    rng = np.random.default_rng(1)
    logits = [(2 * rng.standard_normal((2, 16, 16, 1))).astype(np.float32)
              for _ in range(7)]
    _, t = _loss_inputs(1)
    j = jl.weighted_multiscale_loss([jnp.asarray(p) for p in logits],
                                    jnp.asarray(t))
    ours = tl.weighted_multiscale_loss([_nchw(p) for p in logits], _nchw(t))
    np.testing.assert_allclose(float(ours), float(j), rtol=1e-5)
    assert tl.BDCN_SCALE_WEIGHTS == jl.BDCN_SCALE_WEIGHTS
    # the don't-care and fractional conventions: rcf weighs 2s at 0, and
    # bdcn_loss_ori gives fractional targets no weight
    assert float(tl.rcf_loss(torch.zeros(1, 1, 4, 4),
                             torch.full((1, 1, 4, 4), 2.0))) == 0.0
    assert float(tl.bdcn_loss_ori(_nchw(logits[0]),
                                  torch.full((2, 1, 16, 16), 0.5))) == 0.0


# ---- CoFusion through the bridge -----------------------------------------


@pytest.fixture(scope="module")
def dexined_shapes():
    """The abstract variables of the JAX DexiNed ("cat" head)."""
    img = jnp.zeros((1, 32, 32, 3), jnp.float32)
    return jax.eval_shape(lambda: JDexiNed().init(
        jax.random.PRNGKey(0), img, train=True))


@pytest.fixture(scope="module")
def cofusion_variables(dexined_shapes):
    """A ``fusion="cofusion"`` tree: the "cat" tree with its block_cat
    (SingleConvBlock_8) swapped for a CoFusion_0 head, every leaf seeded."""
    params = dict(dexined_shapes["params"])
    del params["SingleConvBlock_8"]
    params["CoFusion_0"] = jax.eval_shape(lambda: JCoFusion().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 6))))["params"]
    return _randomize({"params": params,
                       "batch_stats": dexined_shapes["batch_stats"]}, 5)


def test_cofusion_bridge_bitwise_and_forward(cofusion_variables):
    v = cofusion_variables
    sd = dexined_state_dict_from_jax(v)
    co = v["params"]["CoFusion_0"]
    for i, name in enumerate(("conv1", "conv2", "conv3")):
        k = np.asarray(co[f"Conv_{i}"]["kernel"]).transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(sd[f"block_cat.{name}.weight"], k)
        np.testing.assert_array_equal(sd[f"block_cat.{name}.bias"],
                                      np.asarray(co[f"Conv_{i}"]["bias"]))
    for i in (0, 1):
        g = co[f"GroupNorm_{i}"]
        np.testing.assert_array_equal(sd[f"block_cat.norm_layer{i + 1}.weight"],
                                      np.asarray(g["scale"]))
        np.testing.assert_array_equal(sd[f"block_cat.norm_layer{i + 1}.bias"],
                                      np.asarray(g["bias"]))
    model = DexiNed(fusion="cofusion")
    model.load_state_dict(sd, strict=True)
    model.eval()

    rng = np.random.default_rng(2)
    maps = rng.standard_normal((2, 24, 40, 6)).astype(np.float32)
    j_head = JCoFusion().apply({"params": co}, jnp.asarray(maps))
    with torch.no_grad():
        t_head = model.block_cat(_nchw(maps))
    # the head's output is a convex combination of O(1) maps: 1e-5 both
    # ways (measured: 1.3e-6 at most)
    np.testing.assert_allclose(_nhwc(t_head), np.asarray(j_head),
                               rtol=1e-5, atol=1e-5)

    with torch.no_grad():
        out = model(torch.zeros(1, 3, 32, 48))
    assert len(out) == 7 and out[-1].shape == (1, 1, 32, 48)
    with pytest.raises(ValueError, match="fusion"):
        DexiNed(fusion="sum")


# ---- one train step against the JAX CLI's ---------------------------------


@jax.jit
def _jax_step(variables, images, labels, lr, wd):
    """The JAX dexined_cli step (dexined_cli.py train()), returning the
    loss, the gradients and the state after the update."""
    model = JDexiNed()
    tx = optax.adamw(lr, weight_decay=wd)
    params, batch_stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)

    def loss_fn(p):
        preds, mut = model.apply({"params": p, "batch_stats": batch_stats},
                                 images, train=True, mutable=["batch_stats"])
        return jl.weighted_multiscale_loss(preds, labels), mut["batch_stats"]

    (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    updates, _ = tx.update(grads, opt_state, params)
    return loss, grads, optax.apply_updates(params, updates), new_stats


def test_train_step_equals_jax_cli_step(dexined_shapes):
    """One step on seeded weights and a 2x32x32 batch, lr 1e-3, wd 0.1.

    Adam's first update is lr * g / (|g| + eps): about lr times the sign
    of each element's gradient. Where a gradient is rounding noise (the
    pre-BatchNorm conv biases, elements near a zero crossing) the two
    packages' signs are independent, so the parameters after the step are
    held at rtol 1e-4 with atol 2 lr, the most two such updates can
    differ; the gradients behind them at rtol 1e-4 (atol 1e-5 of the
    largest), and the optimizer's arithmetic exactly: the port's
    parameters after the step equal ``optax.adamw`` applied to the port's
    own gradients, at rtol 1e-6. The batch stats have no such noise and
    are held at rtol 1e-4."""
    v = _randomize(dexined_shapes, 11)
    rng = np.random.default_rng(3)
    images = rng.uniform(-120, 130, (2, 32, 32, 3)).astype(np.float32)
    labels = np.clip(rng.uniform(-0.3, 1.3, (2, 32, 32, 1)), 0, 1).astype(
        np.float32)
    lr, wd = 1e-3, 0.1
    j_loss, j_grads, j_params, j_stats = _jax_step(
        v, jnp.asarray(images), jnp.asarray(labels), lr, wd)

    before = dexined_state_dict_from_jax(v)
    model = DexiNed()
    model.load_state_dict(before, strict=True)
    step = cli.make_train_step(model, cli.make_optimizer(model, lr, wd))
    loss, ok = step(_nchw(images), _nchw(labels))
    assert bool(ok)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)

    jg = dexined_state_dict_from_jax({"params": j_grads,
                                      "batch_stats": v["batch_stats"]})
    grads = {n: p.grad for n, p in model.named_parameters()}
    scale = max(float(g.abs().max()) for g in jg.values())
    for n, g in grads.items():
        # rounding noise, 1e-11 to 1e-6 here, in either package
        if PRE_BN_BIAS.match(n):
            assert float(g.abs().max()) < 1e-5 * scale, n
            assert float(jg[n].abs().max()) < 1e-5 * scale, n
        else:
            np.testing.assert_allclose(g.numpy(), jg[n].numpy(), rtol=1e-4,
                                       atol=1e-5 * scale, err_msg=n)

    after = dexined_state_dict_from_jax({"params": j_params,
                                         "batch_stats": j_stats})
    ours = model.state_dict()
    params = dict(model.named_parameters())
    for k, ref in after.items():
        if k.endswith("num_batches_tracked"):
            continue
        atol = 2 * lr if k in params else 1e-6
        np.testing.assert_allclose(ours[k].numpy(), ref.numpy(), rtol=1e-4,
                                   atol=atol, err_msg=k)
    # the running stats moved (train mode), the unused modules' did not;
    # side_5 (no gradient) was decayed, as optax decays every leaf
    assert not torch.equal(ours["block_1.bn1.running_var"],
                           before["block_1.bn1.running_var"])
    assert torch.equal(ours["side_5.bn.running_var"],
                       before["side_5.bn.running_var"])
    np.testing.assert_allclose(ours["side_5.conv.weight"].numpy(),
                               before["side_5.conv.weight"].numpy()
                               * (1 - lr * wd), rtol=1e-6)

    # the optimizer: optax.adamw on the port's own gradients
    tx = optax.adamw(lr, weight_decay=wd)

    @jax.jit
    def adamw(p, g):
        return optax.apply_updates(p, tx.update(g, tx.init(p), p)[0])

    expect = adamw({n: jnp.asarray(before[n].numpy()) for n in params},
                   {n: jnp.asarray(g.numpy()) for n, g in grads.items()})
    # torch rounds the bias corrections in another order (1 - 0.999 is
    # 1.3e-5 off in fp32): 1e-5 of the update, lr, on top of rtol 1e-6
    for n, p in expect.items():
        np.testing.assert_allclose(ours[n].numpy(), np.asarray(p), rtol=1e-6,
                                   atol=1e-5 * lr, err_msg=n)


# ---- datasets and metrics -------------------------------------------------


@pytest.fixture(scope="module")
def biped_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("biped")
    rng = np.random.default_rng(0)
    img_dir = root / "imgs" / "train" / "rgbr" / "aug" / "seq0"
    gt_dir = root / "edge_maps" / "train" / "rgbr" / "aug" / "seq0"
    img_dir.mkdir(parents=True)
    gt_dir.mkdir(parents=True)
    for i in range(3):
        cv2.imwrite(str(img_dir / f"{i}.jpg"),
                    rng.integers(0, 256, (300, 300, 3), dtype=np.uint8))
        cv2.imwrite(str(gt_dir / f"{i}.png"),
                    rng.integers(0, 256, (300, 300), dtype=np.uint8))
    return root


def test_datasets_equal_jax_bit_for_bit(biped_tree):
    assert tdata.DATASET_INFO == {k: tdata.EdgeDatasetInfo(**vars(v))
                                  for k, v in jdata.DATASET_INFO.items()}
    ours = tdata.BipedDataset(str(biped_tree), img_size=64)
    theirs = jdata.BipedDataset(str(biped_tree), img_size=64)
    assert ours.pairs == theirs.pairs
    crops = 0
    for i in range(3):
        for seed in range(4):
            a = ours.sample(i, np.random.default_rng((42, seed, i)))
            b = theirs.sample(i, np.random.default_rng((42, seed, i)))
            for k in ("images", "labels"):
                np.testing.assert_array_equal(a[k], b[k])
            crops += np.random.default_rng((42, seed, i)).random() >= 0.5
    assert 0 < crops < 12   # both branches (crop and plain resize) ran
    test_dir = biped_tree / "imgs" / "train" / "rgbr" / "aug" / "seq0"
    for h, w in ((None, None), (48, 80)):
        a = tdata.TestDataset(str(test_dir), h, w).sample(1)
        b = jdata.TestDataset(str(test_dir), h, w).sample(1)
        np.testing.assert_array_equal(a["images"], b["images"])
        assert (a["file_name"], a["image_shape"]) == (b["file_name"],
                                                      b["image_shape"])


@pytest.mark.parametrize("matching", ["assignment", "dilation"])
def test_metrics_equal_jax(matching):
    rng = np.random.default_rng(4)
    preds, gts = [], []
    for _ in range(3):
        gt = np.zeros((40, 56), bool)
        gt[rng.integers(0, 40, 30), rng.integers(0, 56, 30)] = True
        gt[20, 5:50] = True
        preds.append(np.clip(gt * 0.7 + 0.4 * rng.uniform(size=gt.shape),
                             0, 1).astype(np.float32))
        gts.append(gt)
    ours = [tmetrics.edge_counts(p, g, matching=matching)
            for p, g in zip(preds, gts)]
    theirs = [jmetrics.edge_counts(p, g, matching=matching)
              for p, g in zip(preds, gts)]
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert tmetrics.evaluate_from_counts(ours) == \
        jmetrics.evaluate_from_counts(theirs)
    assert tmetrics.evaluate_edges(preds, gts, matching=matching) == \
        jmetrics.evaluate_edges(preds, gts, matching=matching)


# ---- the CLI ------------------------------------------------------------


def _train_args(root, ckpt, *more, steps=2):
    return ["--train", "--data_root", str(root), "--batch_size", "2",
            "--img_size", "64", "--steps_per_epoch", str(steps),
            "--checkpoint", str(ckpt), "--device", "cpu", *more]


def test_cli_train_then_test_file_layout(biped_tree, tmp_path, capsys):
    ckpt = tmp_path / "ck"
    cli.main(_train_args(biped_tree, ckpt, "--epochs", "1", steps=1))
    assert ckpt_io.all_steps(str(ckpt)) == [1]
    payload = ckpt_io.load_payload(str(ckpt))
    assert payload["step"] == 1 and "exp_avg" in str(payload["optimizer"])

    # DCD's registry resolution (352x480) from a one-line test list
    img_dir = biped_tree / "imgs" / "train" / "rgbr" / "aug" / "seq0"
    test_root = tmp_path / "dcd"
    test_root.mkdir()
    (test_root / "test_pair.lst").write_text(f"{img_dir / '1.jpg'}\n")
    # a sparse edge map (the tree's labels are noise, half of them edges,
    # which the one-to-one matching would take minutes over)
    gt_dir = tmp_path / "gt"
    gt_dir.mkdir()
    gt = np.zeros((300, 300), np.uint8)
    gt[150, 20:280] = gt[40:260, 100] = 255
    cv2.imwrite(str(gt_dir / "1.png"), gt)
    out = tmp_path / "out"
    cli.main(["--test", "--test_pich", "--data_root", str(test_root),
              "--dataset", "DCD", "--checkpoint", str(ckpt), "--output_dir",
              str(out), "--gt_root", str(gt_dir), "--device", "cpu"])
    text = capsys.readouterr().out
    assert "1.jpg: " in text and "ms" in text and "ODS: " in text
    files = sorted(os.path.relpath(os.path.join(d, f), out)
                   for d, _, fs in os.walk(out) for f in fs)
    assert files == ["DCD/1.png", "DCD/avgCH/1.png", "DCD/fusedCH/1.png"]
    fused = cv2.imread(str(out / "DCD" / "fusedCH" / "1.png"),
                       cv2.IMREAD_GRAYSCALE)
    assert fused.shape == (300, 300)   # back at the source resolution


def test_cli_guard_rolls_back_then_aborts(biped_tree, tmp_path, monkeypatch):
    """Epoch 0 trains clean and checkpoints; the data is then poisoned, so
    epoch 1 rolls back to epoch 0's checkpoint and epoch 2 exhausts the
    budget. The poisoned epochs never reach disk."""
    ckpt = tmp_path / "ck"
    poisoned = {"on": False}
    orig_save = ckpt_io.save_checkpoint

    def save_then_poison(*a, **k):
        orig_save(*a, **k)
        poisoned["on"] = True

    monkeypatch.setattr(ckpt_io, "save_checkpoint", save_then_poison)
    orig_sample = tdata.BipedDataset.sample

    def sample(self, i, rng=None):
        s = orig_sample(self, i, rng)
        if poisoned["on"]:
            s = dict(s, images=np.full_like(s["images"], np.nan))
        return s

    monkeypatch.setattr(tdata.BipedDataset, "sample", sample)
    with pytest.raises(RuntimeError, match="diverged.*after 1 rollbacks"):
        cli.main(_train_args(biped_tree, ckpt, "--epochs", "4",
                             "--max_rollbacks", "1", steps=1))
    assert ckpt_io.all_steps(str(ckpt)) == [1]


def test_cli_refuses_stall_timeout_and_needs_a_mode(biped_tree, monkeypatch):
    """``--stall_timeout`` is ported (the hang watchdog) and no longer
    refused: it reaches the trainer; a run needs a mode."""
    seen = []
    monkeypatch.setattr(cli, "train", lambda args: seen.append(args))
    cli.main(_train_args(biped_tree, "unused", "--stall_timeout", "1"))
    assert seen[0].stall_timeout == 1.0
    with pytest.raises(SystemExit, match="--train or --test"):
        cli.main(["--data_root", str(biped_tree)])


def test_cli_train_arms_the_watchdog_from_step_2(biped_tree, tmp_path,
                                                 monkeypatch):
    """``--train --stall_timeout``: the hang watchdog runs over the loop,
    armed over every step but the first (cuDNN's searches) and disarmed
    after each, and is stopped with the loop. Its exit is injected, so a
    fire would be recorded rather than end the process."""
    from dexiraft_tpu_torch.resilience import watchdog

    events, exits = [], []

    class Recording(watchdog.HangWatchdog):
        def __init__(self, timeout_s, **kw):
            super().__init__(timeout_s, exit_fn=exits.append, **kw)
            events.append(("new", timeout_s))

        def arm(self, step, region="step", steady=True):
            events.append(("arm", step))
            super().arm(step, region, steady)

        def disarm(self, feed_ewma=True):
            events.append(("disarm", self._armed is not None))
            return super().disarm(feed_ewma)

        def stop(self):
            events.append(("stop", self._thread is not None))
            super().stop()
            events.append(("stopped", self._thread is None))

    monkeypatch.setattr(watchdog, "HangWatchdog", Recording)
    cli.main(_train_args(biped_tree, tmp_path / "ck", "--epochs", "1",
                         "--stall_timeout", "120"))
    assert events == [("new", 120.0), ("disarm", False),
                      ("arm", 2), ("disarm", True),
                      ("stop", True), ("stopped", True)]
    assert exits == []
    assert ckpt_io.all_steps(str(tmp_path / "ck")) == [2]

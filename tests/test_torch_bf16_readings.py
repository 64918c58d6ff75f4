"""The readings behind the mixed-precision tolerances, on the CPU
(``JAX_PLATFORMS=cpu python tests/test_torch_bf16_readings.py CMD``):

  modules
  model v1|v1_small|v5
  train
  card_forward v1|v5 [H W]
  card_train

``modules``, ``model`` and ``train`` print, over seeds 0-5, what
tests/test_torch_mixed_precision{,_model,_train}.py hold at one seed (the
tests' docstrings quote them). ``card_forward`` (default 128x256, 32
iterations, seeds 0-2) and ``card_train`` (v5 at 96x128, batch 2, 12
iterations, seeds 0-1) read JAX's own bf16 error at the weights
chip_smoke.py runs (``create_model(..., seed=0)``, carried into flax by
``dexiraft_tpu.interop.torch_convert``): chip_smoke.py's ``E_J_FLOW`` and
``E_J_TRAIN`` are their largest values. It defines no test, so pytest
collects nothing from it. Each line prints e_J = relL2(J16, J32) and the
port's distances as multiples of it.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

if __name__ == "__main__":  # pytest collects this file with its own path
    HERE = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [HERE, os.path.dirname(HERE)]

from dexiraft_tpu.config import raft_v1 as j_raft_v1  # noqa: E402
from dexiraft_tpu.config import raft_v5 as j_raft_v5  # noqa: E402
from dexiraft_tpu.interop.torch_convert import convert_raft_state_dict  # noqa: E402,E501
from dexiraft_tpu.models.raft import RAFT as JRAFT  # noqa: E402
from dexiraft_tpu.ops.losses import sequence_loss as j_sequence_loss  # noqa: E402,E501
from dexiraft_tpu_torch.config import TrainConfig, raft_v1, raft_v5  # noqa: E402,E501
from dexiraft_tpu_torch.interop.jax_weights import raft_state_dict_from_jax  # noqa: E402,E501
from dexiraft_tpu_torch.models.raft import RAFT, create_model  # noqa: E402
from dexiraft_tpu_torch.train.state import create_state  # noqa: E402
from dexiraft_tpu_torch.train.step import make_train_step  # noqa: E402


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def modules():
    import test_torch_mixed_precision as t
    os.environ.update(DEXIRAFT_PALLAS_INTERPRET="1",
                      DEXIRAFT_FLASH_PIXEL_BLOCK="128",
                      DEXIRAFT_FLASH_ROWS="8")
    v1, v5 = t.v1_models.__wrapped__(), t.v5_model.__wrapped__()
    for seed in range(6):
        outs = ([("small", *o) for o in t.small_block_outputs(v1, seed)]
                + [("basic", *o) for o in t.basic_block_outputs(
                    v1, seed, False)]
                + [("fused", *o) for o in t.basic_block_outputs(
                    v1, seed, True)]
                + [("dexined", *o[:3]) for o in t.dexined_outputs(
                    v5, seed)[:1]])
        for kind, name, ours, ref in outs:
            o, r = t._np(ours), t._np(ref)
            print(f"seed {seed} {kind} {name}: relL2 {rel(o, r):.2e}, max "
                  f"{np.abs(o - r).max() / np.abs(r).max():.2e} of max|JAX|")
        encs = [(spec, *t.encoder_outputs(v1, spec, seed),
                 t.encoder_outputs(v1, spec, seed, jnp.float32)[1])
                for spec in t._ENCODERS]
        encs.append((("v5", "efnet"),) + tuple(t.dexined_outputs(
            v5, seed)[1][1:]))
        for spec, ours, ref, ref32 in encs:
            o, r, r32 = t._np(ours), t._np(ref), t._np(ref32)
            e = rel(r, r32)
            print(f"seed {seed} {spec[1]}: relL2 {rel(o, r):.2e}, e_J "
                  f"{e:.2e}, from fp32 {rel(o, r32) / e:.3f} e_J")


def model(name):
    import test_torch_mixed_precision_model as t
    for seed in range(6):
        out = t.forwards(name, seed)
        for k, label in enumerate(("flow_low", "flow_up")):
            j32, j16, p32, p16 = (out[x][k] for x in
                                  ("J32", "J16", "P32", "P16"))
            e = rel(j16, j32)
            print(f"{name} seed {seed} {label}: e_J {e:.3e}, P16-J32 "
                  f"{rel(p16, j32) / e:.3f} e_J, P16-J16 "
                  f"{rel(p16, j16) / e:.3f} e_J, P16-P32 "
                  f"{rel(p16, p32) / e:.3f} e_J, max px P16-J16 "
                  f"{np.abs(p16 - j16).max():.3g}")


def jax_grads(jcfg, variables, batch, iters):
    jb = {k: jnp.asarray(np.asarray(v)) for k, v in batch.items()}
    m = JRAFT(jcfg)
    stats = variables.get("batch_stats", {})

    def loss_fn(p):
        out, _ = m.apply({"params": p, "batch_stats": stats}, jb["image1"],
                         jb["image2"], iters=iters, train=True,
                         mutable=["batch_stats"],
                         rngs={"dropout": jax.random.PRNGKey(0)})
        return j_sequence_loss(out.astype(jnp.float32), jb["flow"],
                               jb["valid"], 0.8)[0]

    loss, g = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    return float(loss), g


def port_grads(cfg, tc, sd, batch):
    m = RAFT(dataclasses.replace(cfg, mixed_precision=tc.precision == "bf16"))
    m.load_state_dict(sd, strict=True)
    state = create_state(cfg, tc, device="cpu", model=m)
    state, metrics = make_train_step(cfg, tc)(state, batch)
    return float(metrics["loss"]), {
        n: p.grad.numpy() for n, p in state.model.named_parameters()
        if p.grad is not None}  # the frozen DexiNed has none


def print_train(tag, res, names):
    flat = {k: np.concatenate([r[1][n].reshape(-1) for n in names])
            for k, r in res.items()}
    loss = {k: r[0] for k, r in res.items()}
    e = abs(loss["J16"] - loss["J32"]) / abs(loss["J32"])
    print(f"{tag} loss: e_J {e:.2e}, P16-J32 "
          f"{abs(loss['P16'] - loss['J32']) / abs(loss['J32']):.2e}, P16-J16 "
          f"{abs(loss['P16'] - loss['J16']) / abs(loss['J32']):.2e}")
    e = rel(flat["J16"], flat["J32"])
    print(f"{tag} gradients: e_J {e:.3e}, P16-J32 "
          f"{rel(flat['P16'], flat['J32']) / e:.3f} e_J, P16-J16 "
          f"{rel(flat['P16'], flat['J16']) / e:.3f} e_J")
    gmax = np.abs(flat["J32"]).max()
    worst = (0.0, 0.0, None)
    for n in names:
        ref = res["J32"][1][n]
        if np.abs(ref).max() <= 1e-3 * gmax:
            continue
        e = max(rel(res["J16"][1][n], ref), 2.0 ** -9)
        a = rel(res["P16"][1][n], ref) / e
        b = rel(res["P16"][1][n], res["J16"][1][n]) / e
        if max(a, b) > max(worst[:2]):
            worst = (a, b, n)
    print(f"{tag} worst tensor: {worst}")


def train():
    import test_torch_train_step as t
    jcfg, cfg = j_raft_v1(corr_impl="allpairs"), raft_v1(corr_impl="allpairs")
    for seed in range(6):
        variables = t.jax_variables(jcfg, 10 + seed)
        batch = t.make_batch(20 + seed)
        res = {}
        for mp, key in ((False, "J32"), (True, "J16")):
            loss, g = jax_grads(dataclasses.replace(jcfg, mixed_precision=mp),
                                variables, batch, t.ITERS)
            sd = raft_state_dict_from_jax({"params": g, "batch_stats":
                                           variables["batch_stats"]}, cfg=cfg)
            res[key] = (loss, {k: v.numpy() for k, v in sd.items()})
        res["P16"] = port_grads(cfg, TrainConfig(iters=t.ITERS,
                                                 precision="bf16"),
                                raft_state_dict_from_jax(variables, cfg=cfg),
                                batch)
        print_train(f"seed {seed}", res, list(res["P16"][1]))


def card_forward(name, h=128, w=256, iters=32):
    jc, pc = (j_raft_v1, raft_v1) if name == "v1" else (j_raft_v5, raft_v5)
    sd = create_model(pc(corr_impl="local"), seed=0, device="cpu").state_dict()
    variables = convert_raft_state_dict(sd)
    for seed in range(3):
        rng = np.random.default_rng(seed)  # chip_smoke.frame_pairs' scenes
        base = rng.uniform(0, 255, (h // 8 + 2, w // 8 + 2, 3))
        im = np.kron(base, np.ones((8, 8, 1)))[:h, :w]
        im2 = np.clip(np.roll(im, 3, axis=1) + rng.normal(0, 2, im.shape),
                      0, 255)
        a, b = im[None].astype(np.float32), im2[None].astype(np.float32)
        out = {}
        for mp in (False, True):
            jm = JRAFT(jc(corr_impl="local", mixed_precision=mp))
            out["J16" if mp else "J32"] = [np.asarray(x) for x in jax.jit(
                lambda v, x1, x2, jm=jm: jm.apply(
                    v, x1, x2, iters=iters, train=False, test_mode=True))(
                variables, a, b)]
            m = RAFT(pc(corr_impl="local", mixed_precision=mp))
            m.load_state_dict(sd, strict=True)
            with torch.inference_mode():
                lo, up = m.eval()(torch.from_numpy(a).permute(0, 3, 1, 2),
                                  torch.from_numpy(b).permute(0, 3, 1, 2),
                                  iters=iters)
            out["P16" if mp else "P32"] = [x.permute(0, 2, 3, 1).numpy()
                                           for x in (lo, up)]
        for k, label in enumerate(("flow_low", "flow_up")):
            j32, j16, p32, p16 = (out[x][k] for x in
                                  ("J32", "J16", "P32", "P16"))
            e = rel(j16, j32)
            print(f"{name} {h}x{w} seed {seed} {label}: e_J {e:.3e}, P16-P32 "
                  f"{rel(p16, p32) / e:.3f} e_J, P16-J16 "
                  f"{rel(p16, j16) / e:.3f} e_J, mean endpoint P16-P32 "
                  f"{np.sqrt(((p16 - p32) ** 2).sum(-1)).mean():.3g} px")


def card_train(h=96, w=128, b=2, iters=12):
    cfg = raft_v5(corr_impl="local")
    sd = create_model(cfg, seed=0, device="cpu").state_dict()
    variables = convert_raft_state_dict(sd)
    for seed in range(2):
        g = torch.Generator().manual_seed(seed)  # chip_smoke.train_batch
        batch = {"image1": torch.rand(b, h, w, 3, generator=g) * 255,
                 "image2": torch.rand(b, h, w, 3, generator=g) * 255,
                 "flow": torch.randn(b, h, w, 2, generator=g) * 4,
                 "valid": torch.ones(b, h, w)}
        batch = {k: v.numpy() for k, v in batch.items()}
        res = {}
        for mp, key in ((False, "J32"), (True, "J16")):
            loss, gr = jax_grads(dataclasses.replace(
                j_raft_v5(corr_impl="local"), mixed_precision=mp),
                variables, batch, iters)
            grads = raft_state_dict_from_jax(
                {"params": gr, "batch_stats": variables["batch_stats"]},
                cfg=cfg)
            res[key] = (loss, {k: v.numpy() for k, v in grads.items()})
        for prec, key in (("fp32", "P32"), ("bf16", "P16")):
            res[key] = port_grads(cfg, TrainConfig(
                iters=iters, precision=prec, batch_size=b), sd, batch)
        names = [n for n in res["P16"][1] if n in res["J32"][1]]
        print_train(f"v5 {h}x{w} seed {seed}", res, names)
        flat = {k: np.concatenate([res[k][1][n].ravel() for n in names])
                for k in ("P16", "P32")}
        print(f"  P16-P32 gradients {rel(flat['P16'], flat['P32']):.3e}")


if __name__ == "__main__":
    torch.set_num_threads(8)
    cmd, args = sys.argv[1], sys.argv[2:]
    if cmd == "modules":
        modules()
    elif cmd == "model":
        model(args[0])
    elif cmd == "train":
        train()
    elif cmd == "card_forward":
        card_forward(args[0], *map(int, args[1:3]))
    elif cmd == "card_train":
        card_train()
    else:
        raise SystemExit(__doc__)

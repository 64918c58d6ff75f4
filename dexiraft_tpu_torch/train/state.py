"""Train state: the model (parameters and BatchNorm stats), the optimizer,
the step count and the random generator.

Counterpart of ``dexiraft_tpu/train/state.py``. PyTorch updates in place,
so the state is a mutable record that the train step advances; the
generator plays the part of JAX's PRNG key: it draws the dropout masks and
the noise augmentation, on the model's device, and round-trips through
checkpoints with everything else.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from dexiraft_tpu_torch.config import RAFTConfig, TrainConfig
from dexiraft_tpu_torch.models.raft import RAFT, create_model
from dexiraft_tpu_torch.train.optimizer import AdamW, make_optimizer


@dataclasses.dataclass
class TrainState:
    step: int
    model: RAFT
    optimizer: AdamW
    generator: torch.Generator

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def train_model_config(cfg: RAFTConfig, tc: TrainConfig) -> RAFTConfig:
    """The RAFTConfig a train step of ``tc`` runs, as JAX's
    ``make_train_step`` derives it: ``precision="bf16"`` turns on the
    model's mixed precision, and ``remat`` "per_iter" / "dots_saveable"
    turn on its remat with the policy "full" / "dots_saveable"."""
    if tc.remat not in ("none", "per_iter", "dots_saveable"):
        raise ValueError(f"remat must be none|per_iter|dots_saveable, "
                         f"got {tc.remat!r}")
    if tc.remat != "none":
        cfg = dataclasses.replace(
            cfg, remat=True, remat_policy=("dots_saveable"
                                           if tc.remat == "dots_saveable"
                                           else "full"))
    if tc.precision == "bf16" and not cfg.mixed_precision:
        cfg = dataclasses.replace(cfg, mixed_precision=True)
    return cfg


def create_state(cfg: RAFTConfig, tc: TrainConfig,
                 device: Union[str, torch.device] = "cuda",
                 seed: Optional[int] = None,
                 model: Optional[RAFT] = None) -> TrainState:
    """A fresh state: ``model`` (moved to ``device``) or a seeded init
    (``create_model`` of ``train_model_config(cfg, tc)``, seed ``tc.seed``
    unless given), a fresh optimizer at step 0, and a generator on the
    model's device seeded the same way."""
    seed = tc.seed if seed is None else seed
    if model is None:
        model = create_model(train_model_config(cfg, tc), seed=seed,
                             device=device)
    else:
        model = model.to(device)
    dev = next(model.parameters()).device
    generator = torch.Generator(device=dev).manual_seed(seed)
    model.set_dropout_generator(generator)
    optimizer = make_optimizer(model.parameters(), tc.lr, tc.num_steps,
                               tc.wdecay, tc.epsilon, tc.clip)
    return TrainState(step=0, model=model, optimizer=optimizer,
                      generator=generator)


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())

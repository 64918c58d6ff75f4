"""AdamW + OneCycle schedule + global-norm clipping.

Counterpart of ``dexiraft_tpu/train/optimizer.py``: clip-by-global-norm ->
AdamW(b1 0.9, b2 0.999, eps 1e-8) under the linear OneCycle schedule over
num_steps + 100 steps, with the arithmetic of the optax chain the JAX
package builds, not torch's:

  * clipping scales the gradients by ``max_norm / norm`` only when
    ``norm >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to
    the norm and always scales);
  * every parameter is decayed by ``lr * wd * p`` each step, also one that
    received no gradient (``torch.optim.AdamW`` skips a parameter whose
    ``.grad`` is None; optax decays every leaf): a missing gradient counts
    as zeros. In v4/v5 that is the frozen DexiNed;
  * the learning rate of an update is the schedule at the step count
    before it, as optax's ``scale_by_learning_rate`` evaluates it.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch


def onecycle_lr(max_lr: float, total_steps: int, pct_start: float = 0.05,
                div_factor: float = 25.0, final_div_factor: float = 1e4
                ) -> Callable[[int], float]:
    """Linear one-cycle schedule, torch OneCycleLR(anneal='linear'), in the
    JAX package's float32 arithmetic: max_lr/div_factor -> max_lr over
    ``pct_start * total - 1`` steps, then linearly down to
    max_lr/(div_factor*final_div_factor) at ``total - 1``; steps past the
    total are clamped."""
    f32 = np.float32
    initial = max_lr / div_factor
    final = initial / final_div_factor
    up_steps = max(pct_start * total_steps - 1.0, 1e-6)
    last = f32(total_steps - 1.0)

    def schedule(step: int) -> float:
        s = min(f32(step), last)
        if s <= f32(up_steps):
            frac = min(s / f32(up_steps), f32(1.0))
            return float(f32(initial) + (f32(max_lr) - f32(initial)) * frac)
        frac = (s - f32(up_steps)) / (last - f32(up_steps))
        frac = min(max(frac, f32(0.0)), f32(1.0))
        return float(f32(max_lr) + (f32(final) - f32(max_lr)) * frac)

    return schedule


def training_schedule(lr: float, num_steps: int) -> Callable[[int], float]:
    """The schedule training uses: OneCycle over num_steps + 100 (the
    reference's slack); one source for the optimizer and the logged lr."""
    return onecycle_lr(lr, num_steps + 100)


class AdamW(torch.optim.Optimizer):
    """clip-by-global-norm -> AdamW(OneCycle), optax's arithmetic (module
    docstring). The step count and the schedule's arguments live in the
    (single) param group, so ``state_dict()`` round-trips the schedule's
    position; the Adam moments are per-parameter state (``mu``, ``nu``)."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float,
                 num_steps: int, wdecay: float = 1e-4, epsilon: float = 1e-8,
                 clip: float = 1.0, b1: float = 0.9, b2: float = 0.999):
        defaults = dict(max_lr=lr, num_steps=num_steps, weight_decay=wdecay,
                        eps=epsilon, clip=clip, b1=b1, b2=b2, count=0)
        super().__init__(params, defaults)
        if len(self.param_groups) != 1:
            raise ValueError("AdamW takes one parameter group (the clip "
                             "norm is global)")

    def load_state_dict(self, state_dict) -> None:
        """The saved moments and step count; the hyperparameters stay this
        optimizer's (a resumed run follows its own schedule from the saved
        step, as the JAX package's optax state holds only the count)."""
        hyper = {k: v for k, v in self.param_groups[0].items()
                 if k not in ("params", "count")}
        super().load_state_dict(state_dict)
        self.param_groups[0].update(hyper)

    def current_lr(self) -> float:
        """The learning rate the next update applies."""
        g = self.param_groups[0]
        return training_schedule(g["max_lr"], g["num_steps"])(g["count"])

    @staticmethod
    @torch.no_grad()
    def grad_norm(grads) -> torch.Tensor:
        """The global L2 norm the clip takes over ``grads`` (every
        parameter's, in order; zeros for a missing one)."""
        return torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))

    @torch.no_grad()
    def step(self, closure=None, *, grad_norm=None):
        """One update. ``grad_norm``: the clip's global norm, given by a
        caller whose parameters are slices of the model's (fsdp storage,
        parallel/fsdp.py), which takes it over the full gradient; else
        it is taken over this optimizer's gradients."""
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        group = self.param_groups[0]
        params = group["params"]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        clip = group["clip"]
        if clip and clip > 0:
            norm = self.grad_norm(grads) if grad_norm is None else grad_norm
            keep = norm < clip
            grads = [torch.where(keep, g, g / norm * clip) for g in grads]
        lr = self.current_lr()
        group["count"] += 1
        count = group["count"]
        b1, b2, eps, wd = group["b1"], group["b2"], group["eps"], group["weight_decay"]
        c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
        for p, g in zip(params, grads):
            st = self.state[p]
            if not st:
                st["mu"] = torch.zeros_like(p)
                st["nu"] = torch.zeros_like(p)
            mu, nu = st["mu"], st["nu"]
            mu.mul_(b1).add_(g, alpha=1.0 - b1)
            nu.mul_(b2).add_(g * g, alpha=1.0 - b2)
            update = (mu / c1) / ((nu / c2).sqrt() + eps)
            if wd:
                update = update + wd * p
            p.add_(update, alpha=-lr)
        return None


def make_optimizer(params: Iterable[torch.Tensor], lr: float, num_steps: int,
                   wdecay: float = 1e-4, epsilon: float = 1e-8,
                   clip: float = 1.0) -> AdamW:
    """clip-by-global-norm -> AdamW(OneCycle) over ``params`` (clip 0
    disables clipping)."""
    return AdamW(params, lr, num_steps, wdecay, epsilon, clip)

"""Divergence-guard decision logic: a copy of ``dexiraft_tpu/train/guard.py``.

The RAFT trainer (train_cli) checks on a step cadence and before every
checkpoint write; the DexiNed trainer (dexined_cli) checks at epoch end.
Both make the same decision — is this state poisoned, and if so, is a
rollback still allowed? — so the decision lives here once. The trainers
keep their own restore/log/rewind mechanics (those genuinely differ).

The poison verdict combines two signals: the loss (pre-update params;
the reference's only observable — its v3 run diverged from EPE 8.4 to
347 and kept logging, SURVEY.md §5) and ``state_finite``, the step's
post-update verdict (train.step.all_finite) that closes the one-step
blind spot a loss-only guard has.
"""

from __future__ import annotations

import math


class DivergenceGuard:
    """Counts rollbacks and decides poisoned/recoverable.

    Raises RuntimeError from ``consume_rollback`` when no valid rollback
    target exists or the budget is spent — persistent divergence needs a
    human (lower the lr or inspect the data).
    """

    def __init__(self, threshold: float = 1e4, max_rollbacks: int = 3):
        self.threshold = threshold
        self.max_rollbacks = max_rollbacks
        self.rollbacks = 0

    def poisoned(self, loss_v: float, state_ok: bool = True) -> bool:
        return (not math.isfinite(loss_v) or loss_v > self.threshold
                or not state_ok)

    def consume_rollback(self, loss_v: float, state_ok: bool,
                         where: str, last_saved,
                         ckpt_dir: "str | None" = None) -> str:
        """Spend one rollback or raise if unrecoverable.

        Returns (and, on abort, embeds in the RuntimeError) a message
        naming the checkpoint dir and restore step, so the operator can
        inspect the rolled-back state — `eval --model <dir>` it, diff
        its metrics — without reading the trainer's source to learn
        where the state went.
        """
        target = (f"step {last_saved}" if ckpt_dir is None
                  else f"{ckpt_dir} step {last_saved}")
        if last_saved is None or self.rollbacks >= self.max_rollbacks:
            raise RuntimeError(
                f"training diverged (loss {loss_v:.4g}, "
                f"state_finite={state_ok}) at {where}"
                + (" before this run saved any checkpoint"
                   if last_saved is None else
                   f" after {self.rollbacks} rollbacks; last good "
                   f"checkpoint: {target}")
                + "; lower the lr or inspect the data")
        self.rollbacks += 1
        return (f"restoring {target} "
                f"(rollback {self.rollbacks}/{self.max_rollbacks})")

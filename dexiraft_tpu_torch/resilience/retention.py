"""Checkpoint retention: bounded disk growth without losing the best run.

Counterpart of ``dexiraft_tpu/resilience/retention.py`` over the port's
checkpoints (train/checkpoint.py).

val_freq=5000 over a 100k-step stage leaves 20 full-state checkpoints
(~1 GB each for the big model) per stage, unboundedly across stages —
the reference had the same behavior and nobody GC'd by hand. The policy
here is the standard pair:

  * keep the newest `keep` steps (0 = keep everything, the old
    behavior and the default);
  * with `keep_best`, ALSO keep the step with the best (lowest)
    recorded validation score (EPE) even when it ages out of the window.

`apply` never deletes a protected step (the trainer protects its
current rollback target: the guard must always have somewhere to land).
The data stream's position lives inside a port checkpoint, so deleting
the step deletes it too.

Scores must outlive the process: --keep_best is a promise about a
MULTI-restart run (that's what preemption recovery means), so a policy
bound to a checkpoint directory persists its scores to
`<dir>/retention.json` on every update and reloads them on
construction — a resumed run still knows which old step was the best.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Dict, Iterable, List, Optional

from dexiraft_tpu_torch.train import checkpoint as ckpt


class RetentionPolicy:
    def __init__(self, keep: int = 0, keep_best: bool = False,
                 directory: Optional[str] = None):
        if keep < 0:
            raise ValueError(f"keep must be >= 0, got {keep}")
        self.keep = keep
        self.keep_best = keep_best
        self.directory = directory
        self.scores: Dict[int, float] = self._load()

    def _scores_path(self) -> str:
        return osp.join(self.directory, "retention.json")

    def _load(self) -> Dict[int, float]:
        if self.directory is None:
            return {}
        try:
            with open(self._scores_path()) as f:
                return {int(k): float(v) for k, v in json.load(f).items()}
        except (OSError, ValueError):
            return {}

    def _persist(self) -> None:
        if self.directory is None:
            return
        path = self._scores_path()
        os.makedirs(osp.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({str(k): v for k, v in self.scores.items()}, f)
        os.replace(tmp, path)

    def note_score(self, step: int, score: float) -> None:
        """Record a validation score (lower = better) for `step`."""
        self.scores[int(step)] = float(score)
        self._persist()

    def best_step(self) -> Optional[int]:
        if not self.scores:
            return None
        return min(self.scores, key=self.scores.get)

    def apply(self, directory: str,
              protect: Iterable[int] = ()) -> List[int]:
        """GC steps outside the policy; returns the deleted steps."""
        if self.keep <= 0:
            return []
        steps = ckpt.all_steps(directory)
        keep_set = set(steps[-self.keep:]) | {int(s) for s in protect
                                              if s is not None}
        if self.keep_best:
            best = self.best_step()
            if best is not None:
                keep_set.add(best)
        doomed = [s for s in steps if s not in keep_set]
        for s in doomed:
            ckpt.delete_step(directory, s)
            self.scores.pop(s, None)
        if doomed:
            self._persist()
            print(f"[retention] deleted step(s) {doomed} from {directory} "
                  f"(keep={self.keep}"
                  + (f", best={self.best_step()}" if self.keep_best else "")
                  + ")")
        return doomed

"""Data-stream position: the half of an exact resume that is not weights.

Counterpart of ``dexiraft_tpu/resilience/stream.py``. Because the
loader's shuffle and augmentation are counter-based PRNG streams keyed on
(seed, epoch, index), the whole sample sequence is a pure function of
(seed, epoch, batch-offset) — so resuming the exact sequence only needs
these two integers saved with each checkpoint.

The JAX package keeps them in a JSON sidecar beside its orbax step. The
port keeps them inside the step's own ``state.pt``, in the checkpoint's
``extra`` (train/checkpoint.py), so the position is committed by the same
rename as the weights it belongs to. :func:`position_extra` builds those
entries and :func:`position_from_extra` reads them back with the JAX
package's checks:

  stream       (epoch, offset) of the NEXT global batch to consume
  seed         the data seed; a different one on resume is warned about
  loader_kind  "raw" | "records": which data plane produced the stream; a
               raw<->records swap on resume raises LoaderKindMismatch
  fingerprint  the records pack's manifest fingerprint; a resume on a
               different pack raises LoaderKindMismatch

A checkpoint without ``stream`` resumes from epoch 0, and one without
``loader_kind`` (written before the records plane) resumes under either
loader, as the JAX package's legacy sidecars do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional


class LoaderKindMismatch(ValueError):
    """--resume would swap the data plane under a run: the checkpoint was
    written by one loader kind (raw files vs packed records) and the
    resuming process is using the other — or the same records kind but
    a DIFFERENT pack (manifest fingerprint changed: repacked tree,
    different mixture selector, different crop recipe). Refused loudly;
    a silent swap is exactly the kind of sequence divergence
    exact-resume exists to prevent."""


@dataclasses.dataclass(frozen=True)
class StreamPosition:
    """Position of the NEXT global batch to consume."""

    epoch: int = 0
    offset: int = 0  # global-batch index within the epoch

    def advance(self, batches: int, batches_per_epoch: int) -> "StreamPosition":
        """Position after consuming `batches` more global batches."""
        if batches_per_epoch <= 0:
            raise ValueError(
                f"batches_per_epoch must be positive, got {batches_per_epoch}")
        absolute = self.epoch * batches_per_epoch + self.offset + batches
        return StreamPosition(absolute // batches_per_epoch,
                              absolute % batches_per_epoch)


def position_extra(pos: StreamPosition, seed: Optional[int] = None,
                   loader_kind: Optional[str] = None,
                   fingerprint: Optional[str] = None) -> Dict[str, Any]:
    """The checkpoint ``extra`` entries that record ``pos`` and the data
    plane that produced it (module docstring)."""
    extra: Dict[str, Any] = {"stream": (int(pos.epoch), int(pos.offset))}
    if seed is not None:
        extra["seed"] = int(seed)
    if loader_kind is not None:
        extra["loader_kind"] = str(loader_kind)
    if fingerprint is not None:
        extra["fingerprint"] = str(fingerprint)
    return extra


def position_from_extra(extra: Mapping[str, Any], step: int,
                        seed: Optional[int] = None,
                        loader_kind: Optional[str] = None,
                        fingerprint: Optional[str] = None
                        ) -> Optional[StreamPosition]:
    """The position saved in checkpoint ``step``'s ``extra``; None when it
    holds none (resume then starts at epoch 0). A loader_kind recorded at
    save time that differs from the current one raises
    LoaderKindMismatch, and so does a different pack fingerprint; a
    different seed is warned about. Entries without the field (checkpoints
    from before the records plane) resume unconditionally."""
    saved_kind = extra.get("loader_kind")
    if (loader_kind is not None and saved_kind is not None
            and saved_kind != loader_kind):
        fix = ("pass the matching --records_dir"
               if saved_kind == "records" else "drop --records_dir")
        raise LoaderKindMismatch(
            f"checkpoint step {step} was saved by the {saved_kind!r} "
            f"loader but this run uses the {loader_kind!r} loader — "
            f"resuming would follow a different sample sequence; {fix} "
            f"or start fresh without --resume")
    saved_fp = extra.get("fingerprint")
    if (fingerprint is not None and saved_fp is not None
            and saved_fp != fingerprint):
        raise LoaderKindMismatch(
            f"checkpoint step {step} was saved from a records pack with "
            f"fingerprint {saved_fp[:12]} but --records_dir points at a "
            f"pack with fingerprint {fingerprint[:12]} — a repacked or "
            f"different dataset would follow a different sample "
            f"sequence; point --records_dir at the original pack or "
            f"start fresh without --resume")
    saved_seed = extra.get("seed")
    if seed is not None and saved_seed is not None and saved_seed != seed:
        print(f"[resilience] WARNING: checkpoint step {step} was saved with "
              f"data seed {saved_seed}, resuming with seed {seed} — the "
              f"sample sequence will differ from the interrupted run")
    try:
        epoch, offset = extra["stream"]
        return StreamPosition(int(epoch), int(offset))
    except (KeyError, TypeError, ValueError):
        return None

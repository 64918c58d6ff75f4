"""Shape buckets: arbitrary geometries -> a bounded set of padded shapes.

Counterpart of ``dexiraft_tpu/serve/buckets.py`` (its own copy). Frames
are quantized UP to multiples of ``multiple`` (itself a multiple of the
model's stride 8); the replicate-edge pad out to the bucket is undone per
item on the way back (data.padder.InputPadder with ``target=``).
``multiple == stride`` (the default) reproduces the reference pad shapes.

Where the JAX registry counts compiled executables, this one counts
searched signatures: the first dispatch of a (bucket, warm-start)
signature is where cuDNN times its algorithms for the batch's conv shapes
(train/step.py ``eval_arithmetic``), the port's one-time cost per shape.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple


def bucket_shape(ht: int, wd: int, stride: int = 8,
                 multiple: Optional[int] = None) -> Tuple[int, int]:
    """Smallest (H, W) >= input with both dims multiples of ``multiple``."""
    m = multiple or stride
    if m % stride:
        raise ValueError(f"bucket multiple {m} must be a multiple of the "
                         f"model stride {stride}")
    return (-(-ht // m) * m, -(-wd // m) * m)


class BucketRegistry:
    """Maps input geometries to bucket shapes and counts hits per bucket
    and searched dispatch signatures."""

    def __init__(self, stride: int = 8, multiple: Optional[int] = None):
        self.stride = stride
        self.multiple = multiple or stride
        self.hits: Dict[Tuple[int, int], int] = {}
        self._searched: set = set()

    def bucket_for(self, ht: int, wd: int) -> Tuple[int, int]:
        b = bucket_shape(ht, wd, self.stride, self.multiple)
        self.hits[b] = self.hits.get(b, 0) + 1
        return b

    def mark_searched(self, key) -> bool:
        """Record a dispatch-signature key (bucket shape, flow_init
        present); True the first time, the dispatch that runs cuDNN's
        search."""
        if key in self._searched:
            return False
        self._searched.add(key)
        return True

    @property
    def searches(self) -> int:
        return len(self._searched)

    @staticmethod
    def _signature_name(key) -> str:
        """An engine key ((H, W), warm) as HxW or HxW+warm."""
        try:
            (h, w), warm = key
            return f"{h}x{w}" + ("+warm" if warm else "")
        except (TypeError, ValueError):
            return str(key)

    def stats(self) -> dict:
        """``buckets``: the shapes with their hit counts; ``searched``:
        the signatures whose first dispatch has run."""
        return {
            "stride": self.stride,
            "multiple": self.multiple,
            "buckets": {f"{h}x{w}": n
                        for (h, w), n in sorted(self.hits.items())},
            "bucket_count": len(self.hits),
            "searches": self.searches,
            "searched": sorted(self._signature_name(k)
                               for k in self._searched),
        }

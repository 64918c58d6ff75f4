"""Configuration tree for the PyTorch port.

Counterpart of ``dexiraft_tpu/config.py``: the same frozen ``RAFTConfig``
(fields, properties and construction-time refusals), the variant
constructors and the CLI vocabularies. This package keeps its own copy so
that it never imports the JAX package.

Fields the port does not implement yet (remat, mixed precision, scan
unrolling) are accepted at their defaults and refused with a clear error
otherwise. Both DexiNed upsampler forms are accepted: they are one linear
map with one parameter tree (models/dexined.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# storage precisions for the fmap2 pyramid (ops/quant.py)
CORR_DTYPES = ("fp32", "bf16", "int8")

# correlation implementations, as in the JAX package. The port runs
# "local" (plain PyTorch lookup), "flash" (the hand-written CUDA kernel of
# csrc/flash_corr.cu) and "pallas" (the per-pixel CUDA kernel of
# csrc/pallas_corr.cu); "allpairs" is refused by models/raft.py.
CORR_IMPLS = ("allpairs", "local", "pallas", "flash")

# the corr implementations models/raft.py runs
PORTED_CORR_IMPLS = ("local", "flash", "pallas")

# the embedded DexiNed's transposed-conv forms, as in the JAX package: the
# plain transposed conv and its sub-pixel rewrite compute the same map with
# the same parameters, so both run the port's nn.ConvTranspose2d
DEXINED_UPCONVS = ("transpose", "subpixel")


def resolve_corr_impl(impl: str, platform: str) -> Tuple[str, bool]:
    """Resolve a ``--corr_impl`` value to a (corr_impl, fused_update) pair.

    "auto" on CUDA is the production path: the flash kernel with the
    motion encoder's 1x1 corr conv fused in (``("flash", True)``). On any
    other platform it resolves to the plain PyTorch lookup ("local"), the
    only path that runs there. Explicit values pass through unfused.
    """
    if impl == "auto":
        return ("flash", True) if platform == "cuda" else ("local", False)
    return impl, False


def resolve_corr_impl_args(args, platform: str, label: str) -> Tuple[str, bool]:
    """The CLI glue around :func:`resolve_corr_impl`: merge the
    --fused_update flag into the resolution, refuse fused on a non-kernel
    impl with a one-line error, and announce what "auto" resolved to."""
    impl, fused_auto = resolve_corr_impl(args.corr_impl, platform)
    fused = args.fused_update or fused_auto
    if fused and impl not in ("pallas", "flash"):
        raise SystemExit(f"{label}: --fused_update requires --corr_impl "
                         "flash or pallas (pass one explicitly — 'auto' "
                         "resolves to local off the card)")
    if args.corr_impl == "auto":
        print(f"[{label}] corr_impl auto -> {impl}"
              f"{' + fused_update' if fused else ''}", flush=True)
    return impl, fused


# fields that exist for parity with the JAX config but that the port does
# not implement yet: name -> the only value accepted
_UNPORTED_DEFAULTS = {
    "mixed_precision": False,
    "remat": False,
    "remat_policy": "full",
    "remat_lookup": False,
    "scan_unroll": 1,
}
# the ROADMAP item that ports each of them
_UNPORTED_ITEMS = {
    "mixed_precision": "A2",
    "remat": "A10",
    "remat_policy": "A10",
    "remat_lookup": "A10",
}


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    """Architecture config for the five experiment variants.

      v1  variant='raft'                       vanilla RAFT, image stream only
      v2  variant='early'                      6-ch early fusion
      v3  variant='separate'                   dual stream, decoupled updates
      v4  variant='early',  embed_dexined=True 10-ch early fusion with DexiNed
      v5  variant='dual',   embed_dexined=True dual stream with DexiNed

    The port runs all five (models/raft.py), with the JAX package's
    refusals: ``dual`` needs the embedded DexiNed, and the two pairings
    outside the five (``raft`` or ``separate`` with ``embed_dexined``) are
    refused when the model is built.
    """

    variant: str = "raft"  # raft | early | separate | dual
    small: bool = False
    embed_dexined: bool = False
    corr_levels: int = 4
    corr_radius: Optional[int] = None  # None -> 4 full / 3 small
    dropout: float = 0.0
    mixed_precision: bool = False
    corr_impl: str = "allpairs"
    # STORAGE precision of the fmap2 pyramid the lookup reads
    corr_dtype: str = "fp32"
    # run the motion encoder's 1x1 corr conv inside the lookup kernel
    fused_update: bool = False
    # query rows per chunk of the plain lookup (bounds its transient
    # correlation block; None = whole frame at once)
    corr_row_chunk: Optional[int] = 8
    remat: bool = False
    remat_policy: str = "full"
    remat_lookup: bool = False
    dexined_upconv: str = "subpixel"
    scan_unroll: int = 1
    # convergence gate of the adaptive inference path (models/raft.py
    # adaptive=True): an item freezes once the mean per-pixel L2 norm of
    # its 1/8-res flow delta drops below this; 0 disables the gate
    converge_tol: float = 0.02

    def __post_init__(self):
        if self.corr_impl not in CORR_IMPLS:
            raise ValueError(
                f"unknown corr_impl {self.corr_impl!r}; expected one of "
                f"{CORR_IMPLS}")
        if self.corr_dtype not in CORR_DTYPES:
            raise ValueError(
                f"unknown corr_dtype {self.corr_dtype!r}; expected one "
                f"of {CORR_DTYPES}")
        if self.fused_update and self.corr_impl not in ("pallas", "flash"):
            raise ValueError(
                "fused_update=True requires corr_impl='flash' (the "
                "production kernel) or 'pallas'; the allpairs volume and "
                "the plain lookup have no fused form")
        if self.dexined_upconv not in DEXINED_UPCONVS:
            raise ValueError(
                f"unknown dexined_upconv {self.dexined_upconv!r}; expected "
                f"one of {DEXINED_UPCONVS}")
        if self.remat_policy not in ("full", "dots_saveable"):
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r}; expected "
                "'full' or 'dots_saveable'")
        if self.converge_tol < 0:
            raise ValueError(
                f"converge_tol must be >= 0 (a flow-delta NORM threshold; "
                f"0 disables the gate), got {self.converge_tol}")
        for name, default in _UNPORTED_DEFAULTS.items():
            if getattr(self, name) != default:
                item = _UNPORTED_ITEMS.get(name)
                raise ValueError(
                    f"{name}={getattr(self, name)!r} is not supported by the "
                    f"PyTorch port yet (only {default!r}"
                    + (f"; ROADMAP {item}" if item else "")
                    + "); use the JAX package (dexiraft_tpu) for it")

    @property
    def radius(self) -> int:
        return self.corr_radius if self.corr_radius is not None else (3 if self.small else 4)

    @property
    def hidden_dim(self) -> int:
        return 96 if self.small else 128

    @property
    def context_dim(self) -> int:
        return 64 if self.small else 128

    @property
    def fnet_dim(self) -> int:
        return 128 if self.small else 256

    @property
    def corr_planes(self) -> int:
        return self.corr_levels * (2 * self.radius + 1) ** 2

    @property
    def image_channels(self) -> int:
        if self.variant == "early":
            return 10 if self.embed_dexined else 6
        return 3

    @property
    def has_edge_stream(self) -> bool:
        return self.variant in ("separate", "dual")


def raft_v1(**kw) -> RAFTConfig:
    return RAFTConfig(variant="raft", **kw)


def raft_v2(**kw) -> RAFTConfig:
    return RAFTConfig(variant="early", embed_dexined=False, **kw)


def raft_v3(**kw) -> RAFTConfig:
    return RAFTConfig(variant="separate", **kw)


def raft_v4(**kw) -> RAFTConfig:
    return RAFTConfig(variant="early", embed_dexined=True, **kw)


def raft_v5(**kw) -> RAFTConfig:
    return RAFTConfig(variant="dual", embed_dexined=True, **kw)


# experiment-variant name -> constructor (the --variant vocabulary)
VARIANTS = {
    "v1": raft_v1, "raft": raft_v1,
    "v2": raft_v2, "early": raft_v2,
    "v3": raft_v3, "separate": raft_v3,
    "v4": raft_v4,
    "v5": raft_v5, "dual": raft_v5,
}

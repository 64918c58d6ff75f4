"""The standalone DexiNed edge workload (reference core/DexiNed/):
losses, BIPED-family datasets and metrics; the train/test driver is
``dexined_cli``. Counterpart of ``dexiraft_tpu/dexined``."""

from dexiraft_tpu_torch.dexined.losses import (
    bdcn_loss2,
    bdcn_loss_ori,
    cats_loss,
    hed_loss2,
    rcf_loss,
    weighted_multiscale_loss,
)

__all__ = [
    "bdcn_loss2",
    "bdcn_loss_ori",
    "hed_loss2",
    "rcf_loss",
    "cats_loss",
    "weighted_multiscale_loss",
]

"""Flow training loss and metrics.

Counterpart of ``dexiraft_tpu/ops/losses.py`` in the port's NCHW layout:
``sequence_loss`` is the reference's gamma-weighted L1 over every
refinement iteration with its masking: invalid pixels are zeroed but still
counted in the mean.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

MAX_FLOW = 400.0


def flow_metrics(flow_pred: torch.Tensor, flow_gt: torch.Tensor,
                 valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """End-point-error stats over valid pixels: the masked mean EPE and
    the <1/3/5 px rates. flow_pred/flow_gt (B, 2, H, W); valid (B, H, W)."""
    epe = (flow_pred - flow_gt).square().sum(dim=1).sqrt()
    v = valid.to(torch.float32)
    denom = v.sum().clamp(min=1.0)

    def masked_mean(x):
        return (x * v).sum() / denom

    return {
        "epe": masked_mean(epe),
        "1px": masked_mean((epe < 1.0).to(torch.float32)),
        "3px": masked_mean((epe < 3.0).to(torch.float32)),
        "5px": masked_mean((epe < 5.0).to(torch.float32)),
    }


def sequence_loss(flow_preds: torch.Tensor, flow_gt: torch.Tensor,
                  valid: torch.Tensor, gamma: float = 0.8,
                  max_flow: float = MAX_FLOW
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Exponentially weighted L1 over the iteration sequence.

    flow_preds (iters, B, 2, H, W), the stacked per-iteration upsampled
    flows; flow_gt (B, 2, H, W); valid (B, H, W) float or bool. Prediction
    i of n weighs gamma**(n-1-i); each term is the mean over ALL pixels
    with the invalid ones zeroed (not a masked mean). The metrics are
    those of the last prediction over the valid pixels."""
    n = flow_preds.shape[0]
    mag = flow_gt.square().sum(dim=1).sqrt()
    valid_mask = (valid >= 0.5) & (mag < max_flow)
    vf = valid_mask.to(torch.float32)[None, :, None]  # (1, B, 1, H, W)
    weights = gamma ** torch.arange(n - 1, -1, -1, dtype=torch.float32,
                                    device=flow_preds.device)
    per_iter = (vf * (flow_preds - flow_gt[None]).abs()).mean(dim=(1, 2, 3, 4))
    loss = (weights * per_iter).sum()
    return loss, flow_metrics(flow_preds[-1], flow_gt, valid_mask)

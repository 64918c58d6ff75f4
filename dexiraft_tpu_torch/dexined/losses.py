"""Edge-detection losses (reference core/DexiNed/losses.py), in PyTorch.

Counterpart of ``dexiraft_tpu/dexined/losses.py`` in NCHW: every loss takes
logits (B, 1, H, W) and targets in [0, 1] of the same shape and returns a
scalar. Class-balancing statistics are computed over the whole batch
tensor, except in :func:`bdcn_loss_ori`, which balances per sample like
the reference's ``bdcn_lossORI``. The RCF convention reserves target == 2
for don't-care pixels, which weigh 0.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

_EPS = 1e-10


def _bce_logits_sum(logits: torch.Tensor, targets: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """Weighted BCE in LOGITS space: softplus(x) - t*x.

    Exactly -t*log(p) - (1-t)*log(1-p) for p = sigmoid(x), but stable at
    saturation. The clipped-probability form is NaN in fp32: the upper
    clip bound 1 - 1e-10 rounds to exactly 1.0, so a saturated-positive
    logit at a positive pixel gives (1-t)*log(1-p) = 0 * (-inf) = NaN."""
    ce = F.softplus(logits) - targets * logits
    return torch.sum(weights * ce)


def _balance(t: torch.Tensor, pos_threshold: float) -> torch.Tensor:
    pos = t > pos_threshold
    num_pos = pos.sum(dtype=torch.float32)
    num_neg = (t <= 0.0).sum(dtype=torch.float32)
    total = num_pos + num_neg
    return torch.where(pos, num_neg / total, 1.1 * num_pos / total)


def bdcn_loss2(logits: torch.Tensor, targets: torch.Tensor,
               l_weight: float = 1.1) -> torch.Tensor:
    """Class-balanced BCE, BDCN/RCF weighting (losses.py:22-35):
    positives (t > 0) weighted num_neg/total, negatives 1.1*num_pos/total.

    The torch reference first casts targets.long(), truncating every
    sub-1.0 annotation to 0 — only exactly-1.0 pixels are positives and
    the BCE target itself is the binarized map; floor() reproduces that.
    """
    t = torch.floor(targets.float())
    return l_weight * _bce_logits_sum(logits, t, _balance(t, 0.0))


def hed_loss2(logits: torch.Tensor, targets: torch.Tensor,
              l_weight: float = 1.1) -> torch.Tensor:
    """HED variant: positive threshold at 0.1 (losses.py:6-19); the same
    binarization as :func:`bdcn_loss2`."""
    t = torch.floor(targets.float())
    return l_weight * _bce_logits_sum(logits, t, _balance(t, 0.1))


def bdcn_loss_ori(logits: torch.Tensor, targets: torch.Tensor,
                  l_weight: float = 1.1) -> torch.Tensor:
    """Original BDCN loss (losses.py:37-58 ``bdcn_lossORI``): class
    balancing PER SAMPLE — for image i, exactly-1 pixels weigh
    num_neg_i/valid_i, exactly-0 pixels 1.1*num_pos_i/valid_i, everything
    else weight 0."""
    t = targets.float()
    pos = (t == 1.0).float()
    neg = (t == 0.0).float()
    dims = tuple(range(1, t.ndim))  # per-sample statistics
    num_pos = pos.sum(dim=dims, keepdim=True)
    num_neg = neg.sum(dim=dims, keepdim=True)
    valid = torch.clamp(num_pos + num_neg, min=1.0)
    w = pos * (num_neg / valid) + neg * (1.1 * num_pos / valid)
    return l_weight * _bce_logits_sum(logits, t, w)


def rcf_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """RCF: strict positives (t > 0.5), zeros negative, t == 2 ignored
    (losses.py:60-74); binarized like :func:`bdcn_loss2`."""
    t = torch.floor(targets.float())
    pos = (t > 0.5) & (t < 1.5)
    neg = t == 0.0
    num_pos = pos.sum(dtype=torch.float32)
    num_neg = neg.sum(dtype=torch.float32)
    total = num_pos + num_neg
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    w = torch.where(pos, num_neg / total,
                    torch.where(neg, 1.1 * num_pos / total, zero))
    return _bce_logits_sum(logits, pos.to(t.dtype), w)


def _box_sum(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Sum over a (2r+1)^2 window with SAME padding: a ones-kernel conv
    on (B, 1, H, W)."""
    k = 2 * radius + 1
    kernel = torch.ones((1, 1, k, k), dtype=x.dtype, device=x.device)
    return F.conv2d(x, kernel, padding=radius)


def bdrloss(prediction: torch.Tensor, label: torch.Tensor,
            radius: int) -> torch.Tensor:
    """Boundary tracing loss (losses.py:77-104). prediction: probabilities."""
    bdr_pred = prediction * label
    pred_bdr_sum = label * _box_sum(bdr_pred, radius)

    texture_mask = _box_sum(label, radius)
    mask = ((texture_mask != 0.0) & (label != 1.0)).float()
    pred_texture_sum = _box_sum(prediction * (1.0 - label) * mask, radius)

    softmax_map = torch.clamp(
        pred_bdr_sum / (pred_texture_sum + pred_bdr_sum + _EPS),
        _EPS, 1.0 - _EPS)
    cost = torch.where(label == 0.0, torch.zeros_like(label),
                       -label * torch.log(softmax_map))
    return torch.sum(cost)


def textureloss(prediction: torch.Tensor, label: torch.Tensor,
                mask_radius: int) -> torch.Tensor:
    """Texture suppression loss (losses.py:107-127). prediction: probs."""
    pred_sums = _box_sum(prediction, 1)
    label_sums = _box_sum(label, mask_radius)
    mask = (label_sums == 0.0).float()
    loss = -torch.log(torch.clamp(1.0 - pred_sums / 9.0, _EPS, 1.0 - _EPS))
    return torch.sum(loss * mask)


def cats_loss(logits: torch.Tensor, targets: torch.Tensor,
              l_weight: Tuple[float, float] = (0.0, 0.0)) -> torch.Tensor:
    """CATS: balanced BCE + boundary tracing + texture suppression
    (losses.py:130-150). l_weight = (texture_factor, boundary_factor)."""
    tex_factor, bdr_factor = l_weight
    balanced_w = 1.1
    t = targets.float()
    num_pos = (t == 1.0).sum(dtype=torch.float32)
    num_neg = (t == 0.0).sum(dtype=torch.float32)
    beta = num_neg / (num_pos + num_neg + _EPS)
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    mask = torch.where(t == 1.0, beta,
                       torch.where(t == 0.0, balanced_w * (1.0 - beta), zero))
    prediction = torch.sigmoid(logits)
    cost = _bce_logits_sum(logits, t, mask)

    label_w = (t != 0.0).float()
    return (cost
            + bdr_factor * bdrloss(prediction, label_w, radius=4)
            + tex_factor * textureloss(prediction, label_w, mask_radius=4))


# per-scale weights for the 7 DexiNed outputs (main.py:29)
BDCN_SCALE_WEIGHTS = (0.7, 0.7, 1.1, 1.1, 0.3, 0.3, 1.3)


def weighted_multiscale_loss(preds: Sequence[torch.Tensor],
                             targets: torch.Tensor,
                             weights: Sequence[float] = BDCN_SCALE_WEIGHTS,
                             loss_fn=bdcn_loss2) -> torch.Tensor:
    """sum_i loss_fn(preds[i], targets, w_i) (main.py:39)."""
    return sum(loss_fn(p, targets, w) for p, w in zip(preds, weights))

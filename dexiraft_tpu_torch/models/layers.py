"""Shared layer helpers: the norm factory and the seeded init.

Counterpart of ``dexiraft_tpu/models/layers.py``. The reference's four norm
modes with torch's own hyperparameters: eps 1e-5 everywhere, BatchNorm
momentum 0.1 (running stats in eval mode), instance norm without affine,
and "none" as an empty ``nn.Sequential`` (no parameters, as the reference
registers it). In training mode BatchNorm updates its running stats by
flax's rule (:class:`BatchNorm2d`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training-mode running variance follows
    flax's ``nn.BatchNorm``: the EMA folds in the BIASED batch variance
    (``torch.nn.BatchNorm2d`` folds the unbiased one, n/(n-1) larger).
    Normalization and the eval mode are torch's, and so are the state
    dict's keys."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class ChannelDropout(nn.Module):
    """Channel dropout (``Dropout2d`` semantics: one draw per (sample,
    channel), broadcast over H and W, kept values scaled by 1/(1-p)). The
    masks come from ``generator`` when one is set (the train state's, on
    the activations' device), else from the global RNG."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p <= 0.0:
            return x
        keep = 1.0 - self.p
        u = torch.rand((x.shape[0], x.shape[1], 1, 1), device=x.device,
                       generator=self.generator)
        return x * ((u < keep).to(x.dtype) / keep)

    def extra_repr(self) -> str:
        return f"p={self.p}"


def make_norm(norm_fn: str, num_groups: int, planes: int) -> nn.Module:
    if norm_fn == "group":
        return nn.GroupNorm(num_groups=num_groups, num_channels=planes, eps=1e-5)
    if norm_fn == "batch":
        return BatchNorm2d(planes, eps=1e-5, momentum=0.1)
    if norm_fn == "instance":
        return nn.InstanceNorm2d(planes, eps=1e-5, affine=False)
    if norm_fn == "none":
        return nn.Sequential()
    raise ValueError(f"unknown norm_fn: {norm_fn!r}")


ENCODER_ROOTS = ("fnet", "cnet", "efnet", "ecnet")
DEXINED_ROOT = "dexined"


def _xavier_normal(shape, fan_in: int, fan_out: int,
                   generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator) * math.sqrt(
        2.0 / (fan_in + fan_out))


@torch.no_grad()
def seeded_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every parameter from ``generator`` (a CPU generator; the
    values are copied to wherever the model lives).

    Encoder convs (``fnet``, ``cnet``, ``efnet``, ``ecnet``): Kaiming
    normal, fan-out, relu gain, zero bias (the reference extractor's init).
    DexiNed convs and transposed convs: Xavier normal, or normal(0.1) for a
    transposed conv with one output channel, zero bias (the JAX package's
    DexiNed init). Other convs: PyTorch's default uniform bound
    1/sqrt(fan_in) for weight and bias. Norms: identity affine and fresh
    running stats.
    """
    for name, m in model.named_modules():
        root = name.split(".")[0]
        if isinstance(m, nn.Conv2d):
            kh, kw = m.kernel_size
            fan_in = m.in_channels // m.groups * kh * kw
            if root in ENCODER_ROOTS:
                std = math.sqrt(2.0 / (m.out_channels * kh * kw))
                w = torch.randn(m.weight.shape, generator=generator) * std
                bias = torch.zeros(m.out_channels)
            elif root == DEXINED_ROOT:
                w = _xavier_normal(m.weight.shape, fan_in,
                                   m.out_channels * kh * kw, generator)
                bias = torch.zeros(m.out_channels)
            else:
                bound = 1.0 / math.sqrt(fan_in)
                w = (torch.rand(m.weight.shape, generator=generator) * 2 - 1) * bound
                bias = (torch.rand(m.out_channels, generator=generator) * 2 - 1) * bound
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.copy_(bias)
        elif isinstance(m, nn.ConvTranspose2d):
            kh, kw = m.kernel_size
            if m.out_channels == 1:
                w = torch.randn(m.weight.shape, generator=generator) * 0.1
            else:
                w = _xavier_normal(m.weight.shape, m.in_channels * kh * kw,
                                   m.out_channels * kh * kw, generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
            if m.weight is not None:
                m.weight.fill_(1.0)
                m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()
    return model

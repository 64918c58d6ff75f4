"""Shared layer helpers: the norm factory and the seeded init.

Counterpart of ``dexiraft_tpu/models/layers.py``. The reference's four norm
modes with torch's own hyperparameters: eps 1e-5 everywhere, BatchNorm
momentum 0.1 (running stats in eval mode), instance norm without affine,
and "none" as an empty ``nn.Sequential`` (no parameters, as the reference
registers it).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn


def make_norm(norm_fn: str, num_groups: int, planes: int) -> nn.Module:
    if norm_fn == "group":
        return nn.GroupNorm(num_groups=num_groups, num_channels=planes, eps=1e-5)
    if norm_fn == "batch":
        return nn.BatchNorm2d(planes, eps=1e-5, momentum=0.1)
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

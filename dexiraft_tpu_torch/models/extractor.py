"""Feature and context encoders at 1/8 resolution (NCHW).

Counterpart of ``dexiraft_tpu/models/extractor.py``, with the reference's
torch attribute names (``conv1``, ``norm1``, ``layer{L}.{j}.conv{N}``,
``downsample.0/1``, ``conv2``), so converted weights load strictly.
Padding is ``k // 2`` on both sides, as flax's integer padding is.

The output's channel dropout (training only) is
:class:`~dexiraft_tpu_torch.models.layers.ChannelDropout`, broadcast over H
and W like the JAX package's, with masks from the train state's generator.

As in the reference, a strided block's last norm is registered twice:
as ``normK`` and as ``downsample.1``. Both names reach the state dict and
hold the same tensors.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from dexiraft_tpu_torch.models.layers import ChannelDropout, Conv2d, make_norm

BASIC_STAGES: Tuple[Tuple[int, int], ...] = ((64, 1), (96, 2), (128, 2))
SMALL_STAGES: Tuple[Tuple[int, int], ...] = ((32, 1), (64, 2), (96, 2))


class ResidualBlock(nn.Module):
    """Two 3x3 convs + skip; 1x1-conv downsample when strided."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "group",
                 stride: int = 1):
        super().__init__()
        groups = planes // 8
        self.conv1 = Conv2d(in_planes, planes, 3, padding=1, stride=stride)
        self.conv2 = Conv2d(planes, planes, 3, padding=1)
        self.norm1 = make_norm(norm_fn, groups, planes)
        self.norm2 = make_norm(norm_fn, groups, planes)
        self.downsample = None
        if stride != 1:
            self.norm3 = make_norm(norm_fn, groups, planes)
            self.downsample = nn.Sequential(
                Conv2d(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 bottleneck at planes // 4 inner width."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "group",
                 stride: int = 1):
        super().__init__()
        groups = planes // 8
        q = planes // 4
        self.conv1 = Conv2d(in_planes, q, 1)
        self.conv2 = Conv2d(q, q, 3, padding=1, stride=stride)
        self.conv3 = Conv2d(q, planes, 1)
        self.norm1 = make_norm(norm_fn, groups, q)
        self.norm2 = make_norm(norm_fn, groups, q)
        self.norm3 = make_norm(norm_fn, groups, planes)
        self.downsample = None
        if stride != 1:
            self.norm4 = make_norm(norm_fn, groups, planes)
            self.downsample = nn.Sequential(
                Conv2d(in_planes, planes, 1, stride=stride), self.norm4)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = F.relu(self.norm3(self.conv3(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class Encoder(nn.Module):
    """7x7/2 stem -> three two-block stages -> 1x1 projection.

    ``in_channels`` is 3 for the image encoders and 7 for v5's edge
    encoders ``efnet``/``ecnet``, which consume DexiNed's 7 logit maps.
    Accepts one (N, C, H, W) batch or a list of them; a list is
    concatenated on the batch axis and split again on the way out.
    """

    def __init__(self, output_dim: int = 128, norm_fn: str = "batch",
                 dropout: float = 0.0, block: str = "residual",
                 stem_width: int = 64,
                 stages: Tuple[Tuple[int, int], ...] = BASIC_STAGES,
                 in_channels: int = 3):
        super().__init__()
        block_cls = ResidualBlock if block == "residual" else BottleneckBlock
        self.conv1 = Conv2d(in_channels, stem_width, 7, stride=2, padding=3)
        self.norm1 = make_norm(norm_fn, 8, stem_width)
        in_planes = stem_width
        for i, (planes, stride) in enumerate(stages, start=1):
            layer = nn.Sequential(block_cls(in_planes, planes, norm_fn, stride),
                                  block_cls(planes, planes, norm_fn, 1))
            setattr(self, f"layer{i}", layer)
            in_planes = planes
        self.conv2 = Conv2d(in_planes, output_dim, 1)
        self.dropout = ChannelDropout(dropout) if dropout > 0 else None

    def forward(self, x: Union[torch.Tensor, Sequence[torch.Tensor]]):
        is_list = isinstance(x, (tuple, list))
        if is_list:
            batch_dim = x[0].shape[0]
            x = torch.cat(list(x), dim=0)
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        x = self.conv2(x)
        if self.dropout is not None:
            x = self.dropout(x)
        if is_list:
            return x[:batch_dim], x[batch_dim:]
        return x


# Declarative H-axis conv chains: the halo widths' source of truth
# (parallel/halo.py composes them into receptive-field margins,
# ``halo_rows``). One entry per conv, (kernel, stride, padding) along H,
# in forward order, kept next to the convs they describe so that a
# kernel-size change is one diff away from the exchange width that must
# follow it.


def block_conv_chain(block: str, stride: int) -> Tuple[Tuple[int, int, int], ...]:
    """Deepest sequential H-axis conv path of one block. The 1x1 skip
    conv is a parallel path with zero halo and is left out: a block's
    halo is its longest path's."""
    if block == "residual":
        return ((3, stride, 1), (3, 1, 1))
    return ((1, 1, 0), (3, stride, 1), (1, 1, 0))


def encoder_conv_chain(block: str = "residual") -> Tuple[Tuple[int, int, int], ...]:
    """The whole sequential H-axis conv chain of one Encoder forward:
    7x7/2 stem -> two blocks per stage -> 1x1 projection."""
    stages = BASIC_STAGES if block == "residual" else SMALL_STAGES
    chain = [(7, 2, 3)]
    for _, stride in stages:
        chain += list(block_conv_chain(block, stride))
        chain += list(block_conv_chain(block, 1))
    chain.append((1, 1, 0))
    return tuple(chain)


def BasicEncoder(output_dim=128, norm_fn="batch", dropout=0.0,
                 in_channels=3) -> Encoder:
    """Residual encoder (64, 96/2, 128/2)."""
    return Encoder(output_dim, norm_fn, dropout, "residual", 64, BASIC_STAGES,
                   in_channels)


def SmallEncoder(output_dim=128, norm_fn="batch", dropout=0.0,
                 in_channels=3) -> Encoder:
    """Bottleneck encoder (32, 64/2, 96/2)."""
    return Encoder(output_dim, norm_fn, dropout, "bottleneck", 32,
                   SMALL_STAGES, in_channels)

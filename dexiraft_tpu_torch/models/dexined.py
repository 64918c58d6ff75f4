"""DexiNed, the edge network that v5 embeds frozen and the standalone
edge workload trains, in PyTorch (NCHW).

Counterpart of ``dexiraft_tpu/models/dexined.py``: a stem of two
DoubleConvBlocks, dense blocks with 0.5 * (new + skip) fusion, left and
right 1x1-conv skip paths, transposed-conv upsamplers, and a final fusion
over the 6 scale outputs: the 1x1 ``block_cat`` conv (``fusion="cat"``,
the default, the head RAFT v4/v5 embed) or the attention head
:class:`CoFusion` (``fusion="cofusion"``). Returns 7 maps (6 scales and
the fused one), each (B, 1, H, W) of raw logits: the edge contract the v5
flow model consumes (no sigmoid).

BatchNorm is ``models.layers.BatchNorm2d``: in train mode (the standalone
trainer) its running variance folds in the biased batch variance, as
flax's does; its state-dict keys and eval mode are torch's.

Attribute names are the reference torch model's (``block_1.conv1``,
``dblock_3.denselayer1.norm2``, ``side_5.bn``, ``up_block_5.features.2``,
``block_cat.conv``, ...), the names the JAX package's converter maps
(``interop/torch_convert.py``), so converted weights load strictly; the
CoFusion head's are ``block_cat.conv1`` ... ``block_cat.norm_layer2``. Two
modules exist only for the weights: the "cat" head's BatchNorm (never
applied) and ``side_5`` (never called), as in the reference.

The upsamplers are ``nn.ConvTranspose2d`` with the reference's paddings:
the JAX package's "transpose" upconv. Its default "subpixel" upconv is a
TPU rewrite of the same linear map with the same parameters, so both
values of ``dexined_upconv`` (and of the DexiNed CLI's ``--upconv``)
build this one module.
"""

from __future__ import annotations

import re
from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dexiraft_tpu_torch.models.layers import (DEXINED_ROOT, BatchNorm2d,
                                              seeded_init_)

# torch ConvTranspose2d paddings per up_scale: output (in-1)*2 - 2p + k = 2*in
_UPCONV_PAD = {1: 0, 2: 1, 3: 3, 4: 7}


FUSIONS = ("cat", "cofusion")

# the names of the conv biases that feed a BatchNorm: the BatchNorm
# subtracts the batch mean, so their gradients are zero in exact
# arithmetic and rounding noise in any implementation (no two agree)
PRE_BN_BIAS = re.compile(r"^((block|side|pre_dense)_\d\.conv\d?"
                         r"|dblock_\d\.denselayer\d\.conv\d)\.bias$")


def _bn(planes: int) -> BatchNorm2d:
    # flax momentum 0.9 (the running stats' weight) is torch's 0.1
    return BatchNorm2d(planes, eps=1e-5, momentum=0.1)


class DoubleConvBlock(nn.Module):
    """conv3x3(stride) + BN + relu -> conv3x3 + BN (+ relu)."""

    def __init__(self, in_features: int, mid_features: int,
                 out_features: Optional[int] = None, stride: int = 1,
                 use_act: bool = True):
        super().__init__()
        out_features = out_features or mid_features
        self.use_act = use_act
        self.conv1 = nn.Conv2d(in_features, mid_features, 3, padding=1,
                               stride=stride)
        self.bn1 = _bn(mid_features)
        self.conv2 = nn.Conv2d(mid_features, out_features, 3, padding=1)
        self.bn2 = _bn(out_features)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.bn2(self.conv2(x))
        return F.relu(x) if self.use_act else x


class SingleConvBlock(nn.Module):
    """1x1 conv (+ BN). The BN exists even when unused (``block_cat``)."""

    def __init__(self, in_features: int, out_features: int, stride: int = 1,
                 use_bn: bool = True):
        super().__init__()
        self.use_bn = use_bn
        self.conv = nn.Conv2d(in_features, out_features, 1, stride=stride)
        self.bn = _bn(out_features)

    def forward(self, x):
        x = self.conv(x)
        return self.bn(x) if self.use_bn else x


class DenseLayer(nn.Module):
    """relu -> conv3x3 (pad 2) -> BN -> relu -> conv3x3 (pad 0) -> BN, then
    0.5 * (new + skip); the two paddings cancel, so the size is kept."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, out_features, 3, padding=2)
        self.norm1 = _bn(out_features)
        self.conv2 = nn.Conv2d(out_features, out_features, 3)
        self.norm2 = _bn(out_features)

    def forward(self, x1, x2):
        y = F.relu(self.norm1(self.conv1(F.relu(x1))))
        y = self.norm2(self.conv2(y))
        return 0.5 * (y + x2)


class DenseBlock(nn.Module):
    """Chain of DenseLayers (``denselayer1``...) sharing one skip input."""

    def __init__(self, num_layers: int, in_features: int, out_features: int):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"denselayer{i + 1}",
                            DenseLayer(in_features, out_features))
            in_features = out_features

    def forward(self, x1, x2):
        for layer in self.children():
            x1 = layer(x1, x2)
        return x1


class UpConvBlock(nn.Module):
    """``up_scale`` stages of 1x1 conv + relu + 2x transposed conv in one
    ``features`` Sequential (indices 0, 3, ... convs; 2, 5, ... transposed
    convs); width 16, the last stage 1 channel."""

    def __init__(self, in_features: int, up_scale: int):
        super().__init__()
        k = 2 ** up_scale
        pad = _UPCONV_PAD[up_scale]
        layers: List[nn.Module] = []
        for i in range(up_scale):
            out_features = 1 if i == up_scale - 1 else 16
            layers += [nn.Conv2d(in_features, out_features, 1),
                       nn.ReLU(inplace=True),
                       nn.ConvTranspose2d(out_features, out_features, k,
                                          stride=2, padding=pad)]
            in_features = out_features
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        return self.features(x)


class CoFusion(nn.Module):
    """Attention-weighted fusion over the stacked scale maps (JAX
    ``CoFusion``; the reference's ``CoFusion``, whose attribute names
    these are): two conv3x3(64) + GroupNorm(4) + relu stages, a
    conv3x3(``in_features``), a softmax over channels, then the
    attention-weighted sum of the input maps (a convex combination per
    pixel). (B, C, H, W) -> (B, 1, H, W)."""

    def __init__(self, in_features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, 64, 3, padding=1)
        self.conv2 = nn.Conv2d(64, 64, 3, padding=1)
        self.conv3 = nn.Conv2d(64, in_features, 3, padding=1)
        # flax GroupNorm's epsilon (torch's default is 1e-5)
        self.norm_layer1 = nn.GroupNorm(4, 64, eps=1e-6)
        self.norm_layer2 = nn.GroupNorm(4, 64, eps=1e-6)

    def forward(self, x):
        attn = F.relu(self.norm_layer1(self.conv1(x)))
        attn = F.relu(self.norm_layer2(self.conv2(attn)))
        attn = torch.softmax(self.conv3(attn), dim=1)
        return (x * attn).sum(dim=1, keepdim=True)


def _maxpool_3x3_s2(x):
    # output ceil(H / 2), as the JAX max_pool with padding 1
    return F.max_pool2d(x, 3, stride=2, padding=1)


class DexiNed(nn.Module):
    """The full network; a (B, 3, H, W) batch -> 7 logit maps. ``fusion``
    picks the final head (module docstring); another value raises."""

    def __init__(self, fusion: str = "cat"):
        super().__init__()
        if fusion not in FUSIONS:
            raise ValueError(f"unknown fusion {fusion!r}; "
                             "expected 'cat' or 'cofusion'")
        self.fusion = fusion
        self.block_1 = DoubleConvBlock(3, 32, 64, stride=2)
        self.block_2 = DoubleConvBlock(64, 128, use_act=False)
        self.dblock_3 = DenseBlock(2, 128, 256)
        self.dblock_4 = DenseBlock(3, 256, 512)
        self.dblock_5 = DenseBlock(3, 512, 512)
        self.dblock_6 = DenseBlock(3, 512, 256)
        # left skip connections
        self.side_1 = SingleConvBlock(64, 128, 2)
        self.side_2 = SingleConvBlock(128, 256, 2)
        self.side_3 = SingleConvBlock(256, 512, 2)
        self.side_4 = SingleConvBlock(512, 512, 1)
        self.side_5 = SingleConvBlock(512, 256, 1)  # built, never called
        # right skip connections
        self.pre_dense_3 = SingleConvBlock(128, 256, 1)
        self.pre_dense_4 = SingleConvBlock(256, 512, 1)
        self.pre_dense_5 = SingleConvBlock(512, 512, 1)
        self.pre_dense_6 = SingleConvBlock(512, 256, 1)
        self.up_block_1 = UpConvBlock(64, 1)
        self.up_block_2 = UpConvBlock(128, 1)
        self.up_block_3 = UpConvBlock(256, 2)
        self.up_block_4 = UpConvBlock(512, 3)
        self.up_block_5 = UpConvBlock(512, 4)
        self.up_block_6 = UpConvBlock(256, 4)
        self.block_cat = (CoFusion(6) if fusion == "cofusion"
                          else SingleConvBlock(6, 1, 1, use_bn=False))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        block_1 = self.block_1(x)
        block_1_side = self.side_1(block_1)

        block_2 = self.block_2(block_1)
        block_2_down = _maxpool_3x3_s2(block_2)
        block_2_add = block_2_down + block_1_side
        block_2_side = self.side_2(block_2_add)

        block_3 = self.dblock_3(block_2_add, self.pre_dense_3(block_2_down))
        block_3_down = _maxpool_3x3_s2(block_3)
        block_3_add = block_3_down + block_2_side
        block_3_side = self.side_3(block_3_add)

        block_4 = self.dblock_4(block_3_add, self.pre_dense_4(block_3_down))
        block_4_down = _maxpool_3x3_s2(block_4)
        block_4_add = block_4_down + block_3_side
        block_4_side = self.side_4(block_4_add)

        block_5 = self.dblock_5(block_4_add, self.pre_dense_5(block_4_down))
        block_5_add = block_5 + block_4_side

        block_6 = self.dblock_6(block_5_add, self.pre_dense_6(block_5))

        out_1 = self.up_block_1(block_1)
        out_2 = self.up_block_2(block_2)
        out_3 = self.up_block_3(block_3)
        out_4 = self.up_block_4(block_4)
        out_5 = self.up_block_5(block_5)
        out_6 = self.up_block_6(block_6)

        # the deepest outputs overshoot when H or W is not a multiple of 16;
        # they are cropped by dropping the FIRST rows/columns (not centred)
        h, w = out_1.shape[2:]
        if tuple(out_5.shape[2:]) != (h, w):
            h_off = out_5.shape[2] - h
            w_off = out_5.shape[3] - w
            if h_off < 0 or w_off < 0:
                raise ValueError(f"DexiNed scale-5 output {tuple(out_5.shape)} "
                                 f"is smaller than the input's {(h, w)}")
            out_5 = out_5[:, :, h_off:h_off + h, w_off:w_off + w]
            out_6 = out_6[:, :, h_off:h_off + h, w_off:w_off + w]

        results = [out_1, out_2, out_3, out_4, out_5, out_6]
        results.append(self.block_cat(torch.cat(results, dim=1)))
        return results


def create_dexined(seed: int = 0, fusion: str = "cat") -> DexiNed:
    """A standalone DexiNed on the CPU with the JAX package's DexiNed init
    drawn from ``seed``: Xavier-normal convs, normal(0.1) for a
    one-channel transposed conv, zero biases, identity norms
    (``models.layers.seeded_init_``'s branch for the module path RAFT
    gives the network)."""
    model = DexiNed(fusion)
    seeded_init_(nn.ModuleDict({DEXINED_ROOT: model}),
                 torch.Generator().manual_seed(seed))
    return model


def stack_edge_maps(outputs: List[torch.Tensor]) -> torch.Tensor:
    """DexiNed's 7 per-scale (B, 1, H, W) logit maps -> (B, 7, H, W)."""
    return torch.cat(outputs, dim=1)

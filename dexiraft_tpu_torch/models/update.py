"""Update operators: motion encoders, ConvGRU cells, flow and mask heads,
and v3's RefineFlow fusion head.

Counterpart of ``dexiraft_tpu/models/update.py`` in NCHW with the
reference's torch attribute names (``encoder.convc1``, ``gru.convz1``,
``flow_head.conv1``, ``mask.0``, ``mask.2``, ...).

The motion encoders own the fused refinement-step seam: their ``convc1``
(the 1x1 conv over the correlation features) is a per-pixel matmul, so
with ``pyr``/``coords`` given it runs inside the pyramid's fused kernel
(ops/corr_kernels.flash_fused_step, B1, or pallas_fused_step, B3, as
``pyr.kernel`` says, like the JAX ``FusedCorrEncoder``) and the
correlation features are never written out. The parameters are the same
``nn.Conv2d`` either way, so one state dict serves the fused and the
unfused path. On the fused path:

  (a) convc1's weight is taken as (L*(2r+1)^2, F);
  (b) the kernel applies 1/sqrt(C) itself;
  (c) per-level int8 scales are folded into the weight rows here;
  (d) the relu comes after the kernel.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from dexiraft_tpu_torch.ops.corr_kernels import FUSED_STEPS


def fused_corr_conv(conv: nn.Conv2d, pyr, coords: torch.Tensor) -> torch.Tensor:
    """convc1 over the pyramid's windows at ``coords`` (B, H, W, 2, level-0
    pixels), computed by the fused kernel of ``pyr.kernel`` -> (B, F, H, W),
    pre-activation."""
    if pyr.kernel not in FUSED_STEPS:
        raise ValueError(f"the {pyr.kernel!r} lookup has no fused kernel; "
                         f"expected one of {tuple(FUSED_STEPS)}")
    feat = conv.out_channels
    w = conv.weight.reshape(feat, -1).t()  # (L * (2r+1)^2, F)
    if pyr.scales is not None:
        kk = w.shape[0] // len(pyr.fmap2_pyramid)
        w = torch.cat([w[lvl * kk:(lvl + 1) * kk] * pyr.scales[lvl]
                       for lvl in range(len(pyr.fmap2_pyramid))], dim=0)
    out = FUSED_STEPS[pyr.kernel](pyr.fmap1, pyr.fmap2_pyramid, coords,
                                  w.to(torch.float32),
                                  conv.bias.to(torch.float32), pyr.radius,
                                  pyr.row_chunk)
    return out.permute(0, 3, 1, 2)


class FlowHead(nn.Module):
    """conv3x3 -> relu -> conv3x3 to a 2-channel flow delta."""

    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class ConvGRU(nn.Module):
    """3x3 convolutional GRU."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 192 + 128):
        super().__init__()
        self.convz = nn.Conv2d(hidden_dim + input_dim, hidden_dim, 3, padding=1)
        self.convr = nn.Conv2d(hidden_dim + input_dim, hidden_dim, 3, padding=1)
        self.convq = nn.Conv2d(hidden_dim + input_dim, hidden_dim, 3, padding=1)

    def forward(self, h, x):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q


class SepConvGRU(nn.Module):
    """Separable GRU: a (1,5) horizontal pass then a (5,1) vertical pass."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 192 + 128):
        super().__init__()
        c = hidden_dim + input_dim
        self.convz1 = nn.Conv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convr1 = nn.Conv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convq1 = nn.Conv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convz2 = nn.Conv2d(c, hidden_dim, (5, 1), padding=(2, 0))
        self.convr2 = nn.Conv2d(c, hidden_dim, (5, 1), padding=(2, 0))
        self.convq2 = nn.Conv2d(c, hidden_dim, (5, 1), padding=(2, 0))

    @staticmethod
    def _pass(h, x, convz, convr, convq):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(convz(hx))
        r = torch.sigmoid(convr(hx))
        q = torch.tanh(convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q

    def forward(self, h, x):
        h = self._pass(h, x, self.convz1, self.convr1, self.convq1)
        return self._pass(h, x, self.convz2, self.convr2, self.convq2)


class SmallMotionEncoder(nn.Module):
    """(corr, flow) -> 82-channel motion features."""

    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_planes, 96, 1)
        self.convf1 = nn.Conv2d(2, 64, 7, padding=3)
        self.convf2 = nn.Conv2d(64, 32, 3, padding=1)
        self.conv = nn.Conv2d(128, 80, 3, padding=1)

    def forward(self, flow, corr, pyr=None, coords=None):
        if pyr is not None:
            cor = F.relu(fused_corr_conv(self.convc1, pyr, coords))
        else:
            cor = F.relu(self.convc1(corr))
        flo = F.relu(self.convf1(flow))
        flo = F.relu(self.convf2(flo))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class BasicMotionEncoder(nn.Module):
    """(corr, flow) -> 128-channel motion features."""

    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr, pyr=None, coords=None):
        if pyr is not None:
            cor = F.relu(fused_corr_conv(self.convc1, pyr, coords))
        else:
            cor = F.relu(self.convc1(corr))
        cor = F.relu(self.convc2(cor))
        flo = F.relu(self.convf1(flow))
        flo = F.relu(self.convf2(flo))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SmallUpdateBlock(nn.Module):
    """Motion encoder + ConvGRU + flow head; no upsampling mask."""

    def __init__(self, corr_planes: int, hidden_dim: int = 96):
        super().__init__()
        self.encoder = SmallMotionEncoder(corr_planes)
        self.gru = ConvGRU(hidden_dim=hidden_dim, input_dim=82 + 64)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=128)

    def forward(self, net, inp, corr, flow, pyr=None, coords=None):
        motion = self.encoder(flow, corr, pyr=pyr, coords=coords)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, None, self.flow_head(net)


class BasicUpdateBlock(nn.Module):
    """Motion encoder + SepConvGRU + flow head + convex-upsampling mask head
    (576 = 9 taps x 8 x 8 sub-pixels, logits scaled by 0.25)."""

    def __init__(self, corr_planes: int, hidden_dim: int = 128,
                 input_dim: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes)
        self.gru = SepConvGRU(hidden_dim=hidden_dim,
                              input_dim=input_dim + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=256)
        self.mask = nn.Sequential(
            nn.Conv2d(hidden_dim, 256, 3, padding=1),
            nn.ReLU(inplace=True),
            nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow, pyr=None, coords=None):
        motion = self.encoder(flow, corr, pyr=pyr, coords=coords)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        delta_flow = self.flow_head(net)
        mask = 0.25 * self.mask(net)
        return net, mask, delta_flow


class RefineFlow(nn.Module):
    """v3's fusion head: a 1x1 conv of cat(flow_up, eflow_up), 4 channels,
    to the refined 2-channel flow. The reference's conv maps 4 channels to
    1, which cannot be a flow; the JAX package corrects it to 4 -> 2, and
    so does the port."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(4, 2, 1)

    def forward(self, flow_up, eflow_up):
        return self.conv(torch.cat([flow_up, eflow_up], dim=1))

"""RAFT, the iterative optical-flow estimator, in PyTorch.

Counterpart of ``dexiraft_tpu/models/raft.py`` in test mode on a frame
pair, for two variants:

  * v1 (``variant="raft"``): the feature and context encoders, the pooled
    fmap2 pyramid, a fixed number of refinement iterations (lookup ->
    update block -> coords1 += delta) and one upsampling of the final flow;
  * v5 (``variant="dual", embed_dexined=True``): v1 plus the frozen
    embedded DexiNed, run on both frames in one batched call, whose 7
    stacked logit maps feed the edge encoders ``efnet``/``ecnet``. Both
    streams ride one batch axis of 2B: one pyramid over the concatenated
    image and edge features, one lookup and one shared update block per
    iteration, and the coupled update ``ic += d_img + d_edge``,
    ``ec += d_edge``. ``flow_init`` offsets only the image stream, and the
    output comes from the image stream's rows ``[:B]``.

Images and flows are NCHW, as in the reference torch model; the
correlation lookup works on NHWC feature maps (one pixel's channels are
contiguous for the kernel), converted once per forward. The other
variants, training mode and the adaptive loop are not ported yet and are
refused.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from dexiraft_tpu_torch.config import PORTED_CORR_IMPLS, RAFTConfig
from dexiraft_tpu_torch.device import resolve_device
from dexiraft_tpu_torch.models.dexined import DexiNed, stack_edge_maps
from dexiraft_tpu_torch.models.extractor import BasicEncoder, SmallEncoder
from dexiraft_tpu_torch.models.layers import seeded_init_
from dexiraft_tpu_torch.models.update import BasicUpdateBlock, SmallUpdateBlock
from dexiraft_tpu_torch.ops.grid import coords_grid, upflow8
from dexiraft_tpu_torch.ops.local_corr import build_local_corr
from dexiraft_tpu_torch.ops.upsample import upsample_flow_convex_nchw


def _normalize(img: torch.Tensor) -> torch.Tensor:
    """[0, 255] -> [-1, 1]."""
    return 2.0 * (img / 255.0) - 1.0


# (variant, embed_dexined) pairs the port runs: v1 and v5
PORTED_VARIANTS = (("raft", False), ("dual", True))

# DexiNed's logit maps, the edge encoders' input channels
EDGE_CHANNELS = 7


class RAFT(nn.Module):
    """v1 or v5 RAFT with the reference's torch attribute names (``fnet``,
    ``cnet``, ``efnet``, ``ecnet``, ``update_block``, ``dexined``), so
    converted weights load strictly."""

    def __init__(self, cfg: RAFTConfig = RAFTConfig()):
        super().__init__()
        if (cfg.variant, cfg.embed_dexined) not in PORTED_VARIANTS:
            raise ValueError(
                f"variant {cfg.variant!r} (embed_dexined={cfg.embed_dexined}) "
                "is not ported to PyTorch yet; the port runs v1 "
                "(variant='raft') and v5 (variant='dual', "
                "embed_dexined=True)")
        if cfg.corr_impl not in PORTED_CORR_IMPLS:
            raise ValueError(
                f"corr_impl {cfg.corr_impl!r} is not ported to PyTorch yet; "
                f"expected one of {PORTED_CORR_IMPLS}")
        self.cfg = cfg
        encoder = SmallEncoder if cfg.small else BasicEncoder
        self.fnet = encoder(cfg.fnet_dim, "instance", cfg.dropout)
        self.cnet = encoder(cfg.hidden_dim + cfg.context_dim,
                            "none" if cfg.small else "batch", cfg.dropout)
        if cfg.has_edge_stream:
            self.efnet = encoder(cfg.fnet_dim, "instance", cfg.dropout,
                                 EDGE_CHANNELS)
            self.ecnet = encoder(cfg.hidden_dim + cfg.context_dim,
                                 "none" if cfg.small else "batch",
                                 cfg.dropout, EDGE_CHANNELS)
        if cfg.small:
            self.update_block = SmallUpdateBlock(cfg.corr_planes, cfg.hidden_dim)
        else:
            self.update_block = BasicUpdateBlock(cfg.corr_planes, cfg.hidden_dim,
                                                 cfg.context_dim)
        if cfg.embed_dexined:
            self.dexined = DexiNed()

    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                iters: int = 12, flow_init: Optional[torch.Tensor] = None,
                test_mode: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Flow between two (B, 3, H, W) frames in [0, 255], H and W
        multiples of 8. flow_init: (B, 2, H/8, W/8) or None (for v5 it
        offsets the image stream only).

        Returns (flow_low (B, 2, H/8, W/8), flow_up (B, 2, H, W)).
        """
        if not test_mode:
            raise ValueError("training mode is not ported to PyTorch yet; "
                             "call with test_mode=True")
        if self.training:
            raise ValueError("the port runs inference only; call .eval() "
                             "first (BatchNorm uses its running stats)")
        cfg = self.cfg
        hdim = cfg.hidden_dim
        image1 = _normalize(image1.to(torch.float32))
        image2 = _normalize(image2.to(torch.float32))

        fmap1, fmap2 = self.fnet([image1, image2])
        ctx = self.cnet(image1)
        net = torch.tanh(ctx[:, :hdim])
        inp = F.relu(ctx[:, hdim:])
        b, _, h8, w8 = fmap1.shape
        coords0 = coords_grid(b, h8, w8, device=fmap1.device)
        coords1 = coords0.clone()
        if flow_init is not None:
            coords1 = coords1 + flow_init.permute(0, 2, 3, 1)

        dual = cfg.has_edge_stream
        if dual:
            # frozen edge extraction on both frames in one call: raw logits
            with torch.no_grad():
                edges = stack_edge_maps(
                    self.dexined(torch.cat([image1, image2], dim=0)))
            em1, em2 = edges.chunk(2, dim=0)
            efmap1, efmap2 = self.efnet([em1, em2])
            ectx = self.ecnet(em1)
            # both streams on one batch axis: image rows [:B], edge [B:]
            fmap1 = torch.cat([fmap1, efmap1], dim=0)
            fmap2 = torch.cat([fmap2, efmap2], dim=0)
            net = torch.cat([net, torch.tanh(ectx[:, :hdim])], dim=0)
            inp = torch.cat([inp, F.relu(ectx[:, hdim:])], dim=0)
            coords1 = torch.cat([coords1, coords0], dim=0)
        base = torch.cat([coords0, coords0], dim=0) if dual else coords0

        # the lookup's layout: NHWC, one pixel's channels contiguous
        pyr = build_local_corr(
            fmap1.permute(0, 2, 3, 1), fmap2.permute(0, 2, 3, 1),
            cfg.corr_levels, cfg.radius, row_chunk=cfg.corr_row_chunk,
            dtype=cfg.corr_dtype,
            kernel="plain" if cfg.corr_impl == "local" else cfg.corr_impl)

        mask = None
        for _ in range(iters):
            coords1 = coords1.detach()
            flow = (coords1 - base).permute(0, 3, 1, 2)
            if cfg.fused_update:
                net, mask, delta = self.update_block(net, inp, None, flow,
                                                     pyr=pyr, coords=coords1)
            else:
                corr = pyr(coords1).permute(0, 3, 1, 2)
                net, mask, delta = self.update_block(net, inp, corr, flow)
            delta = delta.permute(0, 2, 3, 1)
            if dual:  # coupled update: edge deltas also move the image flow
                coords1 = torch.cat([coords1[:b] + delta[:b] + delta[b:],
                                     coords1[b:] + delta[b:]], dim=0)
            else:
                coords1 = coords1 + delta

        flow_low = (coords1[:b] - coords0).permute(0, 3, 1, 2)
        if cfg.small:
            flow_up = upflow8(flow_low.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        else:
            if mask is None:  # iters=0: the zero mask of the JAX carry
                mask = flow_low.new_zeros((b, 64 * 9, h8, w8))
            flow_up = upsample_flow_convex_nchw(flow_low, mask[:b])
        return flow_low.contiguous(), flow_up.contiguous()


def create_model(cfg: RAFTConfig, seed: int = 0,
                 device: Union[str, torch.device] = "cuda") -> RAFT:
    """A v1 or v5 RAFT with seeded random weights, in eval mode on
    ``device``."""
    dev = resolve_device(device)
    model = RAFT(cfg)
    seeded_init_(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()

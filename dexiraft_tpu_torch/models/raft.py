"""RAFT, the iterative optical-flow estimator, in PyTorch.

Counterpart of ``dexiraft_tpu/models/raft.py`` in test mode, for the five
experiment variants:

  * v1 (``variant="raft"``): the feature and context encoders, the pooled
    fmap2 pyramid, the refinement iterations (lookup -> update block ->
    coords1 += delta) and one upsampling of the final flow;
  * v2 (``variant="early"``): v1 on 6 input channels, the normalized image
    and the normalized data-supplied edge image (``edges1``/``edges2``,
    (B, 3, H, W) in [0, 255]);
  * v3 (``variant="separate"``): a second, edge stream of data-supplied
    edge images through the SAME ``fnet``/``cnet``, decoupled updates
    (``ic += d_img``, ``ec += d_edge``), and the ``RefineFlow`` head over
    both streams' upsampled final flows;
  * v4 (``variant="early", embed_dexined=True``): v1 on 10 input channels,
    the normalized image and the frozen embedded DexiNed's 7 raw logit
    maps;
  * v5 (``variant="dual", embed_dexined=True``): a dual stream whose edge
    encoders ``efnet``/``ecnet`` read DexiNed's logit maps, one shared
    update block and the coupled update ``ic += d_img + d_edge``,
    ``ec += d_edge``.

In v3 and v5 both streams ride one batch axis of 2B: one pyramid over the
concatenated image and edge features, one lookup and one update-block call
per iteration. ``flow_init`` offsets only the image stream, and the output
comes from the image stream's rows ``[:B]``.

Three entry modes share one set of parameters, as in the JAX package: the
pair forward (``forward``), the per-frame encoder stage
(``encode_frame``: everything a frame contributes to any pair it joins,
``ctx`` included) and the refinement from two such feature dicts
(``refine``); the pair forward is their composition, with both frames in
one batched encoder call. ``adaptive=True`` runs the refinement under a
per-item convergence gate (``refine``'s docstring).

Images and flows are NCHW, as in the reference torch model; the
correlation lookup works on NHWC feature maps (one pixel's channels are
contiguous for the kernel). Training mode is not ported yet and is
refused.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from dexiraft_tpu_torch.config import PORTED_CORR_IMPLS, RAFTConfig
from dexiraft_tpu_torch.device import resolve_device
from dexiraft_tpu_torch.models.dexined import DexiNed, stack_edge_maps
from dexiraft_tpu_torch.models.extractor import BasicEncoder, SmallEncoder
from dexiraft_tpu_torch.models.layers import seeded_init_
from dexiraft_tpu_torch.models.update import (BasicUpdateBlock, RefineFlow,
                                              SmallUpdateBlock)
from dexiraft_tpu_torch.ops.grid import coords_grid, upflow8
from dexiraft_tpu_torch.ops.local_corr import build_local_corr
from dexiraft_tpu_torch.ops.upsample import upsample_flow_convex_nchw

Features = Dict[str, torch.Tensor]


def _normalize(img: torch.Tensor) -> torch.Tensor:
    """[0, 255] -> [-1, 1]."""
    return 2.0 * (img / 255.0) - 1.0


# (variant, embed_dexined) of the five experiment variants, v1 to v5
PORTED_VARIANTS = (("raft", False), ("early", False), ("separate", False),
                   ("early", True), ("dual", True))

# DexiNed's logit maps, v5's edge-encoder input channels
EDGE_CHANNELS = 7


class RAFT(nn.Module):
    """RAFT v1-v5 with the reference's torch attribute names (``fnet``,
    ``cnet``, ``efnet``, ``ecnet``, ``update_block``, ``dexined``; v3's
    head is ``refine_flow``), so converted weights load strictly. v3's edge
    stream calls ``fnet``/``cnet`` again: it registers no second key set."""

    def __init__(self, cfg: RAFTConfig = RAFTConfig()):
        super().__init__()
        if cfg.variant == "dual" and not cfg.embed_dexined:
            raise ValueError(
                "variant='dual' requires embed_dexined=True (the v5 edge "
                "stream consumes DexiNed's 7 logit maps; use raft_v5())")
        if (cfg.variant, cfg.embed_dexined) not in PORTED_VARIANTS:
            raise ValueError(
                f"variant {cfg.variant!r} with embed_dexined="
                f"{cfg.embed_dexined} is none of the five experiment "
                "variants (raft_v1 ... raft_v5 in config.py)")
        if cfg.corr_impl not in PORTED_CORR_IMPLS:
            raise ValueError(
                f"corr_impl {cfg.corr_impl!r} is not ported to PyTorch yet "
                "(the all-pairs path is ROADMAP A9); "
                f"expected one of {PORTED_CORR_IMPLS}")
        self.cfg = cfg
        encoder = SmallEncoder if cfg.small else BasicEncoder
        ctx_norm = "none" if cfg.small else "batch"
        ctx_dim = cfg.hidden_dim + cfg.context_dim
        self.fnet = encoder(cfg.fnet_dim, "instance", cfg.dropout,
                            cfg.image_channels)
        self.cnet = encoder(ctx_dim, ctx_norm, cfg.dropout, cfg.image_channels)
        if cfg.variant == "dual":
            self.efnet = encoder(cfg.fnet_dim, "instance", cfg.dropout,
                                 EDGE_CHANNELS)
            self.ecnet = encoder(ctx_dim, ctx_norm, cfg.dropout, EDGE_CHANNELS)
        if cfg.small:
            self.update_block = SmallUpdateBlock(cfg.corr_planes, cfg.hidden_dim)
        else:
            self.update_block = BasicUpdateBlock(cfg.corr_planes, cfg.hidden_dim,
                                                 cfg.context_dim)
        if cfg.variant == "separate":
            self.refine_flow = RefineFlow()
        if cfg.embed_dexined:
            self.dexined = DexiNed()

    # ---- encoder stage ---------------------------------------------------

    def _edge_encoders(self):
        if self.cfg.variant == "dual":
            return self.efnet, self.ecnet
        return self.fnet, self.cnet  # v3: shared with the image stream

    def _edge_input(self, images: torch.Tensor, edges, missing: str):
        """The edge input of the (normalized) ``images``: DexiNed's raw
        logit maps (v4/v5, frozen), the normalized data edges (v2/v3), or
        None (v1)."""
        cfg = self.cfg
        if cfg.embed_dexined:
            with torch.no_grad():
                return stack_edge_maps(self.dexined(images))
        if cfg.variant in ("early", "separate"):
            if edges is None:
                raise ValueError(
                    f"variant {cfg.variant!r} without embed_dexined requires "
                    f"{missing}")
            return _normalize(edges.to(torch.float32))
        return None

    def encode_frame(self, image: torch.Tensor,
                     edges: Optional[torch.Tensor] = None) -> Features:
        """Per-frame encoder stage (JAX ``mode="encode"``) of a (B, 3, H, W)
        frame in [0, 255] (v2/v3: with its (B, 3, H, W) edge image) ->
        ``{fmap, ctx[, efmap, ectx]}``, NCHW at 1/8 resolution. ``ctx`` is
        computed unconditionally: the frame is the later frame of one pair
        and the earlier frame of the next."""
        cfg = self.cfg
        image = _normalize(image.to(torch.float32))
        em = self._edge_input(
            image, edges, "a data-supplied edge frame in mode='encode'")
        if cfg.variant == "early":
            image, em = torch.cat([image, em], dim=1), None
        out = {"fmap": self.fnet(image), "ctx": self.cnet(image)}
        if cfg.has_edge_stream:
            efnet, ecnet = self._edge_encoders()
            out["efmap"] = efnet(em)
            out["ectx"] = ecnet(em)
        return out

    def _encode_pair(self, image1: torch.Tensor, image2: torch.Tensor,
                    edges1: Optional[torch.Tensor] = None,
                    edges2: Optional[torch.Tensor] = None
                    ) -> Tuple[Features, Features]:
        """The pair forward's encoder stage: both frames through one
        batched call per encoder (and one DexiNed call). Only frame 1's
        dict carries ``ctx``/``ectx`` (the GRU seeds from the earlier
        frame)."""
        cfg = self.cfg
        image1 = _normalize(image1.to(torch.float32))
        image2 = _normalize(image2.to(torch.float32))
        edges = (None if edges1 is None or edges2 is None
                 else torch.cat([edges1, edges2], dim=0))
        em1 = em2 = None
        em = self._edge_input(torch.cat([image1, image2], dim=0), edges,
                              "data-supplied edges1/edges2")
        if em is not None:
            em1, em2 = em.chunk(2, dim=0)
        if cfg.variant == "early":
            image1 = torch.cat([image1, em1], dim=1)
            image2 = torch.cat([image2, em2], dim=1)
        fmap1, fmap2 = self.fnet([image1, image2])
        f1 = {"fmap": fmap1, "ctx": self.cnet(image1)}
        f2 = {"fmap": fmap2}
        if cfg.has_edge_stream:
            efnet, ecnet = self._edge_encoders()
            f1["efmap"], f2["efmap"] = efnet([em1, em2])
            f1["ectx"] = ecnet(em1)
        return f1, f2

    # ---- refinement stage ------------------------------------------------

    def _check_adaptive(self, adaptive: bool) -> None:
        if adaptive and self.cfg.variant == "separate":
            raise ValueError(
                "adaptive=True does not support variant='separate': "
                "its RefineFlow fusion head lives INSIDE the scanned "
                "step (emit=True even in test mode, models/raft.py) "
                "and the adaptive while_loop drives the non-emitting "
                "step; use v1/v2/v4/v5 or the fixed-iters path")

    def _step(self, pyr, inp, base, coords1, net, b):
        """One refinement iteration over the whole (B or 2B) batch ->
        (coords1, net, up_mask)."""
        cfg = self.cfg
        coords1 = coords1.detach()
        flow = (coords1 - base).permute(0, 3, 1, 2)
        if cfg.fused_update:
            net, mask, delta = self.update_block(net, inp, None, flow,
                                                 pyr=pyr, coords=coords1)
        else:
            corr = pyr(coords1).permute(0, 3, 1, 2)
            net, mask, delta = self.update_block(net, inp, corr, flow)
        delta = delta.permute(0, 2, 3, 1)
        if cfg.variant == "dual":  # coupled: edge deltas move the image flow
            coords1 = torch.cat([coords1[:b] + delta[:b] + delta[b:],
                                 coords1[b:] + delta[b:]], dim=0)
        else:  # one stream, or v3's decoupled rows: each row its own delta
            coords1 = coords1 + delta
        return coords1, net, mask

    def _upsample(self, flow: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
        if mask is None:  # the small model has no mask head
            return upflow8(flow.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return upsample_flow_convex_nchw(flow, mask)

    def _outputs(self, coords1, coords0, mask, b):
        flow_low = (coords1[:b] - coords0).permute(0, 3, 1, 2)
        flow_up = self._upsample(flow_low, None if mask is None else mask[:b])
        if self.cfg.variant == "separate":
            eflow = (coords1[b:] - coords0).permute(0, 3, 1, 2)
            flow_up = self.refine_flow(
                flow_up, self._upsample(eflow,
                                        None if mask is None else mask[b:]))
        return flow_low.contiguous(), flow_up.contiguous()

    def refine(self, features1: Features, features2: Features,
               iters: int = 12, flow_init: Optional[torch.Tensor] = None,
               adaptive: bool = False, iter_budget: Optional[int] = None,
               exit_check_every: int = 1):
        """Refinement from two feature dicts (JAX ``mode="step"``):
        ``features1`` is the earlier frame's (its ``ctx`` seeds the GRU).
        flow_init: (B, 2, H/8, W/8) or None. Returns (flow_low (B, 2, H/8,
        W/8), flow_up (B, 2, H, W)).

        ``adaptive=True``: the same step runs under a per-item ``done``
        mask. After each update the item's image-stream 1/8-res flow delta
        reduces to a mean per-pixel L2 norm ``dn``; once ``dn <
        cfg.converge_tol`` (strict, so tol 0 never fires) the item is done
        and later iterations keep its whole carry (coords1, net, up_mask;
        in v5 the edge row with its image row) by a select. The loop ends
        when every item is done or ``iter_budget`` (clamped to [0,
        iters]; None = iters) is spent. Whether every item is done is a
        host read, made before every ``exit_check_every``-th iteration;
        since iterations after the last item is done change nothing,
        reading less often gives the same result. Returns (flow_low,
        flow_up, iters_used (B,) int32, final_delta (B,) float32): the
        updates each item applied and its last applied ``dn`` (0 when no
        update ran).
        """
        cfg = self.cfg
        self._check_adaptive(adaptive)
        hdim = cfg.hidden_dim
        fmap1, fmap2 = features1["fmap"], features2["fmap"]
        ctx = features1["ctx"]
        net = torch.tanh(ctx[:, :hdim])
        inp = F.relu(ctx[:, hdim:])
        b, _, h8, w8 = fmap1.shape
        coords0 = coords_grid(b, h8, w8, device=fmap1.device)
        coords1 = coords0.clone()
        if flow_init is not None:
            coords1 = coords1 + flow_init.permute(0, 2, 3, 1)
        dual = cfg.has_edge_stream
        if dual:
            ectx = features1["ectx"]
            fmap1 = torch.cat([fmap1, features1["efmap"]], dim=0)
            fmap2 = torch.cat([fmap2, features2["efmap"]], dim=0)
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
        # iters=0 (or a frozen item) keeps the JAX carry's zero mask
        mask = None if cfg.small else fmap1.new_zeros(
            (fmap1.shape[0], 64 * 9, h8, w8))

        if not adaptive:
            for _ in range(iters):
                coords1, net, mask = self._step(pyr, inp, base, coords1, net, b)
            return self._outputs(coords1, coords0, mask, b)

        budget = iters if iter_budget is None else int(iter_budget)
        budget = min(max(budget, 0), iters)
        tol = cfg.converge_tol
        dev = coords1.device
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        iters_used = torch.zeros(b, dtype=torch.int32, device=dev)
        final_delta = torch.zeros(b, dtype=torch.float32, device=dev)
        for it in range(budget):
            if it and it % exit_check_every == 0 and bool(done.all()):
                break
            new_coords, new_net, new_mask = self._step(pyr, inp, base,
                                                       coords1, net, b)
            d = new_coords[:b] - coords1[:b]
            dn = d.square().sum(-1).sqrt().mean((1, 2))
            active = ~done
            rows = torch.cat([active, active]) if dual else active
            rows = rows[:, None, None, None]
            coords1 = torch.where(rows, new_coords, coords1)
            net = torch.where(rows, new_net, net)
            if mask is not None:
                mask = torch.where(rows, new_mask, mask)
            done = done | (dn < tol)
            iters_used = iters_used + active.to(torch.int32)
            final_delta = torch.where(active, dn, final_delta)
        flow_low, flow_up = self._outputs(coords1, coords0, mask, b)
        return flow_low, flow_up, iters_used, final_delta

    # ---- the entry point -------------------------------------------------

    def forward(self, image1: Optional[torch.Tensor] = None,
                image2: Optional[torch.Tensor] = None, iters: int = 12,
                flow_init: Optional[torch.Tensor] = None,
                test_mode: bool = True, *,
                edges1: Optional[torch.Tensor] = None,
                edges2: Optional[torch.Tensor] = None, mode: str = "pair",
                features1: Optional[Features] = None,
                features2: Optional[Features] = None,
                adaptive: bool = False, iter_budget: Optional[int] = None,
                exit_check_every: int = 1):
        """Flow between two (B, 3, H, W) frames in [0, 255], H and W
        multiples of 8; v2/v3 also take (B, 3, H, W) edge images
        ``edges1``/``edges2`` in [0, 255]. flow_init: (B, 2, H/8, W/8) or
        None (in v3/v5 it offsets the image stream only).

        ``mode="encode"`` returns ``encode_frame(image1, edges1)``;
        ``mode="step"`` refines from ``features1``/``features2`` and
        ignores the images. Returns (flow_low (B, 2, H/8, W/8), flow_up (B,
        2, H, W)), and with ``adaptive=True`` also iters_used and
        final_delta (``refine``).
        """
        if adaptive and not test_mode:
            raise ValueError(
                "adaptive=True is an inference path: it needs "
                "test_mode=True (the sequence loss consumes every "
                "iteration's prediction — early exit has no training "
                "meaning, and the scan+remat train path stays as-is)")
        self._check_adaptive(adaptive)
        if not adaptive and iter_budget is not None:
            raise ValueError(
                "iter_budget only has meaning with adaptive=True (the "
                "fixed path compiles its iteration count statically)")
        if not test_mode:
            raise ValueError("training mode is not ported to PyTorch yet; "
                             "call with test_mode=True")
        if self.training:
            raise ValueError("the port runs inference only; call .eval() "
                             "first (BatchNorm uses its running stats)")
        if mode == "encode":
            return self.encode_frame(image1, edges1)
        if mode == "step":
            if features1 is None or features2 is None:
                raise ValueError(
                    "mode='step' needs features1 AND features2 (per-frame "
                    "dicts from mode='encode'; features1 is the EARLIER "
                    "frame)")
        elif mode == "pair":
            if image1 is None or image2 is None:
                raise ValueError(
                    "mode='pair' needs image1 AND image2 (two (B, 3, H, W) "
                    "frames; mode='encode' takes one, mode='step' takes "
                    "feature dicts)")
            features1, features2 = self._encode_pair(image1, image2,
                                                    edges1, edges2)
        else:
            raise ValueError(f"unknown mode {mode!r}; expected "
                             "'pair' | 'encode' | 'step'")
        return self.refine(features1, features2, iters, flow_init,
                           adaptive=adaptive, iter_budget=iter_budget,
                           exit_check_every=exit_check_every)


def create_model(cfg: RAFTConfig, seed: int = 0,
                 device: Union[str, torch.device] = "cuda") -> RAFT:
    """A RAFT of any of the five variants with seeded random weights, in
    eval mode on ``device``."""
    dev = resolve_device(device)
    model = RAFT(cfg)
    seeded_init_(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()

"""Compute-sharded RAFT: image rows over a seq axis, explicit halo
exchange, per-block fsdp gathers.

The port of ``dexiraft_tpu/parallel/halo.py``. The fence-mode train step
(train/step.py) keeps fsdp a STORAGE axis: the parameters are gathered
at entry and every rank computes on whole images. This module is the
COMPUTE-sharded alternative, for frames whose all-pairs volume is too
large for one device. On a (data, fsdp, seq) mesh
(``parallel.layout.FsdpMesh`` with ``n_seq`` > 1):

  * each rank owns a contiguous slab of image rows (its seq index's
    block). Every conv exchanges exactly its own receptive-field rows
    with its seq neighbours (:func:`halo_exchange`) and convolves its own
    rows plus the halo: VALID in H, zero-padded in W. The first rank's
    top halo and the last rank's bottom halo arrive filled with zeros,
    which is the unsharded conv's zero padding, so the composition
    equals the unsharded chain row for row;
  * instance-norm moments are merged over seq (:func:`instance_norm`);
    frozen BatchNorm is a per-channel affine (:func:`frozen_bn`);
  * the correlation pyramid is a row block: this rank's queries against
    fmap2 gathered over seq (parallel/context.py);
  * parameters stay fsdp-sharded during compute: each block (fnet, cnet,
    the update block) gathers its sharded leaves right before it runs,
    inside ``torch.utils.checkpoint``, so at most one block is held
    gathered and the backward gathers it again (:class:`Block`).

Halo widths come from the conv chains declared next to the modules
(models/extractor.encoder_conv_chain, models/update.*_CHAIN), composed
by :func:`chain_halo` into :func:`halo_rows`, pinned by the tests. The
implementation exchanges per conv: (k, s, p) -> (lo = p, hi = max(0,
k - s - p)) rows, so a conv never moves more than its kernel's support.

The forward is written as functions over the port's own modules'
parameters (the same tensors, read by name; no second set of weights),
not as the modules' own forwards: the stock norms reduce over the local
slab only, which is wrong under row sharding. The price is JAX's support
matrix (:func:`check_halo_support`): v1, all-pairs fp32 correlation, no
dropout, noise or accumulation, BatchNorm frozen.

The exchange is an all-gather of the edge rows over the seq group (each
rank keeps its neighbours' rows), with an autograd rule that sends each
received row's gradient back to its owner. gloo cannot send CUDA tensors
point to point (``batch_isend_irecv`` fails on the card with "writev:
Bad address", torch 2.11; PERF.md), and ranks that share one card run
gloo; on two ranks the all-gather moves the bytes a swap would.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from dexiraft_tpu_torch.config import RAFTConfig, TrainConfig
from dexiraft_tpu_torch.models.extractor import (BottleneckBlock,
                                                 encoder_conv_chain)
from dexiraft_tpu_torch.models.layers import AllReduceSum
from dexiraft_tpu_torch.models.raft import RAFT, _dots_saveable, _normalize
from dexiraft_tpu_torch.models.update import (CONV_GRU_CHAIN,
                                              FLOW_HEAD_CHAIN,
                                              MASK_HEAD_CHAIN,
                                              MOTION_ENCODER_CHAIN,
                                              SEP_CONV_GRU_CHAIN)
from dexiraft_tpu_torch.ops.corr import corr_lookup
from dexiraft_tpu_torch.ops.grid import _resize_matrix, coords_grid
from dexiraft_tpu_torch.parallel.context import row_block_pyramid
from dexiraft_tpu_torch.parallel.fsdp import ShardPlan, all_gather_flat
from dexiraft_tpu_torch.parallel.layout import MeshAxis, has_seq

Chain = Tuple[Tuple[int, int, int], ...]  # ((kernel, stride, pad), ...)

#: the blocks the fsdp gather schedule runs one at a time, in forward
#: order (JAX's ``param_block_names``: fnet / cnet / ScanRAFTStep_0)
BLOCKS = ("fnet", "cnet", "update_block")


# ---- halo arithmetic ----------------------------------------------------


def chain_halo(chain: Chain) -> Tuple[int, int]:
    """(top, bottom) input-row margins one output row of the chain needs
    beyond the rows it owns. Walking the chain last conv to first: a
    conv (k, s, p) reads p rows above its first input row and max(0, k -
    s - p) below its last, and a downstream margin of m rows is s·m
    input rows through a stride-s conv."""
    lo = hi = 0
    for k, s, p in reversed(chain):
        lo = p + s * lo
        hi = max(0, k - s - p) + s * hi
    return lo, hi


def halo_rows() -> Dict[str, int]:
    """Per-module halo width (neighbour rows one rank needs, the larger
    margin) at the module's input resolution, from the declared conv
    chains. The convex upsampling and upflow8 read one coarse row past
    each slab edge (the 3x3 taps, the bilinear hat): pinned directly."""
    table = {
        "encoder_basic": chain_halo(encoder_conv_chain("residual")),
        "encoder_small": chain_halo(encoder_conv_chain("bottleneck")),
        "motion_encoder": chain_halo(MOTION_ENCODER_CHAIN),
        "gru_conv": chain_halo(CONV_GRU_CHAIN),
        "gru_sep": chain_halo(SEP_CONV_GRU_CHAIN),
        "flow_head": chain_halo(FLOW_HEAD_CHAIN),
        "mask_head": chain_halo(MASK_HEAD_CHAIN),
    }
    rows = {name: max(lo, hi) for name, (lo, hi) in table.items()}
    rows["upsample_convex"] = 1
    rows["upflow8"] = 1
    return rows


# ---- the exchange and the conv ------------------------------------------


def _swap(up: torch.Tensor, down: torch.Tensor, axis: MeshAxis
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each rank sends ``up`` to its seq predecessor and ``down`` to its
    successor: returns (the predecessor's ``down``, the successor's
    ``up``), zeros where there is none (the mesh edges). One all-gather
    of both over the seq group."""
    n, i = axis.size, axis.rank
    k = down.numel()
    every = all_gather_flat(torch.cat([down.reshape(-1), up.reshape(-1)]),
                            n, axis.group)
    from_prev = (every[i - 1, :k].view(down.shape) if i > 0
                 else down.new_zeros(down.shape))
    from_next = (every[i + 1, k:].view(up.shape) if i < n - 1
                 else up.new_zeros(up.shape))
    return from_prev, from_next


class _HaloExchange(torch.autograd.Function):
    """(N, C, L, W) slab -> (N, C, lo + L + hi, W): ``lo`` rows of the
    predecessor's bottom on top, ``hi`` rows of the successor's top
    below. The backward sends the gradient of each received row back to
    the rank that owns it, where it adds to that rank's edge rows."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, lo: int, hi: int, axis: MeshAxis):
        ctx.lo, ctx.hi, ctx.axis = lo, hi, axis
        rows = x.shape[2]
        top, bottom = _swap(x.narrow(2, 0, hi), x.narrow(2, rows - lo, lo),
                            axis)
        return torch.cat([top, x, bottom], dim=2)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        lo, hi = ctx.lo, ctx.hi
        rows = g.shape[2] - lo - hi
        gx = g.narrow(2, lo, rows).clone()
        # this rank's top halo came from the predecessor, its bottom halo
        # from the successor: their gradients go back the same way
        g_first, g_last = _swap(g.narrow(2, 0, lo),
                                g.narrow(2, lo + rows, hi), ctx.axis)
        gx.narrow(2, 0, hi).add_(g_first)
        gx.narrow(2, rows - lo, lo).add_(g_last)
        return gx, None, None, None


def halo_exchange(x: torch.Tensor, lo: int, hi: int, axis: MeshAxis
                  ) -> torch.Tensor:
    """Extend a (N, C, L, W) row slab with ``lo`` rows from the seq
    predecessor on top and ``hi`` from the successor below (module
    docstring); L must be at least ``max(lo, hi)``."""
    if axis.size <= 1 or (lo == 0 and hi == 0):
        return x
    if x.shape[2] < max(lo, hi):
        raise ValueError(f"a slab of {x.shape[2]} rows cannot give a halo "
                         f"of {max(lo, hi)} rows")
    return _HaloExchange.apply(x, lo, hi, axis)


def halo_conv(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor], axis: MeshAxis,
              stride: int = 1) -> torch.Tensor:
    """One NCHW conv (padding k // 2, as every conv of the model) on a
    row slab: exchange the kernel's own H support (lo = p, hi = max(0,
    k - s - p)), then convolve VALID in H and zero-padded in W. The
    output's L / stride rows are this rank's block of the unsharded
    conv's. A seq axis of one rank pads the zeros locally: the same
    program."""
    kh, kw = int(weight.shape[2]), int(weight.shape[3])
    p_h, p_w = kh // 2, kw // 2
    lo, hi = p_h, max(0, kh - stride - p_h)
    if lo or hi:
        if axis.size > 1:
            x = halo_exchange(x, lo, hi, axis)
        else:
            x = F.pad(x, (0, 0, lo, hi))
    return F.conv2d(x, weight, bias, stride, (0, p_w))


def instance_norm(x: torch.Tensor, axis: MeshAxis, eps: float = 1e-5
                  ) -> torch.Tensor:
    """Instance norm (per sample and channel over the WHOLE H x W) of a
    row slab. Each rank takes its slab's two-pass mean and sum of squared
    deviations; one all-reduce (whose backward is again a sum) gathers
    every rank's into a table (each rank fills its own row of zeros), and
    Chan's parallel rule merges them, as the port's BatchNorm merges the
    data axis (models/layers.py). JAX sums x and x² over seq and takes
    var = max(0, E[x²] - E[x]²); in torch's fp32 sums that form loses a
    channel whose mean dwarfs its spread, and put the halo step's encoder
    gradients outside tests/test_torch_halo.py's bounds at its random
    weights (3 rows of 1/8 resolution a rank), which the merge meets.
    The cross-rank sum associates otherwise than one reduction does:
    float-tolerance parity, not bitwise."""
    var, mean = torch.var_mean(x, dim=(2, 3), unbiased=False)
    if axis.size > 1:
        cnt = x.shape[2] * x.shape[3]
        row = torch.stack([mean, var * cnt])[None]  # (1, 2, N, C)
        table = AllReduceSum.apply(
            F.pad(row, (0, 0, 0, 0, 0, 0, axis.rank,
                        axis.size - 1 - axis.rank)), axis.group)
        means, m2 = table[:, 0], table[:, 1]
        mean = means.mean(dim=0)
        var = (m2.sum(dim=0) + cnt * (means - mean).square().sum(dim=0)) \
            / (cnt * axis.size)
    return (x - mean[..., None, None]) * torch.rsqrt(var + eps)[..., None, None]


def frozen_bn(x: torch.Tensor, bn, weight: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """BatchNorm on its running stats, a per-channel affine: the port's
    BatchNorm2d in eval mode, row for row."""
    return F.batch_norm(x, bn.running_mean, bn.running_var, weight, bias,
                        False, 0.0, bn.eps)


# ---- the per-block fsdp gather ------------------------------------------


class _GatherShards(torch.autograd.Function):
    """This rank's slices of a block's sharded leaves -> the whole
    leaves, one all-gather of one flat buffer over the fsdp group. The
    backward is JAX's all-gather transpose followed by its division: the
    whole gradient of each leaf summed over fsdp and cut to this rank's
    slice (a reduce-scatter), divided by n_fsdp (the fsdp ranks compute
    the same rows, so the sum holds n_fsdp copies of one gradient)."""

    @staticmethod
    def forward(ctx, axis: MeshAxis, dims: Tuple[int, ...], *slices):
        ctx.axis, ctx.dims, ctx.device = axis, dims, slices[0].device
        ctx.shapes = [tuple(s.shape) for s in slices]
        every = all_gather_flat(torch.cat([s.reshape(-1) for s in slices]),
                                axis.size, axis.group)
        out, offset = [], 0
        for s, dim in zip(slices, dims):
            part = every[:, offset:offset + s.numel()]
            out.append(torch.cat(part.reshape((axis.size,) + tuple(s.shape))
                                 .unbind(0), dim=dim))
            offset += s.numel()
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        import torch.distributed as dist

        axis = ctx.axis
        n = axis.size
        rows = []  # (n, slice numel) per leaf: slice k's gradient in row k
        for g, dim, shape in zip(grads, ctx.dims, ctx.shapes):
            if g is None:
                rows.append(torch.zeros((n, int(torch.Size(shape).numel())),
                                        device=ctx.device))
                continue
            rows.append(torch.stack(g.chunk(n, dim=dim)).reshape(n, -1))
        table = torch.cat(rows, dim=1)
        mine = table.new_empty(table.shape[1])
        dist.reduce_scatter_tensor(mine, table.reshape(-1), group=axis.group)
        mine.div_(n)
        out, offset = [], 0
        for shape in ctx.shapes:
            size = int(torch.Size(shape).numel())
            out.append(mine[offset:offset + size].view(shape))
            offset += size
        return (None, None) + tuple(out)


class Block:
    """One block of the model (``fnet``, ``cnet``, ``update_block``) as
    the halo forward reads it: its module (structure, buffers, config)
    and its parameters by name, relative to the block. Without an fsdp
    plan, or with no sharded leaf in the block, the parameters are the
    module's own; otherwise the sharded ones are this rank's slices
    (``plan``'s storage), gathered whole by :meth:`run` just before the
    block runs."""

    def __init__(self, model: RAFT, plan: Optional[ShardPlan], name: str):
        self.module = model.get_submodule(name)
        self.sharded: List[Tuple[Tuple[str, ...], object]] = []
        if plan is None:
            self.params = dict(self.module.named_parameters())
            return
        self.params: Dict[str, torch.Tensor] = {}
        self.fsdp = plan.mesh.fsdp
        prefix = name + "."
        for leaf in plan.leaves:
            names = tuple(k[len(prefix):] for k in leaf.keys
                          if k.startswith(prefix))
            if not names:
                continue
            if leaf.dim is None:
                for k in names:
                    self.params[k] = leaf.param
            else:
                self.sharded.append((names, leaf))

    def run(self, fn: Callable, *args):
        """``fn(params, *args)`` with the block's whole parameters; the
        sharded ones gathered inside ``torch.utils.checkpoint`` when
        autograd records (the gathered leaves are not kept: the backward
        gathers and recomputes), so one block at a time is whole."""
        if not self.sharded:
            return fn(self.params, *args)
        slices = [leaf.storage for _, leaf in self.sharded]
        dims = tuple(leaf.dim for _, leaf in self.sharded)
        k = len(slices)

        def gathered(*inputs):
            whole = _GatherShards.apply(self.fsdp, dims, *inputs[:k])
            params = dict(self.params)
            for (names, _), t in zip(self.sharded, whole):
                for name in names:
                    params[name] = t
            return fn(params, *inputs[k:])

        if torch.is_grad_enabled():
            return checkpoint(gathered, *slices, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return gathered(*slices, *args)


# ---- the model's modules as functions of their parameters --------------


def _conv(block: Block, p, name: str, x, axis: MeshAxis):
    conv = block.module.get_submodule(name)
    return halo_conv(x, p[f"{name}.weight"], p.get(f"{name}.bias"), axis,
                     stride=conv.stride[0])


def _norm(block: Block, p, norm_fn: str, name: str, x, axis: MeshAxis):
    if norm_fn == "instance":
        return instance_norm(x, axis)
    if norm_fn == "batch":
        return frozen_bn(x, block.module.get_submodule(name),
                         p[f"{name}.weight"], p[f"{name}.bias"])
    return x  # "none"


def encoder(block: Block, p, x, norm_fn: str, axis: MeshAxis):
    """models/extractor.Encoder on a row slab: the 7x7/2 stem, two blocks
    per stage (residual or bottleneck, as the module is built), the 1x1
    projection; the norms seq-aware."""
    conv = functools.partial(_conv, block, p, axis=axis)
    norm = functools.partial(_norm, block, p, norm_fn, axis=axis)
    x = F.relu(norm("norm1", conv("conv1", x)))
    bottleneck = isinstance(block.module.layer1[0], BottleneckBlock)
    for stage in (1, 2, 3):
        for j in (0, 1):
            b = f"layer{stage}.{j}"
            if bottleneck:
                y = F.relu(norm(f"{b}.norm1", conv(f"{b}.conv1", x)))
                y = F.relu(norm(f"{b}.norm2", conv(f"{b}.conv2", y)))
                y = F.relu(norm(f"{b}.norm3", conv(f"{b}.conv3", y)))
                last = f"{b}.norm4"
            else:
                y = F.relu(norm(f"{b}.norm1", conv(f"{b}.conv1", x)))
                y = F.relu(norm(f"{b}.norm2", conv(f"{b}.conv2", y)))
                last = f"{b}.norm3"
            if block.module.get_submodule(b).downsample is not None:
                x = norm(last, conv(f"{b}.downsample.0", x))
            x = F.relu(x + y)
    return conv("conv2", x)


def _gru(conv, names, h, x):
    z_name, r_name, q_name = names
    hx = torch.cat([h, x], dim=1)
    z = torch.sigmoid(conv(z_name, hx))
    r = torch.sigmoid(conv(r_name, hx))
    q = torch.tanh(conv(q_name, torch.cat([r * h, x], dim=1)))
    return (1 - z) * h + z * q


def update_block(block: Block, p, net, inp, corr, flow, axis: MeshAxis):
    """models/update.SmallUpdateBlock / BasicUpdateBlock on a row slab ->
    (net, mask or None, delta)."""
    conv = functools.partial(_conv, block, p, axis=axis)
    basic = "mask.0.weight" in p
    cor = F.relu(conv("encoder.convc1", corr))
    if basic:
        cor = F.relu(conv("encoder.convc2", cor))
    flo = F.relu(conv("encoder.convf1", flow))
    flo = F.relu(conv("encoder.convf2", flo))
    out = F.relu(conv("encoder.conv", torch.cat([cor, flo], dim=1)))
    x = torch.cat([inp, out, flow], dim=1)
    if basic:
        net = _gru(conv, ("gru.convz1", "gru.convr1", "gru.convq1"), net, x)
        net = _gru(conv, ("gru.convz2", "gru.convr2", "gru.convq2"), net, x)
    else:
        net = _gru(conv, ("gru.convz", "gru.convr", "gru.convq"), net, x)
    delta = conv("flow_head.conv2", F.relu(conv("flow_head.conv1", net)))
    mask = None
    if basic:
        mask = 0.25 * conv("mask.2", F.relu(conv("mask.0", net)))
    return net, mask, delta


# ---- upsampling, coordinates and the loss on row slabs -----------------


def upflow8(flow: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """ops/grid.upflow8 of a (B, 2, L, W) slab -> (B, 2, 8L, 8W): output
    rows [8·c0, 8·(c0+L)) of the global align-corners resize read input
    rows [c0-1, c0+L] only, so the slab and one halo row each side; the
    global hat matrix cut to this rank's block, a zero column padded each
    side for the edge taps (whose weight is zero against the zero
    halo)."""
    b, _, lc, wc = flow.shape
    h_tot = lc * axis.size
    ry = F.pad(_resize_matrix(h_tot, 8 * h_tot, flow.device, flow.dtype),
               (1, 1))
    c0 = axis.rank * lc
    m_h = ry[8 * c0:8 * (c0 + lc), c0:c0 + lc + 2]
    rx = _resize_matrix(wc, 8 * wc, flow.device, flow.dtype)
    xh = halo_exchange(flow, 1, 1, axis).permute(0, 2, 3, 1)
    out = torch.einsum("oy,nyxc->noxc", m_h, xh)
    out = torch.einsum("px,noxc->nopc", rx, out)
    return (8.0 * out).permute(0, 3, 1, 2)


def upsample_convex(flow: torch.Tensor, mask: torch.Tensor,
                    axis: MeshAxis) -> torch.Tensor:
    """ops/upsample.upsample_flow_convex_nchw on a row slab: the 3x3 taps
    read one coarse row past each slab edge, exchanged where the
    unsharded path pads zeros (the same zeros at the image's edges)."""
    n, _, h, w = flow.shape
    m = torch.softmax(mask.view(n, 1, 9, 8, 8, h, w), dim=2)
    fp = halo_exchange(8.0 * flow, 1, 1, axis)
    taps = F.unfold(fp, [3, 3], padding=(0, 1)).view(n, 2, 9, 1, 1, h, w)
    up = torch.sum(m * taps, dim=2)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(n, 2, 8 * h, 8 * w)


def _upsample(flow, mask, axis):
    if mask is None:  # the small model has no mask head
        return upflow8(flow, axis)
    return upsample_convex(flow, mask, axis)


def global_coords_grid(b: int, rows: int, wd: int, axis: MeshAxis,
                       device) -> torch.Tensor:
    """coords_grid (B, rows, W, 2) of this rank's slab in GLOBAL pixel
    coordinates: y plus the slab's first row. The lookup then indexes
    the gathered target levels as the unsharded one does."""
    c = coords_grid(b, rows, wd, device=device).clone()
    c[..., 1] += float(axis.rank * rows)
    return c


# ---- the forward --------------------------------------------------------


def halo_forward(model: RAFT, plan: Optional[ShardPlan], image1, image2,
                 axis: MeshAxis, iters: int, emit: bool, flow_init=None):
    """The v1 forward on this rank's row slab (models/raft.RAFT, pair
    mode, op for op): ``image1``/``image2`` (B, 3, L, W) in [0, 255],
    flow_init None or (B, 2, L/8, W/8). ``emit``: every iteration's
    upsampled flow, stacked (iters, B, 2, L, W) (training); else
    (flow_low (B, 2, L/8, W/8), flow_up (B, 2, L, W)). ``plan``: the
    state's fsdp storage (None: the model's own parameters). With the
    model's ``cfg.remat`` each iteration runs under
    ``torch.utils.checkpoint`` (``remat_policy`` as the model's), as
    ``RAFT`` runs it."""
    cfg = model.cfg
    hdim = cfg.hidden_dim
    x1 = _normalize(image1.to(torch.float32))
    x2 = _normalize(image2.to(torch.float32))
    fnet, cnet, upd = (Block(model, plan, name) for name in BLOCKS)
    fmaps = fnet.run(lambda p, x: encoder(fnet, p, x, "instance", axis),
                     torch.cat([x1, x2], dim=0))
    fmap1, fmap2 = fmaps.chunk(2, dim=0)
    ctx_norm = "none" if cfg.small else "batch"
    ctx = cnet.run(lambda p, x: encoder(cnet, p, x, ctx_norm, axis), x1)
    net = torch.tanh(ctx[:, :hdim])
    inp = F.relu(ctx[:, hdim:])
    pyr = row_block_pyramid(fmap1.permute(0, 2, 3, 1),
                            fmap2.permute(0, 2, 3, 1), axis,
                            cfg.corr_levels, cfg.radius)
    b, _, rows, wd = fmap1.shape
    coords0 = global_coords_grid(b, rows, wd, axis, fmap1.device)
    coords1 = coords0
    if flow_init is not None:
        coords1 = coords0 + flow_init.permute(0, 2, 3, 1)

    def iteration(p, net, coords1):
        coords1 = coords1.detach()
        flow = (coords1 - coords0).permute(0, 3, 1, 2)
        corr = corr_lookup(pyr, coords1).permute(0, 3, 1, 2)
        net, mask, delta = update_block(upd, p, net, inp, corr, flow, axis)
        coords1 = coords1 + delta.permute(0, 2, 3, 1)
        flow_up = None
        if emit:
            flow_up = _upsample((coords1 - coords0).permute(0, 3, 1, 2),
                                mask, axis)
        return net, coords1, mask, flow_up

    if cfg.remat and torch.is_grad_enabled():
        kw = {}
        if cfg.remat_policy == "dots_saveable":
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _dots_saveable)
        iteration = functools.partial(checkpoint, iteration,
                                      use_reentrant=False,
                                      preserve_rng_state=False, **kw)

    def loop(p, net, coords1):
        mask = None if cfg.small else net.new_zeros((b, 64 * 9, rows, wd))
        preds = []
        for _ in range(iters):
            net, coords1, mask, flow_up = iteration(p, net, coords1)
            preds.append(flow_up)
        if emit:
            return torch.stack(preds, dim=0)
        flow_low = (coords1 - coords0).permute(0, 3, 1, 2)
        return flow_low, _upsample(flow_low, mask, axis)

    return upd.run(loop, net, coords1)


# ---- the support matrix -------------------------------------------------


def check_geometry(h: int, n_seq: int) -> None:
    """Refuse an image height whose rows do not split into n_seq slabs of
    at least 3 whole 1/8-resolution rows (the update block's 7x7
    support)."""
    if h % (8 * n_seq) != 0:
        raise ValueError(
            f"image height {h} must be divisible by 8*n_seq={8 * n_seq} "
            f"so every device owns whole 1/8-resolution rows — pad with "
            f"data.padder.InputPadder(shape, seq={n_seq})")
    if h // (8 * n_seq) < 3:
        raise ValueError(
            f"image height {h} over {n_seq} seq shards leaves "
            f"{h // (8 * n_seq)} rows per device at 1/8 resolution; "
            "need >= 3 (the update block's 7x7 support) — use fewer seq "
            "shards or taller crops")


def check_halo_support(cfg: RAFTConfig, tc: TrainConfig, mesh) -> None:
    """Refuse what the halo forward does not reproduce, each with JAX's
    one-line message: the v1 support matrix."""
    if not has_seq(mesh):
        raise ValueError(
            "compute_sharding='halo' needs a mesh with a 'seq' axis — "
            "build one with parallel.make_train_mesh(batch_size, world, "
            "fsdp=n_fsdp, seq=n_seq)")
    if cfg.variant != "raft" or cfg.embed_dexined:
        raise ValueError(
            f"compute_sharding='halo' supports variant='raft' (v1) only, "
            f"got {cfg.variant!r} — edge streams / DexiNed are not halo-"
            "sharded yet; use compute_sharding='fence'")
    if cfg.corr_impl != "allpairs" or cfg.corr_dtype != "fp32":
        raise ValueError(
            f"compute_sharding='halo' needs corr_impl='allpairs' with "
            f"corr_dtype='fp32' (got {cfg.corr_impl!r}/{cfg.corr_dtype!r}) "
            "— the sharded lookup builds the row-block pyramid explicitly")
    if cfg.fused_update:
        raise ValueError(
            "compute_sharding='halo' does not support fused_update — the "
            "fused step is not row-sharded; use compute_sharding='fence'")
    if cfg.mixed_precision or tc.precision != "fp32":
        raise ValueError(
            "compute_sharding='halo' is fp32-only for now (precision="
            f"{tc.precision!r}, mixed_precision={cfg.mixed_precision}) — "
            "bit-parity with the fence step is pinned in fp32")
    if cfg.dropout > 0.0:
        raise ValueError(
            "compute_sharding='halo' does not support dropout>0 — the "
            "manual forward draws no per-device RNG; set dropout=0.0")
    if tc.add_noise:
        raise ValueError(
            "compute_sharding='halo' does not support add_noise — noise "
            "RNG is not split per row slab; disable it or use 'fence'")
    if tc.accum_steps != 1:
        raise ValueError(
            f"compute_sharding='halo' needs accum_steps=1 (got "
            f"{tc.accum_steps}) — accumulate by growing the data axis")
    if tc.edge_sum_fusion:
        raise ValueError(
            "compute_sharding='halo' does not support edge_sum_fusion "
            "(v1-lineage double forward); use compute_sharding='fence'")
    if (not cfg.small) and not tc.freeze_bn:
        raise ValueError(
            "compute_sharding='halo' runs BatchNorm frozen only: set "
            "freeze_bn=True (post-chairs stages already do) or use the "
            "small model — train-mode sync-BN stats are not exchanged")
    if tc.batch_size % mesh.n_data != 0:
        raise ValueError(
            f"batch_size {tc.batch_size} not divisible by the mesh's "
            f"{mesh.n_data}-way data axis")
    check_geometry(tc.image_size[0], mesh.n_seq)


def slab(x: torch.Tensor, axis: MeshAxis, dim: int = 2) -> torch.Tensor:
    """This rank's block of rows of ``x`` along ``dim``."""
    rows = x.shape[dim] // axis.size
    return x.narrow(dim, axis.rank * rows, rows)

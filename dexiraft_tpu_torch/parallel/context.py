"""Context parallelism for the correlation volume: rows over a seq axis.

The port of ``dexiraft_tpu/parallel/context.py``. The all-pairs volume
is quadratic in pixels, (H/8·W/8)², like attention in tokens. For frames
whose volume is too large for one device, the QUERY rows (the volume's
first H·W axis) shard over the ranks of a seq axis: each rank builds and
looks up only its row block of the volume.

Each rank holds a contiguous block of rows of every map (``axis``: the
seq axis, ``parallel.layout.MeshAxis``; rank i holds rows [i·H_loc,
(i+1)·H_loc)), and coordinates are in GLOBAL level-0 pixels, as they are
when JAX shards one global array by rows.

  * :func:`context_parallel_corr`: fmap2 is all-gathered over the seq
    axis once (:func:`gather_rows`; its backward is a reduce-scatter,
    a sum over the ranks), and the pyramid is built from this rank's
    queries against the whole target map (:func:`row_block_pyramid`):
    each rank materializes a (B·H_loc·W, H, W) slice of the volume. The
    halo train and eval steps build their pyramid this way
    (parallel/halo.py), and so does the model on row slabs for every
    ``corr_impl`` (models/raft.py): the on-demand lookups keep the
    gathered fmap2 levels and correlate this rank's queries per lookup.
  * :func:`ring_corr_lookup`: fmap2 stays sharded. Per level, the target
    blocks rotate around the seq ring; at each of the n_seq hops a rank
    correlates its queries against the visiting block and adds that
    block's window through a row-offset hat stencil. The stencils'
    supports partition over the blocks, so the sum is the unsharded
    lookup. The transient volume is B·H_loc·W × H_loc·W.

Exchanges use collectives only: gloo cannot send a CUDA tensor point to
point (``batch_isend_irecv`` and ``send``/``recv`` fail on the card with
"writev: Bad address", torch 2.11; PERF.md), and the ranks that share one
card run gloo. A ring hop is therefore an all-gather of the visiting
blocks over the seq group, of which each rank keeps its predecessor's:
on two ranks the same bytes as a send; on n ranks n-1 blocks where a
send moves one.
"""

from __future__ import annotations

from typing import Optional

import torch

from dexiraft_tpu_torch.ops.corr import (_axis_interp_matrix,
                                         all_pairs_correlation, avg_pool_2x2,
                                         build_corr_pyramid, corr_lookup)
from dexiraft_tpu_torch.ops.local_corr import build_local_corr
from dexiraft_tpu_torch.parallel.fsdp import all_gather_flat
from dexiraft_tpu_torch.parallel.layout import MeshAxis


class _GatherRows(torch.autograd.Function):
    """All-gather of every rank's row block along ``dim``; the backward
    sums the gradient of each block over the ranks and returns each rank
    its own (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, axis: MeshAxis, dim: int):
        ctx.axis, ctx.dim = axis, dim
        every = all_gather_flat(x.contiguous().reshape(-1), axis.size,
                                axis.group)
        return torch.cat(every.view((axis.size,) + tuple(x.shape)).unbind(0),
                         dim=dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        import torch.distributed as dist

        axis = ctx.axis
        blocks = torch.stack(g.chunk(axis.size, dim=ctx.dim))
        out = g.new_empty(blocks[0].shape)
        dist.reduce_scatter_tensor(out.view(-1), blocks.reshape(-1),
                                   group=axis.group)
        return out, None, None


def gather_rows(x: torch.Tensor, axis: MeshAxis, dim: int = 1
                ) -> torch.Tensor:
    """Every rank's row block of ``x`` along ``dim``, in rank order (the
    whole map); differentiable (the backward sums over the ranks)."""
    if axis.size <= 1:
        return x
    return _GatherRows.apply(x, axis, dim)


def _from_predecessor(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The ring predecessor's ``x``, ((i - 1) mod n): one ring hop."""
    every = all_gather_flat(x.contiguous().reshape(-1), axis.size,
                            axis.group)
    return every[(axis.rank - 1) % axis.size].view_as(x)


def _check_axis(axis: MeshAxis) -> None:
    if axis is None:
        raise ValueError(f"mesh has no 'seq' axis: {axis!r}")


def row_block_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                      axis: MeshAxis, num_levels: int = 4,
                      radius: int = 4, corr_impl: str = "allpairs",
                      dtype: str = "fp32", row_chunk: Optional[int] = None):
    """The pyramid of this rank's queries ``fmap1`` (B, H_loc, W, D)
    against the whole target map, gathered from every rank's ``fmap2``
    row block (the gather's backward sends each row's gradient to its
    owner). ``corr_impl`` "allpairs": this rank's (B·H_loc·W, H>>l, W>>l)
    slice of each level (a ``CorrPyramid``); "local", "flash", "pallas":
    the whole fmap2 and its pooled levels beside this rank's queries (a
    ``LocalCorr``, whose kernels take the query block against the
    full-height levels), each level stored in ``dtype``."""
    f2 = gather_rows(fmap2, axis)
    if corr_impl == "allpairs":
        return build_corr_pyramid(fmap1, f2, num_levels, radius, dtype=dtype)
    return build_local_corr(fmap1, f2, num_levels, radius,
                            row_chunk=row_chunk, dtype=dtype,
                            kernel="plain" if corr_impl == "local"
                            else corr_impl)


def context_parallel_corr(fmap1: torch.Tensor, fmap2: torch.Tensor,
                          coords: torch.Tensor, axis: MeshAxis,
                          num_levels: int = 4, radius: int = 4
                          ) -> torch.Tensor:
    """Row-sharded all-pairs correlation lookup.

    fmap1, fmap2: this rank's row blocks (B, H_loc, W, D); coords: its
    (B, H_loc, W, 2) in global level-0 pixels. fmap2 is all-gathered
    over ``axis`` (the target space every query row needs); this rank's
    slice of the volume is built and sampled: the whole volume never
    exists on one rank. Returns this rank's rows of the lookup, (B,
    H_loc, W, num_levels·(2r+1)²)."""
    _check_axis(axis)
    return corr_lookup(row_block_pyramid(fmap1, fmap2, axis, num_levels,
                                         radius), coords)


def ring_corr_lookup(fmap1: torch.Tensor, fmap2: torch.Tensor,
                     coords: torch.Tensor, axis: MeshAxis,
                     num_levels: int = 4, radius: int = 4) -> torch.Tensor:
    """Ring context-parallel correlation lookup, the ring-attention
    analog (module docstring).

    Both the query and the target rows shard over ``axis``: fmap1,
    fmap2 (B, H_loc, W, D) and coords (B, H_loc, W, 2, global level-0
    pixels) are this rank's row blocks. Requires H = n_seq·H_loc with
    H_loc divisible by 2^(num_levels-1), so that the VALID 2x2 pooling
    of the row blocks composes to the global pooling (no window
    straddles a block boundary). Returns (B, H_loc, W,
    num_levels·(2r+1)²), this rank's rows of the unsharded lookup.
    Forward only (no backward through the hops)."""
    _check_axis(axis)
    n_seq = axis.size
    b, h_loc, w = fmap1.shape[:3]
    h = h_loc * n_seq
    if h_loc % (2 ** (num_levels - 1)) != 0:
        raise ValueError(
            f"H={h} must be divisible by n_seq={n_seq} with blocks "
            f"divisible by 2^{num_levels - 1} for pooling alignment")
    n = b * h_loc * w
    flat = coords.reshape(n, 2).to(torch.float32)
    win = 2 * radius + 1
    out = []
    f2_l = fmap2.to(torch.float32)
    for lvl in range(num_levels):
        h_blk, wl = f2_l.shape[1], f2_l.shape[2]
        centers = flat / (2.0 ** lvl)
        ax = _axis_interp_matrix(centers[:, 0], radius, wl)
        rows = flat.new_zeros((n, win, wl))
        blk = f2_l
        for s in range(n_seq):
            src = (axis.rank - s) % n_seq  # whose block is visiting
            vol = all_pairs_correlation(fmap1, blk)[..., 0]
            ay = _axis_interp_matrix(centers[:, 1], radius, h_blk,
                                     offset=float(src * h_blk))
            rows = rows + torch.bmm(ay, vol)
            if s < n_seq - 1:  # the last visiting block goes no further
                blk = _from_predecessor(blk, axis)
        window = torch.bmm(ax, rows.transpose(1, 2))  # (n, win_x, win_y)
        out.append(window.reshape(b, h_loc, w, win * win))
        f2_l = avg_pool_2x2(f2_l)
    return torch.cat(out, dim=-1)

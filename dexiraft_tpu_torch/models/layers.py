"""Shared layer helpers: the compute-dtype layers, the norm factory and
the seeded init.

Counterpart of ``dexiraft_tpu/models/layers.py``. The reference's four norm
modes with torch's own hyperparameters: eps 1e-5 everywhere, BatchNorm
momentum 0.1 (running stats in eval mode), instance norm without affine,
and "none" as an empty ``nn.Sequential`` (no parameters, as the reference
registers it). In training mode BatchNorm updates its running stats by
flax's rule (:class:`BatchNorm2d`).

Mixed precision follows flax's ``dtype=`` attribute, layer by layer. Every
conv and norm of the model is one of this module's subclasses, whose
``compute_dtype`` is None (plain fp32, torch's own forward) or the
compute dtype that :func:`set_compute_dtype` gives the whole model:

  * a conv casts its input, its fp32 weight and its fp32 bias to the
    compute dtype and returns the compute dtype; the bias is added after
    the convolution, in the compute dtype, as flax adds it (and as cuDNN's
    path does). Autograd differentiates the casts, so the gradients reach
    the fp32 masters as fp32, as flax's per-use cast does;
  * a norm (BatchNorm, GroupNorm, instance norm) reduces AND normalises in
    fp32, since flax's ``_compute_stats`` promotes the input to fp32 and
    ``_normalize`` subtracts an fp32 mean from it, and rounds only its
    output to the compute dtype; running statistics stay fp32.

Everything between these layers (relu, tanh, the GRU's blend,
``torch.cat``) runs in whatever dtype its inputs promote to, the rule jnp
follows too: a bf16 tensor concatenated with an fp32 one gives fp32. The
GRUs' gates use :func:`sigmoid`, which rounds where jax.nn.sigmoid does.

``torch.autocast`` is not used on purpose: its per-op lists keep group and
batch norm in fp32 outputs, differ between the CPU and CUDA, and round at
other places than flax; and it is thread-local state, while the engines
run the model on ``DeviceThread``s of their own.

Data-parallel training (:func:`set_data_mesh`) gives every BatchNorm and
channel dropout the data axis: BatchNorm then normalises with the
statistics of the global microbatch, as under JAX's data-sharded step,
and dropout draws the global microbatch's masks and keeps this rank's
rows. Under fsdp the data axis is the data subgroup (the ranks of one
fsdp group hold the same rows), whose process group the statistics
reduce over.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class ComputeDtype:
    """Mixin of the layers that follow the model's compute dtype (None:
    torch's own fp32 forward)."""

    compute_dtype: Optional[torch.dtype] = None


class Conv2d(ComputeDtype, nn.Conv2d):
    """``nn.Conv2d`` with flax's ``dtype=`` rule (module docstring)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


class ConvTranspose2d(ComputeDtype, nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` with flax's ``dtype=`` rule."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = F.conv_transpose2d(x.to(dt), self.weight.to(dt), None,
                               self.stride, self.padding, self.output_padding,
                               self.groups, self.dilation)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


class _Fp32Norm(ComputeDtype):
    """A norm that, given a compute dtype, normalises its input's values in
    fp32 and rounds the output to the compute dtype, as flax does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return super().forward(x.to(torch.float32)).to(dt)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of ``group`` (None: every rank); the backward
    sums the gradient over them too, so each rank's backward carries
    every rank's terms."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group=None) -> torch.Tensor:
        import torch.distributed as dist

        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        import torch.distributed as dist

        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _global_var_mean(x: torch.Tensor, mesh) -> "tuple[torch.Tensor, ...]":
    """The biased per-channel (var, mean) of the global batch whose rows
    ``x`` (N, C, H, W) holds at index ``mesh.rank`` of the data axis
    ``mesh`` (over its process group ``mesh.group``): each rank's count,
    mean and sum of squared deviations, gathered by one differentiable
    all-reduce (each rank fills its own row of a zero table) and merged
    by Chan's parallel rule, which stays as exact as a two-pass variance
    whatever the channel's mean."""
    var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
    n = float(x.shape[0] * x.shape[2] * x.shape[3])
    row = torch.cat([mean.new_full((1,), n), mean, var * n])
    table = _AllReduceSum.apply(F.pad(
        row[None], (0, 0, mesh.rank, mesh.size - 1 - mesh.rank)), mesh.group)
    c = mean.numel()
    counts, means, m2 = table[:, :1], table[:, 1:c + 1], table[:, c + 1:]
    total = counts.sum()
    gmean = (counts * means).sum(0) / total
    gm2 = m2.sum(0) + (counts * (means - gmean).square()).sum(0)
    return gm2 / total, gmean


class _FlaxBatchNorm2d(nn.BatchNorm2d):
    #: the data axis (a grouped parallel.World, or an fsdp mesh's data
    #: axis) whose global microbatch the training-mode statistics cover;
    #: None: this process's rows
    mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.mesh is not None:
            var, mean = _global_var_mean(x, self.mesh)
        with torch.no_grad():
            if self.mesh is None:
                var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        if self.mesh is None:
            return F.batch_norm(x, None, None, self.weight, self.bias, True,
                                0.0, self.eps)
        shape = (1, -1, 1, 1)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean.reshape(shape)) * scale.reshape(shape)
                + self.bias.reshape(shape))


class BatchNorm2d(_Fp32Norm, _FlaxBatchNorm2d):
    """``nn.BatchNorm2d`` whose training-mode running variance follows
    flax's ``nn.BatchNorm``: the EMA folds in the BIASED batch variance
    (``torch.nn.BatchNorm2d`` folds the unbiased one, n/(n-1) larger).
    Normalization and the eval mode are torch's, and so are the state
    dict's keys; with a compute dtype the statistics, the running stats
    and the normalisation are fp32 (module docstring)."""


class GroupNorm(_Fp32Norm, nn.GroupNorm):
    """``nn.GroupNorm`` that follows the compute dtype (module docstring)."""


class InstanceNorm2d(_Fp32Norm, nn.InstanceNorm2d):
    """``nn.InstanceNorm2d`` that follows the compute dtype."""


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The logistic function with jax.nn.sigmoid's rounding points: in a
    low-precision dtype jax computes 1 / (1 + exp(-x)) op by op, each op
    rounded to that dtype (torch.sigmoid rounds once, and differs from it
    by one bf16 ulp on about a third of the elements); fp32 is
    torch.sigmoid."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1 / (1 + torch.exp(-x))


def set_data_mesh(model: nn.Module, mesh, micro: int = 0) -> nn.Module:
    """Give every BatchNorm and channel dropout of ``model`` the data axis
    ``mesh`` (a grouped parallel.World, or an fsdp mesh's data axis,
    ``parallel.layout.data_axis``; None: this process's rows only) and
    the row count ``micro`` of this rank's microbatch."""
    for m in model.modules():
        if isinstance(m, (_FlaxBatchNorm2d, ChannelDropout)):
            m.mesh = mesh
        if isinstance(m, ChannelDropout):
            m.micro = micro
    return model


def set_compute_dtype(model: nn.Module, dtype: Optional[torch.dtype]
                      ) -> nn.Module:
    """Give every conv and norm of ``model`` the compute dtype ``dtype``
    (None: fp32, torch's own forward); the parameters stay as they are."""
    for m in model.modules():
        if isinstance(m, ComputeDtype):
            m.compute_dtype = dtype
    return model


class ChannelDropout(nn.Module):
    """Channel dropout (``Dropout2d`` semantics: one draw per (sample,
    channel), broadcast over H and W, kept values divided by 1-p in their
    own dtype, as flax's ``nn.Dropout`` divides them). The masks come from
    ``generator`` when one is set (the train state's, on the activations'
    device), else from the global RNG."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None
        # the data axis (a grouped parallel.World, or an fsdp mesh's data
        # axis) and the rows of this rank's microbatch (set_data_mesh)
        self.mesh = None
        self.micro = 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p <= 0.0:
            return x
        keep = 1.0 - self.p
        n, c = x.shape[:2]
        if self.mesh is None:
            u = torch.rand((n, c, 1, 1), device=x.device,
                           generator=self.generator)
        else:
            # x stacks n // micro chunks (frame 1's rows, then frame 2's,
            # ...), each this rank's block of the global chunk: draw the
            # global batch's masks and keep that block of every chunk
            size = self.mesh.size
            u = torch.rand((n * size, c, 1, 1), device=x.device,
                           generator=self.generator)
            u = u.view(n // self.micro, size, self.micro, c, 1, 1)[
                :, self.mesh.rank].reshape(n, c, 1, 1)
        return torch.where(u < keep, x / keep, 0.0)

    def extra_repr(self) -> str:
        return f"p={self.p}"


def make_norm(norm_fn: str, num_groups: int, planes: int) -> nn.Module:
    if norm_fn == "group":
        return GroupNorm(num_groups=num_groups, num_channels=planes, eps=1e-5)
    if norm_fn == "batch":
        return BatchNorm2d(planes, eps=1e-5, momentum=0.1)
    if norm_fn == "instance":
        return InstanceNorm2d(planes, eps=1e-5, affine=False)
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

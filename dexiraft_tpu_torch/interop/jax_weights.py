"""Carry trained JAX/flax RAFT variables into the PyTorch port.

``raft_state_dict_from_jax(variables)`` maps the flax variable tree
(``{"params": ..., "batch_stats": ...}``, nested dicts of arrays) onto the
port's state dict, key for key:

  conv kernel (HWIO)          -> weight (OIHW), transpose (3, 2, 0, 1)
  conv bias                   -> bias
  BatchNorm scale / bias      -> weight / bias
  batch_stats mean / var      -> running_mean / running_var
  num_batches_tracked         -> 0 (flax keeps no such counter)

The name map mirrors the JAX package's interop/torch_convert.py, written
out here so that the port imports nothing of the JAX package: flax's
auto-numbered module paths on one side, the reference torch attribute
names the port uses on the other. A strided block's shortcut norm is
registered twice in the port (``normK`` and ``downsample.1``), and both
keys get the same flax BatchNorm. ``convc1`` maps to the motion encoder's
``Conv_0`` on both the fused and the unfused path: the flax tree is the
same for both.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from dexiraft_tpu_torch.config import RAFTConfig

_UPDATE_BLOCK_FULL = {
    "encoder.convc1": ("BasicMotionEncoder_0", "Conv_0"),
    "encoder.convc2": ("BasicMotionEncoder_0", "Conv_1"),
    "encoder.convf1": ("BasicMotionEncoder_0", "Conv_2"),
    "encoder.convf2": ("BasicMotionEncoder_0", "Conv_3"),
    "encoder.conv": ("BasicMotionEncoder_0", "Conv_4"),
    "gru.convz1": ("SepConvGRU_0", "Conv_0"),
    "gru.convr1": ("SepConvGRU_0", "Conv_1"),
    "gru.convq1": ("SepConvGRU_0", "Conv_2"),
    "gru.convz2": ("SepConvGRU_0", "Conv_3"),
    "gru.convr2": ("SepConvGRU_0", "Conv_4"),
    "gru.convq2": ("SepConvGRU_0", "Conv_5"),
    "flow_head.conv1": ("FlowHead_0", "Conv_0"),
    "flow_head.conv2": ("FlowHead_0", "Conv_1"),
    "mask.0": ("Conv_0",),
    "mask.2": ("Conv_1",),
}

_UPDATE_BLOCK_SMALL = {
    "encoder.convc1": ("SmallMotionEncoder_0", "Conv_0"),
    "encoder.convf1": ("SmallMotionEncoder_0", "Conv_1"),
    "encoder.convf2": ("SmallMotionEncoder_0", "Conv_2"),
    "encoder.conv": ("SmallMotionEncoder_0", "Conv_3"),
    "gru.convz": ("ConvGRU_0", "Conv_0"),
    "gru.convr": ("ConvGRU_0", "Conv_1"),
    "gru.convq": ("ConvGRU_0", "Conv_2"),
    "flow_head.conv1": ("FlowHead_0", "Conv_0"),
    "flow_head.conv2": ("FlowHead_0", "Conv_1"),
}

_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}


def _encoder_module(parts, small: bool) -> Tuple[str, ...]:
    """Encoder torch path (without root and leaf) -> flax module path."""
    block = "BottleneckBlock" if small else "ResidualBlock"
    head = parts[0]
    if head == "conv1":
        return ("Conv_0",)
    if head == "conv2":
        return ("Conv_1",)
    if head == "norm1":
        return ("BatchNorm_0",)
    if head.startswith("layer"):
        mod = f"{block}_{2 * (int(head[5:]) - 1) + int(parts[1])}"
        sub = parts[2]
        if sub == "downsample":
            if parts[3] == "0":
                return (mod, "Conv_3" if small else "Conv_2")
            return (mod, "BatchNorm_3" if small else "BatchNorm_2")
        if sub.startswith("conv"):
            return (mod, f"Conv_{int(sub[4:]) - 1}")
        if sub.startswith("norm"):
            return (mod, f"BatchNorm_{int(sub[4:]) - 1}")
    raise KeyError(f"unhandled encoder key {'.'.join(parts)}")


def flax_source(key: str, small: bool = False) -> Tuple[str, Tuple[str, ...]]:
    """Port state-dict key -> (flax collection, flax path incl. leaf name).
    Raises KeyError for num_batches_tracked (no flax counterpart)."""
    parts = key.split(".")
    root, leaf = parts[0], parts[-1]
    if root in ("fnet", "cnet"):
        mod = (root,) + _encoder_module(parts[1:-1], small)
    elif root == "update_block":
        table = _UPDATE_BLOCK_SMALL if small else _UPDATE_BLOCK_FULL
        sub = ".".join(parts[1:-1])
        if sub not in table:
            raise KeyError(f"unhandled update_block key {key!r}")
        mod = ("ScanRAFTStep_0",
               "SmallUpdateBlock_0" if small else "BasicUpdateBlock_0") + table[sub]
    else:
        raise KeyError(f"unknown RAFT root module {root!r} in {key!r}")
    if mod[-1].startswith("Conv"):
        return "params", mod + ("kernel" if leaf == "weight" else "bias",)
    if leaf not in _BN_LEAVES:
        raise KeyError(f"no flax source for {key!r}")
    coll, name = _BN_LEAVES[leaf]
    return coll, mod + (name,)


def _fetch(tree: Mapping[str, Any], path: Tuple[str, ...]) -> np.ndarray:
    node: Any = tree
    for p in path:
        node = node[p]
    return np.asarray(node)


def raft_state_dict_from_jax(variables: Mapping[str, Any],
                             small: bool = False) -> Dict[str, torch.Tensor]:
    """Flax RAFT v1 variables -> the port's state dict (CPU tensors), ready
    for ``RAFT.load_state_dict(..., strict=True)``."""
    from dexiraft_tpu_torch.models.raft import RAFT

    with torch.device("meta"):
        keys = list(RAFT(RAFTConfig(small=small, corr_impl="local"))
                    .state_dict().keys())
    out: Dict[str, torch.Tensor] = {}
    for key in keys:
        if key.endswith("num_batches_tracked"):
            out[key] = torch.tensor(0, dtype=torch.int64)
            continue
        coll, path = flax_source(key, small)
        value = np.asarray(_fetch(variables[coll], path), np.float32)
        if path[-1] == "kernel":
            value = value.transpose(3, 2, 0, 1)
        out[key] = torch.from_numpy(np.array(value, np.float32, order="C"))
    return out

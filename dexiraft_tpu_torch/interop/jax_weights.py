"""Carry trained JAX/flax RAFT variables into the PyTorch port.

``raft_state_dict_from_jax(variables)`` maps the flax variable tree
(``{"params": ..., "batch_stats": ...}``, nested dicts of arrays) onto the
port's state dict, key for key:

  conv kernel (HWIO)          -> weight (OIHW), transpose (3, 2, 0, 1)
  conv-transpose kernel       -> weight (in, out, kH, kW): spatial flip,
    (kH, kW, in, out)            then transpose (2, 3, 0, 1) (torch's
                                 ConvTranspose2d is the gradient of a
                                 strided conv, flax's a conv over the
                                 dilated input: the kernels are mirrored)
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
same for both. v5 also maps the edge encoders ``efnet``/``ecnet`` (the
encoder map again); v4 and v5 map every ``dexined.*`` key (the reference
DexiNed names -> flax's auto-numbered modules, as
``torch_convert._DEXINED_BLOCKS`` maps them). v3's ``refine_flow.conv``
has no entry in the JAX package's map: it is the 1x1 conv
``ScanRAFTStep_0/RefineFlow_0/Conv_0`` of the flax tree (the path a v3
init gives), transposed like every conv kernel.

Which variant's key set to fill is the caller's ``cfg`` where one is
given; else it is read off the tree: DexiNed with ``efnet`` is v5,
DexiNed without it v4; without DexiNed, a ``RefineFlow_0`` leaf under
``ScanRAFTStep_0`` is v3, a 6-channel ``fnet`` stem v2, else v1.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from dexiraft_tpu_torch.config import (RAFTConfig, raft_v1, raft_v2, raft_v3,
                                       raft_v4, raft_v5)

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

# reference DexiNed attribute -> flax module (construction order)
_DEXINED_BLOCKS = {
    "block_1": "DoubleConvBlock_0",
    "block_2": "DoubleConvBlock_1",
    "dblock_3": "DenseBlock_0",
    "dblock_4": "DenseBlock_1",
    "dblock_5": "DenseBlock_2",
    "dblock_6": "DenseBlock_3",
    "side_1": "SingleConvBlock_0",
    "side_2": "SingleConvBlock_1",
    "side_3": "SingleConvBlock_3",
    "side_4": "SingleConvBlock_5",
    "side_5": "side_5",
    "pre_dense_3": "SingleConvBlock_2",
    "pre_dense_4": "SingleConvBlock_4",
    "pre_dense_5": "SingleConvBlock_6",
    "pre_dense_6": "SingleConvBlock_7",
    "block_cat": "SingleConvBlock_8",
    "up_block_1": "UpConvBlock_0",
    "up_block_2": "UpConvBlock_1",
    "up_block_3": "UpConvBlock_2",
    "up_block_4": "UpConvBlock_3",
    "up_block_5": "UpConvBlock_4",
    "up_block_6": "UpConvBlock_5",
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


def _numbered(sub: str) -> str:
    """conv / conv1 -> Conv_0, conv2 -> Conv_1, bn / bn1 / norm1 ->
    BatchNorm_0, ..."""
    for base, flax in (("conv", "Conv"), ("bn", "BatchNorm"),
                       ("norm", "BatchNorm")):
        if sub.startswith(base):
            suffix = sub[len(base):]
            return f"{flax}_{int(suffix) - 1 if suffix else 0}"
    raise KeyError(f"unhandled DexiNed module {sub!r}")


def _dexined_module(parts) -> Tuple[str, ...]:
    """DexiNed torch path (without root and leaf) -> flax module path."""
    ours = _DEXINED_BLOCKS[parts[0]]
    if parts[0].startswith("up_block"):
        # features.{i}: 0, 3, ... 1x1 convs; 2, 5, ... transposed convs
        stage, pos = divmod(int(parts[2]), 3)
        if pos not in (0, 2):
            raise KeyError(f"unexpected UpConvBlock index {parts[2]}")
        return (ours, f"Conv_{stage}" if pos == 0 else f"ConvTranspose_{stage}")
    if parts[0].startswith("dblock"):
        layer = int(parts[1][len("denselayer"):]) - 1
        return (ours, f"DenseLayer_{layer}", _numbered(parts[2]))
    return (ours, _numbered(parts[1]))


def flax_source(key: str, small: bool = False) -> Tuple[str, Tuple[str, ...]]:
    """Port state-dict key -> (flax collection, flax path incl. leaf name).
    Raises KeyError for num_batches_tracked (no flax counterpart)."""
    parts = key.split(".")
    root, leaf = parts[0], parts[-1]
    if root in ("fnet", "cnet", "efnet", "ecnet"):
        mod = (root,) + _encoder_module(parts[1:-1], small)
    elif root == "dexined":
        mod = ("DexiNed_0",) + _dexined_module(parts[1:-1])
    elif root == "refine_flow":
        mod = ("ScanRAFTStep_0", "RefineFlow_0", "Conv_0")
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


def _config_of(variables: Mapping[str, Any], small: bool) -> RAFTConfig:
    """The variant whose state dict the flax tree fills (module
    docstring)."""
    params = variables["params"]
    if "DexiNed_0" in params:
        variant = raft_v5 if "efnet" in params else raft_v4
    elif "RefineFlow_0" in params.get("ScanRAFTStep_0", {}):
        variant = raft_v3
    elif np.shape(params["fnet"]["Conv_0"]["kernel"])[2] == 6:
        variant = raft_v2
    else:
        variant = raft_v1
    return variant(small=small, corr_impl="local")


def _leaf_to_torch(variables: Mapping[str, Any], coll: str,
                   path: Tuple[str, ...]) -> torch.Tensor:
    value = np.asarray(_fetch(variables[coll], path), np.float32)
    if path[-1] == "kernel" and path[-2].startswith("ConvTranspose"):
        value = value[::-1, ::-1].transpose(2, 3, 0, 1)
    elif path[-1] == "kernel":
        value = value.transpose(3, 2, 0, 1)
    return torch.from_numpy(np.array(value, np.float32, order="C"))


def _state_dict(variables: Mapping[str, Any], keys, source
                ) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for key in keys:
        if key.endswith("num_batches_tracked"):
            out[key] = torch.tensor(0, dtype=torch.int64)
            continue
        out[key] = _leaf_to_torch(variables, *source(key))
    return out


def raft_state_dict_from_jax(variables: Mapping[str, Any],
                             small: bool = False,
                             cfg: Optional[RAFTConfig] = None
                             ) -> Dict[str, torch.Tensor]:
    """Flax RAFT variables of any of the five variants -> the port's state
    dict (CPU tensors), ready for ``RAFT(cfg).load_state_dict(...,
    strict=True)``. ``cfg`` decides the key set (and ``small``); without
    it the variant is read off the tree (module docstring)."""
    from dexiraft_tpu_torch.models.raft import RAFT

    if cfg is None:
        cfg = _config_of(variables, small)
    small = cfg.small
    # the key set does not depend on the lookup
    cfg = dataclasses.replace(cfg, corr_impl="local", fused_update=False)
    with torch.device("meta"):
        keys = list(RAFT(cfg).state_dict().keys())
    return _state_dict(variables, keys, lambda k: flax_source(k, small))


def dexined_state_dict_from_jax(variables: Mapping[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """Flax DexiNed variables (the standalone network's tree) -> the
    port's ``DexiNed`` state dict, by the map RAFT v5 uses for its
    ``dexined.*`` keys."""
    from dexiraft_tpu_torch.models.dexined import DexiNed

    with torch.device("meta"):
        keys = list(DexiNed().state_dict().keys())

    def source(key):
        coll, path = flax_source("dexined." + key)
        return coll, path[1:]  # the tree has no DexiNed_0 root

    return _state_dict(variables, keys, source)

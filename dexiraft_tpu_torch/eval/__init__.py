"""Evaluation of the PyTorch port: dataset-metric validators, benchmark
submissions, flow viz, warm-start propagation (counterpart of
``dexiraft_tpu.eval``)."""

from dexiraft_tpu_torch.eval.flow_viz import flow_to_image
from dexiraft_tpu_torch.eval.interpolate import forward_interpolate
from dexiraft_tpu_torch.eval.validate import (
    validate_chairs,
    validate_hd1k,
    validate_kitti,
    validate_sintel,
)
from dexiraft_tpu_torch.eval.submission import (
    create_kitti_submission,
    create_sintel_submission,
)

__all__ = [
    "flow_to_image",
    "forward_interpolate",
    "validate_chairs",
    "validate_sintel",
    "validate_kitti",
    "validate_hd1k",
    "create_sintel_submission",
    "create_kitti_submission",
]

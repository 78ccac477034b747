"""ICP scale-corrected cloud fusion, reference configuration 2 (port of
`tpu3drec/pipelines/icp_fusion.py`).

Applies a 4x4 metric-scale-correction transform T (from ``T_data.txt`` or
from `sfm/icp.py`) to cloud B on the device and merges it with cloud A.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3drec_torch.core.se3 import SE3
from tpu3drec_torch.utils.device import as_f32, resolve_device
from tpu3drec_torch.utils.plyio import write_ply
from tpu3drec_torch.utils.poseio import read_T_txt


def apply_T(points: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Homogeneous 4x4 applied to (N, 3) points: points @ R^T + t."""
    R, t = SE3.from_matrix(T)
    return points @ R.T + t


def fuse_with_T(cloud_a: np.ndarray, cloud_b: np.ndarray, T: np.ndarray,
                device=None) -> np.ndarray:
    """Cloud A verbatim + T-transformed cloud B, merged."""
    dev = resolve_device(device)
    b = apply_T(as_f32(cloud_b, dev), as_f32(T, dev)).cpu().numpy()
    return np.concatenate([np.asarray(cloud_a, dtype=np.float32), b], axis=0)


def run(cloud_a: np.ndarray, cloud_b: np.ndarray, t_path: str, out_ply: str,
        device=None) -> int:
    """From files: read T, merge, write the PLY. Returns the point count."""
    merged = fuse_with_T(cloud_a, cloud_b, read_T_txt(t_path), device=device)
    write_ply(out_ply, merged)
    return merged.shape[0]

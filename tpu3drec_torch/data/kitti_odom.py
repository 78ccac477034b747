"""KITTI odometry dataset layout (port of `tpu3drec/data/kitti_odom.py`).

  sequences/<seq>/image_0/000000.png ...   grayscale left camera
  sequences/<seq>/calib.txt                P0..P3 3x4 projection rows
  poses/<seq>.txt                          ground truth: rows of 12 floats (cam->world)

Images are decoded by `utils/depthio.py::load_image_rgb`, which imports PIL
inside.
"""

from __future__ import annotations

import os

import numpy as np

from tpu3drec_torch.utils.depthio import load_image_rgb
from tpu3drec_torch.utils.trajectory_eval import read_kitti_poses


class KittiOdometryDataset:
    def __init__(self, root: str, sequence: str = "00", camera: int = 0):
        self.root = root
        self.sequence = sequence
        self.camera = camera
        self.seq_dir = os.path.join(root, "sequences", sequence)

    def calib(self) -> np.ndarray:
        """3x3 intrinsics from the P<camera> row of calib.txt."""
        path = os.path.join(self.seq_dir, "calib.txt")
        with open(path) as f:
            for line in f:
                if line.startswith(f"P{self.camera}:"):
                    vals = np.array([float(v) for v in line.split()[1:]])
                    return vals.reshape(3, 4)[:, :3].astype(np.float32)
        raise ValueError(f"P{self.camera} not found in {path}")

    def image_path(self, idx: int) -> str:
        return os.path.join(self.seq_dir, f"image_{self.camera}", f"{idx:06d}.png")

    def num_frames(self) -> int:
        d = os.path.join(self.seq_dir, f"image_{self.camera}")
        return len([n for n in os.listdir(d) if n.endswith(".png")])

    def load_gray(self, idx: int, size=None) -> np.ndarray:
        img = load_image_rgb(self.image_path(idx), size=size)
        return img.mean(axis=-1).astype(np.float32) / 255.0

    def load_sequence(self, start: int = 0, count: int | None = None, size=None) -> np.ndarray:
        n = count if count is not None else self.num_frames() - start
        return np.stack([self.load_gray(start + i, size=size) for i in range(n)])

    def gt_poses(self) -> np.ndarray:
        """(F, 4, 4) cam->world ground truth."""
        return read_kitti_poses(os.path.join(self.root, "poses", f"{self.sequence}.txt"))

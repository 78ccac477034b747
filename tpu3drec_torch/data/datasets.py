"""Dataset readers: InteriorNet, KITTI-raw, AirSim capture (port of
`tpu3drec/data/datasets.py`, numpy only; PIL is imported where images
are decoded, in `utils/depthio.py`).

Capability-parity with the reference's data layer:
* InteriorNet (`ref/monodepth2/interior_dataset.py`): normalized K
  [[0.9375,0,0.5],[0,1.25,0.5]] (fx~fy~600 @ 640x480,
  `interior_dataset.py:26-30`), images at `<scene>/jpg/<idx>.jpg`, 16-bit GT
  depth at `<scene>/depth/<idx>.png` resized NEAREST
  (`interior_dataset.py:101-123`), GT poses from `cam0.ccam` (wxyz quat,
  cols 6:13; `interior_dataset.py:60-78`) with per-frame relative pose to
  frames +-1 expressed as (axis-angle, translation) pairs
  (`interior_dataset.py:125-130` + Euler conversion 80-99 — we use the
  proper axis-angle instead of the reference's Euler-as-axis-angle
  approximation, see note below).
* KITTI raw (`ref/monodepth2/trainer.py:109-117` selects kitti datasets):
  the standard drive folder layout `image_02/data/NNNNNNNNNN.png`.
* AirSim capture (`ref/airsim/main.cpp:1369-1392`): numbered pairs
  `front/N.jpg` + `depth/N.jpg`.
* split files `"<folder> <index>"` (`ref/monodepth2/interiornet_1_1/
  writecsv.py:1-7`), generator included.

Note on the reference quirk: `Qwxyz2EulerAngle` feeds *Euler angles* into a
pipeline that expects axis-angle (SURVEY.md §7 quirks). For small rotations
they nearly coincide; we provide the correct axis-angle (and a
`euler_compat=True` switch reproducing the reference behavior bit-for-bit).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from tpu3drec_torch.utils.depthio import load_depth, load_image_rgb
from tpu3drec_torch.utils.poseio import read_ccam


@dataclass
class SequenceSpec:
    """One training sample address: (folder, frame_index)."""

    folder: str
    frame_index: int


def read_split_file(path: str) -> list[SequenceSpec]:
    """Parse `"<folder> <index>"` lines (`mono_dataset.py:145-148`)."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out.append(SequenceSpec(parts[0], int(parts[-1])))
    return out


def write_split_files(
    out_dir: str, folder: str, indices, train_frac: float = 0.835
) -> tuple[str, str]:
    """Generate train/val split files, the `writecsv.py` capability
    (`ref/monodepth2/interiornet_1_1/writecsv.py:1-7`; shipped splits are
    996/198 lines ~ 0.835)."""
    os.makedirs(out_dir, exist_ok=True)
    indices = list(indices)
    n_train = int(len(indices) * train_frac)
    paths = (
        os.path.join(out_dir, "train_files.txt"),
        os.path.join(out_dir, "val_files.txt"),
    )
    for p, idxs in zip(paths, (indices[:n_train], indices[n_train:])):
        with open(p, "w") as f:
            for i in idxs:
                f.write(f"{folder} {i}\n")
    return paths


def _axis_angle_from_quat_wxyz(q: np.ndarray) -> np.ndarray:
    w = np.clip(q[0] / max(np.linalg.norm(q), 1e-12), -1.0, 1.0)
    theta = 2.0 * np.arccos(w)
    s = np.sqrt(max(1.0 - w * w, 1e-24))
    axis = np.asarray(q[1:4]) / s
    if theta < 1e-8:
        return np.asarray(q[1:4]) * 2.0
    return axis * theta


def _euler_from_quat_wxyz(q: np.ndarray) -> np.ndarray:
    """The reference's Qwxyz2EulerAngle (`interior_dataset.py:80-99`):
    roll/pitch/yaw — provided for bit-compat mode."""
    qw, qx, qy, qz = q
    roll = np.arctan2(2 * (qw * qx + qy * qz), 1 - 2 * (qx * qx + qy * qy))
    sinp = 2 * (qw * qy - qz * qx)
    pitch = np.copysign(np.pi / 2, sinp) if abs(sinp) >= 1 else np.arcsin(sinp)
    yaw = np.arctan2(2 * (qw * qz + qx * qy), 1 - 2 * (qy * qy + qz * qz))
    return np.array([roll, pitch, yaw])


class InteriorNetDataset:
    """InteriorNet scene reader."""

    # normalized K of the reference (`interior_dataset.py:26-30`)
    K_NORM = np.array(
        [[0.9375, 0.0, 0.5], [0.0, 1.25, 0.5], [0.0, 0.0, 1.0]], np.float32
    )
    FULL_RES = (640, 480)  # (W, H)

    def __init__(self, data_path: str, img_ext: str = ".jpg",
                 euler_compat: bool = False):
        self.data_path = data_path
        self.img_ext = img_ext
        self.euler_compat = euler_compat
        self._pose_cache: dict[str, list] = {}

    def image_path(self, folder: str, idx: int) -> str:
        # `interior_dataset.py:101-104`
        return os.path.join(self.data_path, folder, "jpg", f"{idx}{self.img_ext}")

    def depth_path(self, folder: str, idx: int) -> str:
        return os.path.join(self.data_path, folder, "depth", f"{idx}.png")

    def load_color(self, folder: str, idx: int, size=None) -> np.ndarray:
        return load_image_rgb(self.image_path(folder, idx), size=size)

    def load_gt_depth(self, folder: str, idx: int) -> np.ndarray:
        # 16-bit PNG, NEAREST resize to full res (`interior_dataset.py:107-123`)
        return load_depth(self.depth_path(folder, idx), mode="uint16",
                          size=self.FULL_RES)

    def poses(self, folder: str):
        if folder not in self._pose_cache:
            self._pose_cache[folder] = read_ccam(
                os.path.join(self.data_path, folder, "cam0.ccam")
            )
        return self._pose_cache[folder]

    def gt_relative_pose(self, folder: str, idx: int):
        """(axisangle (2,3), translation (2,3)) rows [idx-1, idx+1], the
        contract `get_GTpose` feeds the trainer (`interior_dataset.py:125-130`)."""
        poses = self.poses(folder)
        rows_aa, rows_t = [], []
        conv = _euler_from_quat_wxyz if self.euler_compat else _axis_angle_from_quat_wxyz
        for j in (idx - 1, idx + 1):
            q, t = poses[j]
            rows_aa.append(conv(np.asarray(q, np.float64)))
            rows_t.append(np.asarray(t, np.float64))
        return (np.asarray(rows_aa, np.float32), np.asarray(rows_t, np.float32))


class KittiRawDataset:
    """KITTI raw drive folders (the reference's kitti/kitti_odom options,
    `ref/monodepth2/trainer.py:109-117`)."""

    # monodepth2's normalized KITTI intrinsics
    K_NORM = np.array(
        [[0.58, 0.0, 0.5], [0.0, 1.92, 0.5], [0.0, 0.0, 1.0]], np.float32
    )
    FULL_RES = (1242, 375)

    def __init__(self, data_path: str, img_ext: str = ".png", side: str = "l"):
        self.data_path = data_path
        self.img_ext = img_ext
        self.side = side

    def image_path(self, folder: str, idx: int, side: str | None = None) -> str:
        cam = {"l": "image_02", "r": "image_03"}[side or self.side]
        return os.path.join(
            self.data_path, folder, cam, "data", f"{idx:010d}{self.img_ext}"
        )

    def load_color(self, folder: str, idx: int, size=None, side=None) -> np.ndarray:
        return load_image_rgb(self.image_path(folder, idx, side), size=size)

    def load_stereo_color(self, folder: str, idx: int, size=None) -> np.ndarray:
        """Opposite-side partner of the configured side — the "s" frame the
        reference's stereo-training dataset attaches
        (`ref/monodepth2/mono_dataset.py:148-151,203-209`)."""
        other = {"l": "r", "r": "l"}[self.side]
        return self.load_color(folder, idx, size=size, side=other)


class AirSimCaptureDataset:
    """The AirSim capture client's output layout: `front/N.jpg` RGB +
    `depth/N.jpg` depth written per keypress (`ref/airsim/main.cpp:1369-1392`).
    Camera: cx=319.5 cy=239.5 f=269.5 (`main.cpp:40-43`)."""

    K = np.array(
        [[269.5, 0.0, 319.5], [0.0, 269.5, 239.5], [0.0, 0.0, 1.0]], np.float32
    )
    FULL_RES = (640, 480)

    def __init__(self, data_path: str, img_ext: str = ".jpg"):
        self.data_path = data_path
        self.img_ext = img_ext

    def frame_ids(self) -> list[int]:
        front = os.path.join(self.data_path, "front")
        ids = []
        for name in os.listdir(front):
            stem, ext = os.path.splitext(name)
            if ext == self.img_ext and stem.isdigit():
                ids.append(int(stem))
        return sorted(ids)

    def load_color(self, idx: int, size=None) -> np.ndarray:
        return load_image_rgb(
            os.path.join(self.data_path, "front", f"{idx}{self.img_ext}"), size=size
        )

    def load_depth(self, idx: int, size=None) -> np.ndarray:
        # the client saves float depth /255 as a 3-channel jpg
        # (`main.cpp:1381-1390`); decode one channel back
        return load_depth(
            os.path.join(self.data_path, "depth", f"{idx}{self.img_ext}"),
            mode="green8", size=size,
        )


def colmap_dense_depth_to_npy(src: str, dst: str, size=(640, 480)) -> np.ndarray:
    """COLMAP-dense depth image -> grayscale resized .npy — the
    `ref/other_tools/data_transfer.py:5-16` capability."""
    d = load_depth(src, mode="gray8", size=size)
    np.save(dst, d)
    return d

"""Pose-file IO (port of `tpu3drec/utils/poseio.py`): the on-disk pose
contracts, with output byte-identical to the JAX package's.

1. COLMAP-export pose txt: comma-separated rows
   ``id, tx, ty, tz, qx, qy, qz, qw, image.png`` after one header line; the
   quaternion is xyzw and (R|t) is the COLMAP **world->camera** convention.
2. 4x4 homogeneous ``T_data.txt`` from the ICP scale-correction step.
3. InteriorNet ``cam0.ccam`` camera poses (read only).
4. COLMAP's own sparse-model ``images.txt`` (read only).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PoseRecord:
    """One frame's pose: world->camera rotation (as xyzw quat) + translation."""

    frame_id: int
    t: np.ndarray  # (3,) float64
    q_xyzw: np.ndarray  # (4,) float64
    image_name: str


def read_pose_txt(path: str) -> list[PoseRecord]:
    """Parse the comma-separated pose txt contract. Skips the first line."""
    records = []
    with open(path) as f:
        lines = f.readlines()
    for line in lines[1:]:
        line = line.strip()
        if not line:
            continue
        cols = [c.strip() for c in line.split(",")]
        records.append(
            PoseRecord(
                frame_id=int(float(cols[0])),
                t=np.array([float(c) for c in cols[1:4]]),
                q_xyzw=np.array([float(c) for c in cols[4:8]]),
                image_name=cols[8],
            )
        )
    return records


def write_pose_txt(path: str, records: list[PoseRecord],
                   header: str = "id,tx,ty,tz,qx,qy,qz,qw,name") -> None:
    with open(path, "w") as f:
        f.write(header + "\n")
        for r in records:
            vals = [str(r.frame_id)] + [repr(float(v)) for v in r.t] + [
                repr(float(v)) for v in r.q_xyzw
            ] + [r.image_name]
            f.write(",".join(vals) + "\n")


def poses_to_arrays(records: list[PoseRecord]):
    """Stack records into (F,4) xyzw-quat and (F,3) t float32 arrays."""
    t = np.stack([r.t for r in records]).astype(np.float32)
    q = np.stack([r.q_xyzw for r in records]).astype(np.float32)
    return q, t


def read_T_txt(path: str) -> np.ndarray:
    """4x4 homogeneous transform from a whitespace txt."""
    T = np.loadtxt(path, dtype=np.float64)
    if T.shape != (4, 4):
        raise ValueError(f"expected 4x4 T, got {T.shape} from {path}")
    return T


def write_T_txt(path: str, T) -> None:
    np.savetxt(path, np.asarray(T).reshape(4, 4), fmt="%.9f")


def read_ccam(path: str) -> list[tuple[np.ndarray, np.ndarray]]:
    """InteriorNet ``cam0.ccam``: per-frame (q_wxyz (4,), t (3,)) in file
    order (columns 6:10 and 10:13), '#' lines skipped."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            out.append((np.array(vals[6:10]), np.array(vals[10:13])))
    return out


def read_colmap_images_txt(path: str) -> list[PoseRecord]:
    """COLMAP sparse-model ``images.txt``: header comments, then per image two
    lines, ``IMAGE_ID qw qx qy qz tx ty tz CAMERA_ID NAME`` and its POINTS2D
    line. Returns records with the quaternion converted to xyzw to match
    :class:`PoseRecord`.

    Lines pair by their position among the non-comment lines, empty lines
    included: COLMAP writes an empty POINTS2D line for an image that observes
    no point (the JAX package drops empty lines first, so such a file shifts
    its pairs and fails to parse). An empty image line (blank lines at the
    end of the file) is no record."""
    records = []
    with open(path) as f:
        lines = [line.strip() for line in f if not line.startswith("#")]
    for img_line in lines[0::2]:
        if not img_line:
            continue
        cols = img_line.split()
        qw, qx, qy, qz = (float(c) for c in cols[1:5])
        records.append(
            PoseRecord(
                frame_id=int(cols[0]),
                t=np.array([float(c) for c in cols[5:8]]),
                q_xyzw=np.array([qx, qy, qz, qw]),
                image_name=cols[9] if len(cols) > 9 else "",
            )
        )
    return records

"""Typed, serializable config tree (port of `tpu3drec/utils/config.py`).

Each stage states its config as a dataclass; the tree round-trips through
the same JSON files the JAX package reads.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field, fields, is_dataclass


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def from_dict(cls, d: dict):
    """Recursively build a dataclass from a plain dict (inverse of to_dict).
    Field types are resolved with ``get_type_hints``, since under
    ``from __future__ import annotations`` the raw ``f.type`` is a string."""
    if not is_dataclass(cls):
        return d
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        ftype = hints.get(f.name, f.type)
        if is_dataclass(ftype) and isinstance(v, dict):
            v = from_dict(ftype, v)
        elif isinstance(v, list):
            v = list(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def save_json(cfg, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2)


def load_json(cls, path: str):
    with open(path) as f:
        return from_dict(cls, json.load(f))


@dataclass
class CameraConfig:
    """Pinhole intrinsics (reference defaults)."""

    fx: float = 600.391
    fy: float = 600.079
    cx: float = 320.0
    cy: float = 240.0
    width: int = 640
    height: int = 480

    def to_camera(self, device=None):
        from tpu3drec_torch.core.camera import PinholeCamera

        return PinholeCamera.create(self.fx, self.fy, self.cx, self.cy,
                                    self.width, self.height, device=device)


@dataclass
class DepthDecodeConfig:
    """Depth-decoding contract (see `utils/depthio.py` for modes)."""

    mode: str = "gray8"
    scale: float = 1.0


@dataclass
class MapConfig:
    """Map-building parameters."""

    voxel_res: float = 0.1  # octree resolution, reference default
    min_depth: float = 1e-3  # mask non-returns; 0.0 reproduces the reference exactly
    max_depth: float = 1e9
    ply_binary: bool = False
    max_points: int = 0  # 0 = unlimited (the reference capped at 5.4M)


@dataclass
class MeshConfig:
    """Device-mesh layout (read from the shared JSON; the single-process
    port does not use it yet)."""

    data: int = 1
    space: int = 1
    model: int = 1


@dataclass
class RGBDPipelineConfig:
    """Config for the RGBD mapping pipeline (reference configuration 1)."""

    camera: CameraConfig = field(default_factory=CameraConfig)
    depth: DepthDecodeConfig = field(default_factory=DepthDecodeConfig)
    map: MapConfig = field(default_factory=MapConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    pose_file: str = ""
    depth_dir: str = ""
    rgb_dir: str = ""  # optional: color the cloud from RGB frames
    out_ply: str = "out/map.ply"
    out_bt: str = ""  # empty = skip octree export
    batch_frames: int = 32

"""Entry `rgbd_fuse`: one job is `pipelines/rgbd.run_arrays` on a sequence of
depth frames with given poses, writing the `.bt` and no PLY. Set-up
ray-casts a pool of seeded corridor sequences (`portbench/core/scenes.py`)
and runs one warm job.

The check, after the window: a sample of the completed jobs, drawn from
the seed (the first job and ``check_jobs`` more), each with its world
points as the timed path returned them and its `.bt`, against the plain
float64 fusion of the same frames and poses: points and their count; and
the file's voxels against those of the points.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from portbench.core.harness import check
from portbench.core.scenes import make_scene
from portbench.references import rgbd_fuse as ref


def sample_jobs(seed: int, traffic: dict) -> set:
    """Job 0 and ``check_jobs`` more drawn from the seed among the first
    ``check_span`` jobs."""
    rng = np.random.default_rng([seed, 1])
    drawn = rng.choice(np.arange(1, traffic["check_span"]), traffic["check_jobs"], replace=False)
    return {0, *map(int, drawn)}


def map_config(ctx, camera: dict, path: str):
    from tpu3drec_torch.utils.config import CameraConfig, MapConfig, RGBDPipelineConfig

    c = ctx.config
    return RGBDPipelineConfig(
        camera=CameraConfig(fx=camera["fx"], fy=camera["fy"], cx=camera["cx"], cy=camera["cy"],
                            width=camera["width"], height=camera["height"]),
        map=MapConfig(voxel_res=c["voxel_res"], min_depth=c["min_depth"],
                      max_depth=c["max_depth"]),
        out_ply="", out_bt=path)


def fusion_checks(ctx, camera: dict, kept: dict, depth_of, pose_of, dtype=None) -> list:
    """Each kept job's world points against the plain fusion of
    ``depth_of(i)`` and ``pose_of(i)`` in float64 (their count exactly),
    then its `.bt` against the voxels of those points (exactly: the walls of
    the corridor lie on voxel boundaries, where float32 and float64 keys
    differ, so the voxel stage follows the program's checked points). With
    ``dtype`` the control: the reference in that dtype takes the program's
    place."""
    c, lim = ctx.config, ctx.traffic["limits"]
    errs, counts, off = [], [], []
    for i, (points, bt) in sorted(kept.items()):
        q, t = pose_of(i)
        want = ref.world_points(depth_of(i), q, t, camera, c["min_depth"], c["max_depth"])
        if dtype is not None:
            points = ref.world_points(depth_of(i), q, t, camera, c["min_depth"], c["max_depth"],
                                      dtype=dtype, device=ctx.device)
        else:
            off.append(ref.voxels_off(bt, points, c["voxel_res"]))
        counts.append(abs((0 if points is None else points.shape[0]) - want.shape[0]))
        errs.append(ref.points_error(points, want))
    return [check("points_err", max(errs, default=None), lim["points_err"]),
            check("points_count_off", max(counts, default=None), 0)] + (
        [check("bt_voxels_off", max(off, default=None), 0)] if dtype is None else [])


class Entry:
    def __init__(self, ctx):
        from tpu3drec_torch.pipelines import rgbd
        from tpu3drec_torch.utils import native

        native.load()  # the map-export library, built once into the checkout
        self.ctx, self.rgbd = ctx, rgbd
        cam, tr = ctx.config["camera"], ctx.traffic
        rng = np.random.default_rng(ctx.seed)
        self.seqs = []
        for _ in range(tr["sequence_pool"]):
            d, _, _, q, t = make_scene(rng, tr["frames"], cam["height"], cam["width"],
                                       cam["fx"], cam["fy"], cam["cx"], cam["cy"], ctx.device)
            self.seqs.append((d, q.astype(np.float32), t.astype(np.float32)))
        self.sample = sample_jobs(ctx.seed, tr)
        self.kept = {}
        self.job(-1)

    def job(self, i: int) -> dict:
        d, q, t = self.seqs[i % len(self.seqs)]
        if self.ctx.mode == "fault_half":  # half of the frames left out
            d, q, t = d[: len(d) // 2], q[: len(q) // 2], t[: len(t) // 2]
        path = os.path.join(self.ctx.out_dir, f"job{i}.bt")
        cfg = map_config(self.ctx, self.ctx.config["camera"], path)
        res = self.rgbd.run_arrays(d, q, t, cfg, keep_points=i in self.sample,
                                   device=self.ctx.device)
        if i in self.sample:
            pts = res.points
            if self.ctx.mode == "fault_points":  # the answer altered where it is produced
                pts = pts.copy()
                pts[0] += 0.5
            self.kept[i] = (pts, path)
        return {"work": res.n_frames}

    def release(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def _seq(self, i):
        return self.seqs[i % len(self.seqs)]

    def check(self, records) -> list:
        return fusion_checks(self.ctx, self.ctx.config["camera"], self.kept,
                             lambda i: self._seq(i)[0], lambda i: self._seq(i)[1:])

    def control(self) -> list:
        """The plain fusion in bfloat16 in the program's place."""
        kept = {i: (None, None) for i in sorted(self.sample)[:2]}
        return fusion_checks(self.ctx, self.ctx.config["camera"], kept,
                             lambda i: self._seq(i)[0], lambda i: self._seq(i)[1:],
                             dtype=torch.bfloat16)

"""Entry `sfm_pipeline`: one job is `pipelines/sfm_pipeline.run` on a
sequence of scene renderings, writing the pose txt and the sparse PLY.
Set-up renders a pool of scenes (`portbench/core/scenes.py`), the same for
every seed, which the seed orders; the seed also seeds RANSAC. Then one
warm job.

The check, after the window: every completed job's pose txt against its
scene's true poses (every frame registered, ATE as a share of the
trajectory), and every matcher launch of the window (its descriptors,
mask and top-2, recorded as the timed path produced them) against a
float64 top-2.

Besides the faults that the tests plant, two modes read what the limits
are set from: ``fault_no_ba`` (bundle adjustment returns its state
unchanged) and ``control_tf32`` (the program's own float32 pin,
`core/fp.py::ieee_fp32`, switched to TF32: the nearest precision below
the configuration's).
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from portbench.core.harness import check
from portbench.core.scenes import make_sfm_scene
from portbench.references import sfm_pipeline as ref


class Entry:
    def __init__(self, ctx):
        from tpu3drec_torch.ops import matcher
        from tpu3drec_torch.pipelines import sfm_pipeline

        if ctx.device.type == "cuda":
            from tpu3drec_torch.ops import build

            build.build()
        self.ctx, self.sfm_pipeline, self.matcher = ctx, sfm_pipeline, matcher
        cam, tr = ctx.config["camera"], ctx.traffic
        h, w = cam["height"], cam["width"]
        # every seed gets the same scenes, in an order of its own: the work
        # of an SfM job depends on its scene, and a rate over a few jobs
        # would otherwise follow the seed
        self.scenes = [make_sfm_scene(np.random.default_rng([tr["scene_seed"], k]), tr["frames"],
                                      h, w, cam["fx"]) for k in range(tr["scene_pool"])]
        self.order = np.random.default_rng(ctx.seed).permutation(tr["scene_pool"])
        self.K = np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]], [0, 0, 1]],
                          np.float32)
        self.calls = []          # (job, a, b, valid_b, best, top2) of each matcher launch
        self.paths = {}
        self._job = None
        self._kernel = matcher.topk2_scores_batched
        matcher.topk2_scores_batched = self._recorded
        self._patches = []
        try:
            self.job(-1)         # warm-up: the first calls of every library and kernel
        except BaseException:
            self.release()
            raise
        self.calls.clear()
        if ctx.mode == "fault_no_ba":
            from tpu3drec_torch.sfm import incremental

            self._patch(incremental, "_run_ba", lambda *a, **kw: None)
        elif ctx.mode == "control_tf32":
            from tpu3drec_torch.core import fp

            self._patch(fp, "ieee_fp32", _tf32)

    def _patch(self, mod, name, value) -> None:
        self._patches.append((mod, name, getattr(mod, name)))
        setattr(mod, name, value)

    def _recorded(self, a, b, valid_b):
        best, top2 = self._kernel(a, b, valid_b)
        if self._job is not None and self._job >= 0:
            if self.ctx.mode == "fault_matcher":  # the answer altered where it is produced
                best = best.clone()
                best[:, 0] = (best[:, 0] + 1) % b.shape[1]
            self.calls.append((self._job, a, b, valid_b, best, top2))
        return best, top2

    def job(self, i: int) -> dict:
        images, _, _ = self._scene(i)
        sfm = self.ctx.config["sfm"]
        out = os.path.join(self.ctx.out_dir, f"job{i}")
        cfg = self.sfm_pipeline.SfmPipelineConfig(
            max_keypoints=sfm["max_keypoints"], overlap=sfm["overlap"],
            ba_every=sfm["ba_every"], out_poses=out + "_poses.txt",
            out_sparse_ply=out + "_sparse.ply", seed=self.ctx.seed % (2 ** 31))
        self._job = i
        rec = self.sfm_pipeline.run(images, self.K, cfg, device=self.ctx.device)
        self._job = None
        if self.ctx.mode == "fault_poses" and i >= 0:  # the answer altered where produced
            with open(cfg.out_poses) as f:
                lines = f.read().splitlines()
            cols = lines[-1].split(",")
            cols[1] = repr(float(cols[1]) + 1.0)
            lines[-1] = ",".join(cols)
            with open(cfg.out_poses, "w") as f:
                f.write("\n".join(lines) + "\n")
        self.paths[i] = cfg.out_poses
        return {"work": len(rec.registered_frames()), "seconds": dict(rec.seconds)}

    def _scene(self, i: int):
        return self.scenes[self.order[i % len(self.order)]]

    def release(self) -> None:
        self.matcher.topk2_scores_batched = self._kernel
        for mod, name, value in reversed(self._patches):
            setattr(mod, name, value)
        self._patches.clear()
        self.scenes = [(None, poses, n) for _, poses, n in self.scenes]
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def _checks(self, records, calls) -> list:
        lim = self.ctx.traffic["limits"]
        registered, ate = [], []
        for r in records:
            if r.get("failed"):
                continue
            n, share = ref.trajectory(self.paths[r["i"]], self._scene(r["i"])[1])
            registered.append(n)
            ate.append(share)
        gaps = [ref.top2_gap(a, b, v, best, top2) for _, a, b, v, best, top2 in calls]
        return [check("registered_min", min(registered, default=None),
                      self.ctx.traffic["frames"], ">="),
                check("ate_share", max(ate, default=None), lim["ate_share"]),
                check("matcher_gap", max(gaps, default=None), lim["matcher_gap"])]

    def check(self, records) -> list:
        return self._checks(records, self.calls)

    def control(self) -> list:
        """The window's matcher launches answered by the control (the TF32
        product in the program's place), judged as the program is."""
        calls = [(j, a, b, v) + ref.top2_control(a, b, v) for j, a, b, v, _, _ in self.calls]
        return self._checks([], calls)[2:]


@contextlib.contextmanager
def _tf32():
    """`ieee_fp32`'s place taken by its opposite: TF32 products in scope."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

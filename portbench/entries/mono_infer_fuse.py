"""Entry `mono_infer_fuse`: one job is `pipelines/monocular.infer_depth_maps`
on a sequence of uint8 RGB frames, in chunks, then `pipelines/rgbd.
run_arrays` of the depth with the frames' poses and KITTI's intrinsics,
writing the `.bt`. Set-up makes the depth net's weights and a pool of
textured sequences (a camera sliding sideways, `portbench/core/frames.py`)
on the device from the seed, and runs one warm job.

The check, after the window: a sample of the completed jobs drawn from the
seed. Their depth against the plain depth net in float64 on the same
frames and weights; then their points and `.bt` against the plain float64
fusion of the depth the program served (this stage follows the program's
own depth, so the depth is checked on its own first).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from portbench.core import frames
from portbench.core.harness import check
from portbench.entries import monodepth_common as common
from portbench.entries.rgbd_fuse import fusion_checks, map_config, sample_jobs
from portbench.references import monodepth2 as ref


class Entry:
    def __init__(self, ctx):
        from tpu3drec_torch.pipelines import monocular, rgbd
        from tpu3drec_torch.utils import native

        native.load()
        self.ctx, self.monocular, self.rgbd = ctx, monocular, rgbd
        c, tr, dev = ctx.config, ctx.traffic, ctx.device
        self.camera = common.camera(c)
        self.weights = common.seeded_weights(ctx.seed, dev)
        self.model = common.port_model(self.weights, c, dev)
        self.tcfg = common.train_config(c)
        gen = torch.Generator(device=dev).manual_seed(ctx.seed)
        seqs = frames.sequences(gen, tr["sequence_pool"], tr["frames"], c["height"], c["width"],
                                tr["shift_px"], dev)
        self.seqs = (seqs * 255).round().to(torch.uint8).cpu().numpy()
        # world->camera rows of a camera moving along x by step_m a frame
        k = np.arange(tr["frames"], dtype=np.float32)
        self.q = np.tile(np.array([0, 0, 0, 1], np.float32), (tr["frames"], 1))
        self.t = np.stack([-tr["step_m"] * k, 0 * k, 0 * k], -1).astype(np.float32)
        self.sample = sample_jobs(ctx.seed, tr)
        self.kept, self.depth, self._ref = {}, {}, {}
        self.job(-1)

    def job(self, i: int) -> dict:
        imgs = self.seqs[i % len(self.seqs)]
        depth = self.monocular.infer_depth_maps(self.model, imgs, self.tcfg,
                                                batch=self.ctx.traffic["chunk"])
        if self.ctx.mode == "fault_depth" and i in self.sample:  # altered where produced
            depth = depth.copy()
            depth[0, 0, 0] *= 1.5
        path = os.path.join(self.ctx.out_dir, f"job{i}.bt")
        cfg = map_config(self.ctx, self.camera, path)
        res = self.rgbd.run_arrays(depth, self.q, self.t, cfg, keep_points=i in self.sample,
                                   device=self.ctx.device)
        if i in self.sample:
            self.kept[i] = (res.points, path)
            self.depth[i] = depth
        return {"work": len(imgs)}

    def release(self) -> None:
        del self.model
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference_depth(self, i: int, dtype=torch.float64) -> np.ndarray:
        c, dev = self.ctx.config, self.ctx.device
        if dtype not in self._ref:
            self._ref[dtype] = common.reference_model(self.weights, dtype, dev)
        model = self._ref[dtype]
        img = torch.as_tensor(self.seqs[i % len(self.seqs)], device=dev).to(dtype) / 255.0
        out = []
        with torch.no_grad():
            for chunk in img.split(self.ctx.traffic["chunk"]):
                if dtype == torch.float32:
                    with ref.tf32_convs():
                        disp = model.depth(chunk, False)[0]
                else:
                    disp = model.depth(chunk, False)[0]
                disp = ref.resize(disp, c["height"], c["width"])[..., 0]
                out.append(ref.disp_to_depth(disp, c["min_depth"], c["max_depth"])[1].double())
        return torch.cat(out).cpu().numpy()

    def _depth_check(self, served: dict) -> dict:
        errs = []
        for i, got in sorted(served.items()):
            want = self._reference_depth(i)
            errs.append(float((np.abs(got - want) / np.abs(want)).max())
                        if got.shape == want.shape else float("inf"))
        return check("depth_err", max(errs, default=None), self.ctx.traffic["limits"]["depth_err"])

    def check(self, records) -> list:
        return [self._depth_check(self.depth)] + fusion_checks(
            self.ctx, self.camera, self.kept, lambda i: self.depth[i],
            lambda i: (self.q, self.t))

    def control(self) -> list:
        """The plain depth net on TF32-rounded inputs in the program's place."""
        served = {i: self._reference_depth(i, torch.float32) for i in sorted(self.sample)[:2]}
        return [self._depth_check(served)]

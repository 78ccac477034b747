"""Entry `psmnet_train`: one job is one step of
`models/psmnet_training.make_stereo_train_step` on the published PSMNet
(forward through both towers, the cost volume, the stacked hourglass and
three full-resolution heads; the three-head loss; backward; Adam) on a batch
of stereo pairs. Set-up builds the net through `init_stereo_state`, the
function that `pipelines/stereo.train` and `train-stereo` call, loads the
benchmark's seeded weights (`references/psmnet.py::make_weights`, the
published rule), makes a pool of distinct batches on the device
(`portbench/core/stereo_frames.py`) and drives the step through its first
``reference_steps`` steps, on distinct batches, with the window's own call
and feed; then ``warm_steps`` more. The window goes on with the same state.

What the first steps leave is read in set-up: the first step's loss and its
third head's disparity (a forward hook on the net), the first gradient as
Adam got it (its first moment after one step over 1 - beta1), the
parameters' change and the batch-norm statistics' change after the last of
them. After the window the plain reference, in float64 with its stages
checkpointed, takes the same steps from the same weights on the same
batches; the loss is compared relatively, the disparity by its largest gap
in px, the rest by the worst leaf (`mono_train.worst_leaf`: the gap of the
two norms over the larger of the reference's norm of that leaf and of the
median leaf). Leaves whose reference gradient is under a thousandth of the
median leaf's move under Adam by rounding alone and are left out of the
change.

One step inside the window, drawn from the seed after the profiled slice,
is held the same way by its loss, change and statistics: the job copies the
state (parameters, batch-norm buffers, Adam's moments) before and after it,
and after the window the reference takes that step from the copy, on its
batch.
"""

from __future__ import annotations

import contextlib
import statistics
import sys
import time

import numpy as np
import torch

from portbench.core import stereo_frames
from portbench.core.harness import check
from portbench.entries.mono_train import BETA1, worst_leaf
from portbench.references import psmnet as ref


def train_config(config: dict):
    from tpu3drec_torch.models.psmnet_training import StereoTrainConfig

    return StereoTrainConfig(
        learning_rate=config["learning_rate"], batch_size=config["batch_size"],
        height=config["height"], width=config["width"], max_disp=config["max_disp"],
        arch=config["arch"], spp_pools=tuple(config["spp_pools"]), compute_dtype="float32")


def seeded_weights(config: dict, seed: int, device) -> dict:
    with torch.device("meta"):
        shapes = ref.PSMNet(config["max_disp"], tuple(config["spp_pools"]))
    return ref.make_weights(shapes, seed, device)


class Entry:
    def __init__(self, ctx):
        # a program without the published net stops here, at once
        from tpu3drec_torch.models.psmnet import StackHourglassPSMNet  # noqa: F401
        from tpu3drec_torch.models.psmnet_training import (
            init_stereo_state, make_stereo_train_step)

        self.ctx = ctx
        c, tr, dev = ctx.config, ctx.traffic, ctx.device
        n, h, w = c["batch_size"], c["height"], c["width"]
        self.cfg = train_config(c)
        model, self.state = init_stereo_state(ctx.seed, self.cfg, device=dev)
        self.weights = seeded_weights(c, ctx.seed, dev)
        model.load_state_dict(self.weights)
        self.step_fn = make_stereo_train_step(self.cfg)
        gen = torch.Generator(device=dev).manual_seed(ctx.seed)
        scale = c["max_disp"] / stereo_frames.MAX_DISP
        self.batches = [stereo_frames.pairs(gen, n, h, w, dev, scale)
                        for _ in range(tr["batch_pool"])]
        valid = torch.stack([(b["disp"] < c["max_disp"]).float().mean() for b in self.batches])
        print(f"portbench: pixels under max_disp {c['max_disp']} by batch "
              f"{[round(float(v), 4) for v in valid]}", file=sys.stderr, flush=True)
        self.losses = []
        self.k = 0  # steps taken
        self.check_at = (tr["trace_after"] + tr["trace_jobs"]
                         + int(np.random.default_rng([ctx.seed, 3]).integers(tr["check_span"])))
        self.min_jobs = self.check_at + 1
        self.snap = None
        if ctx.mode == "fault_unchanged":  # a step that leaves its state unchanged
            self.state.optimizer.step = lambda *a, **kw: None
        names = [k for k, _ in model.named_parameters()]
        stats = [k for k in model.state_dict() if "running_" in k]
        start = {k: v.detach().clone() for k, v in model.state_dict().items()}
        self.got = {}
        seen = {}

        def keep_pred3(module, args, out):  # returns None: the output stays the net's
            seen.setdefault("pred", out[-1].detach().clone())

        hook = model.register_forward_hook(keep_pred3)
        for s in range(tr["reference_steps"]):
            self.job(-1)
            if s == 0:
                hook.remove()
                opt = self.state.optimizer
                g = {}
                for k, p in model.named_parameters():
                    st = opt.state.get(p, {})
                    if "exp_avg" in st:
                        g[k] = float(st["exp_avg"].double().norm() / (1 - BETA1))
                self.got["grad"] = g
        sd = model.state_dict()
        self.got["change"] = {k: float((sd[k].double() - start[k].double()).norm()) for k in names}
        self.got["stats"] = {k: float((sd[k].double() - start[k].double()).norm()) for k in stats}
        self.got["loss"] = [float(x) for x in self.losses]
        self.got["pred"] = seen["pred"]
        self.ref_batches = self.batches[:tr["reference_steps"]]
        self.losses.clear()
        for _ in range(tr["warm_steps"]):
            self.job(-1)
        self.losses.clear()

    def job(self, i: int) -> dict:
        b = self.batches[self.k % len(self.batches)]
        held = i == self.check_at
        if held:
            self.snap = {"batch": b, "step": self.k, "before": self._copy()}
        if self.ctx.mode == "fault_half":  # half of the batch left out
            b = {key: v[: v.shape[0] // 2] for key, v in b.items()}
        self.state, loss = self.step_fn(self.state, b)
        if self.ctx.mode == "fault_loss":  # the answer altered where it is produced
            loss = loss * 1.01
        self.losses.append(loss)
        self.k += 1
        if held:
            self.snap.update(after=self._copy(moments=False), loss=loss)
        return {"work": b["left"].shape[0]}

    def _copy(self, moments: bool = True) -> dict:
        """The state as it stands: the state dict and Adam's two moments."""
        model, opt = self.state.model, self.state.optimizer
        out = {"sd": {k: v.detach().clone() for k, v in model.state_dict().items()},
               "m": {}, "v": {}}
        for k, p in model.named_parameters() if moments else ():
            st = opt.state.get(p, {})
            if "exp_avg" in st:
                out["m"][k] = st["exp_avg"].clone()
                out["v"][k] = st["exp_avg_sq"].clone()
        return out

    def release(self) -> None:
        del self.state, self.step_fn
        self.batches = self.ref_batches + ([self.snap["batch"]] if self.snap else [])
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, weights: dict, dtype):
        c = self.ctx.config
        with torch.device(self.ctx.device):
            model = ref.PSMNet(c["max_disp"], tuple(c["spp_pools"]))
        model.load_state_dict(weights)
        return model.to(dtype)

    def _ref_step(self, model, batch: dict, dtype, tf32: bool):
        """One reference loss and backward, stages checkpointed; returns
        (loss, the third head's disparity)."""
        ctx = ref.tf32_convs() if tf32 else contextlib.nullcontext()
        batch = {k: v.to(dtype) for k, v in batch.items()}
        for p in model.parameters():
            p.grad = None
        with ctx:
            loss, preds = ref.loss(model, batch, checkpoint=True)
            with ref.frozen_statistics():
                loss.backward()
        return loss.detach(), preds[-1].detach()

    def reference_readings(self, dtype=torch.float64, tf32: bool = False) -> dict:
        """The same first steps by the plain reference; ``tf32``: on
        TF32-rounded convolution inputs in float32 (the control)."""
        model = self._reference(self.weights, dtype)
        params = dict(model.named_parameters())
        start = {k: v.detach().clone() for k, v in model.state_dict().items()}
        adam, out = {}, {"loss": []}
        for step, b in enumerate(self.ref_batches, 1):
            loss, pred = self._ref_step(model, b, dtype, tf32)
            grads = {k: p.grad for k, p in params.items()}
            if step == 1:
                out["grad"] = {k: float(g.double().norm()) for k, g in grads.items()}
                out["pred"] = pred
            ref.adam_step(params, grads, adam, step, self.ctx.config["learning_rate"])
            out["loss"].append(float(loss))
        sd = model.state_dict()
        out["change"] = {k: float((sd[k].double() - start[k].double()).norm()) for k in params}
        out["stats"] = {k: float((sd[k].double() - start[k].double()).norm())
                        for k in sd if "running_" in k}
        return out

    def window_got(self) -> dict | None:
        """What the window's held step did, read from its two copies."""
        s = self.snap
        if s is None or "after" not in s:
            return None
        a, b = s["after"], s["before"]

        def change(key):
            return float((a["sd"][key].double() - b["sd"][key].double()).norm())

        return {"loss": [float(s["loss"])],
                "change": {k: change(k) for k in b["m"]},  # the leaves Adam holds
                "stats": {k: change(k) for k in b["sd"] if "running_" in k}}

    def reference_step(self, dtype=torch.float64, tf32: bool = False) -> dict:
        """The window's held step by the plain reference, from the copy the
        job took before it; ``tf32`` as in `reference_readings`."""
        s = self.snap
        b = s["before"]
        model = self._reference(b["sd"], dtype)
        params = dict(model.named_parameters())
        adam = {k: (b["m"][k].to(dtype).clone(), b["v"][k].to(dtype).clone())
                for k in params if k in b["m"]}
        loss, _ = self._ref_step(model, s["batch"], dtype, tf32)
        grads = {k: p.grad for k, p in params.items()}
        out = {"loss": [float(loss)],
               "grad": {k: float(g.double().norm()) for k, g in grads.items()}}
        ref.adam_step(params, grads, adam, s["step"] + 1, self.ctx.config["learning_rate"])
        sd = model.state_dict()
        out["change"] = {k: float((sd[k].double() - b["sd"][k].double()).norm()) for k in params}
        out["stats"] = {k: float((sd[k].double() - b["sd"][k].double()).norm())
                        for k in sd if "running_" in k}
        return out

    def _compare(self, got: dict | None, want: dict, prefix: str = "") -> list:
        """The gaps that the traffic gives a limit, each beside it."""
        lim = self.ctx.traffic["limits"]
        names = [n for n in ("loss", "pred", "grad", "change", "stats")
                 if f"{prefix}{n}_gap" in lim]
        if got is None:  # the held step never ran
            return [check(f"{prefix}{n}_gap", None, lim[f"{prefix}{n}_gap"]) for n in names]
        med = statistics.median(want["grad"].values())
        moved = [k for k, g in want["grad"].items() if g >= 1e-3 * med]
        print(f"portbench: {'the held step' if prefix else 'the first steps'}: the change "
              f"compared over {len(moved)} of {len(want['grad'])} leaves",
              file=sys.stderr, flush=True)
        out = []
        for n in names:
            if n == "loss":
                gap = max((abs(a - b) / abs(b)
                           for a, b in zip(got["loss"][:1], want["loss"][:1])),
                          default=float("inf"))
                if len(got["loss"]) != len(want["loss"]):
                    gap = float("inf")
            elif n == "pred":  # px, the largest over the batch's pixels
                a, b = got["pred"], want["pred"]
                gap = (float((a.double() - b.double()).abs().max()) if a.shape == b.shape
                       else float("inf"))
            else:
                gap, k = worst_leaf(got.get(n, {}), want[n], moved if n == "change" else None)
                if k is not None:
                    print(f"portbench: {prefix}{n}_gap worst leaf {k}: {got[n][k]!r} against "
                          f"{want[n][k]!r}, gap {gap!r}", file=sys.stderr, flush=True)
            out.append(check(f"{prefix}{n}_gap", gap, lim[f"{prefix}{n}_gap"]))
        return out

    def check(self, records) -> list:
        t0 = time.perf_counter()
        dev = self.ctx.device
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        window = [float(x) for x in self.losses]
        bad = sum(1 for x in window if x != x or abs(x) == float("inf"))
        held = self.window_got()
        out = (self._compare(self.got, self.reference_readings())
               + self._compare(held, self.reference_step() if held else None, "window_")
               + [check("window_nonfinite_losses", bad if window else None, 0)])
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        print(f"portbench: the float64 check took {time.perf_counter() - t0:.1f} s, "
              f"peak memory {peak / 1e9:.2f} GB", file=sys.stderr, flush=True)
        return out

    def control(self) -> list:
        """The reference on TF32-rounded inputs in float32 in the program's place."""
        return (self._compare(self.reference_readings(torch.float32, tf32=True),
                              self.reference_readings())
                + self._compare(self.reference_step(torch.float32, tf32=True),
                                self.reference_step(), "window_"))

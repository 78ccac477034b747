"""Entry `mono_train`: one job is one step of `models/training.make_train_step`
(pose-net path: forward, loss, backward, Adam) on a batch of triplets.
Set-up makes the weights and a pool of distinct batches (textured frames
under a small known camera motion, `portbench/core/frames.py`) on the
device from the seed, builds one model and optimizer, and drives that same
object through its first ``reference_steps`` steps, on distinct batches,
with the window's own call and feed; then ``warm_steps`` more. The window
goes on with the same object.

What the first steps leave is read in set-up: the first step's loss, the
first gradient as Adam got it (its first moment after one step over 1 -
beta1), the parameters' change and the batch-norm statistics' change
after the last of them. After the window the plain reference (float64)
takes the same steps from the same weights on the same batches and noise;
the loss is compared relatively, and the rest by the worst leaf: the gap
between the two norms, over the reference's norm of that leaf or of the
median leaf, whichever is larger. Leaves whose reference gradient is under
a thousandth of the median leaf's move under Adam by rounding alone and
are left out of the change. The later steps' losses are not compared:
Adam's first update moves each weight by about the learning rate whatever
its gradient, so weights whose gradient is near zero move apart in sign
between float32 and float64, and the plain float32 reference's third
loss reads up to 6e-3 from float64's.

One step inside the window, drawn from the seed after the profiled slice,
is held the same way by its loss, change and statistics: the job copies
the state (parameters, batch-norm buffers, Adam's moments) before and
after it, and after the window the reference takes that step from the
copy, on its batch and noise. Its gradient is not compared: some tens of
steps in, the depth net's gradients can vanish (the float64 reference
reads 1e-16 on most of its leaves), and the worst leaf against the
median leaf then reads float32's rounding of zero.
"""

from __future__ import annotations

import contextlib
import statistics
import sys

import numpy as np
import torch

from portbench.core import frames
from portbench.core.harness import check
from portbench.entries import monodepth_common as common
from portbench.references import monodepth2 as ref

BETA1 = 0.9


def worst_leaf(got: dict, want: dict, keys=None):
    """(max over leaves of |got - want| / max(want, median of want), that
    leaf's name)."""
    keys = list(want) if keys is None else keys
    if not keys or any(k not in got for k in keys):
        return float("inf"), None
    med = statistics.median(want[k] for k in want)
    return max((abs(got[k] - want[k]) / max(want[k], med, 1e-30), k) for k in keys)


class Entry:
    def __init__(self, ctx):
        from tpu3drec_torch.models.training import TrainState, lr_schedule, make_optimizer
        from tpu3drec_torch.models.training import make_train_step

        self.ctx = ctx
        c, tr, dev = ctx.config, ctx.traffic, ctx.device
        n, h, w = c["batch_size"], c["height"], c["width"]
        self.weights = common.seeded_weights(ctx.seed, dev)
        model = common.port_model(self.weights, c, dev)
        self.tcfg = common.train_config(c)
        self.state = TrainState(model, make_optimizer(self.tcfg, model.parameters()),
                                lr_schedule(self.tcfg, tr["steps_per_epoch"]))
        self.step_fn = make_train_step(self.tcfg)
        gen = torch.Generator(device=dev).manual_seed(ctx.seed)
        seq = frames.sequences(gen, tr["batch_pool"] * n, 3, h, w, tr["shift_px"], dev)
        seq = seq.view(tr["batch_pool"], n, 3, h, w, 3)
        self.batches = [{"prev": b[:, 0], "target": b[:, 1], "next": b[:, 2]} for b in seq]
        self.noise_gen = torch.Generator(device=dev).manual_seed(ctx.seed + 1)
        self.losses, self.noises = [], []
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
        for s in range(tr["reference_steps"]):
            self.job(-1)
            if s == 0:
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
        self.ref_batches = self.batches[:tr["reference_steps"]]
        self.ref_noises = list(self.noises)
        self.losses.clear()
        for _ in range(tr["warm_steps"]):
            self.job(-1)
        self.losses.clear()

    def job(self, i: int) -> dict:
        b = self.batches[self.k % len(self.batches)]
        noise = torch.randn((2,) + b["target"].shape[:3], generator=self.noise_gen,
                            device=self.ctx.device)
        if len(self.noises) < self.ctx.traffic["reference_steps"]:
            self.noises.append(noise)
        held = i == self.check_at
        if held:
            self.snap = {"batch": b, "noise": noise, "step": self.k, "before": self._copy()}
        if self.ctx.mode == "fault_half":  # half of the batch left out
            b = {key: v[: v.shape[0] // 2] for key, v in b.items()}
            noise = noise[:, : noise.shape[1] // 2]
        self.state, loss, _ = self.step_fn(self.state, b, noise=noise)
        if self.ctx.mode == "fault_loss":  # the answer altered where it is produced
            loss = loss * 1.01
        self.losses.append(loss)
        self.k += 1
        if held:
            self.snap.update(after=self._copy(moments=False), loss=loss)
        return {"work": b["target"].shape[0]}

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
        del self.state, self.step_fn, self.batches
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_readings(self, dtype=torch.float64, tf32: bool = False) -> dict:
        """The same first steps by the plain reference; ``tf32``: on
        TF32-rounded convolution inputs in float32 (the control)."""
        c = self.ctx.config
        model = common.reference_model(self.weights, dtype, self.ctx.device)
        params = dict(model.named_parameters())
        start = {k: v.detach().clone() for k, v in model.state_dict().items()}
        settings = common.loss_settings(c)
        adam, out = {}, {"loss": []}
        for step, (b, noise) in enumerate(zip(self.ref_batches, self.ref_noises), 1):
            batch = {k: v.to(dtype) for k, v in b.items()}
            for p in params.values():
                p.grad = None
            if tf32:
                with ref.tf32_convs():
                    loss = ref.loss(model, batch, noise, settings)
            else:
                loss = ref.loss(model, batch, noise, settings)
            loss.backward()
            grads = {k: p.grad for k, p in params.items()}
            if step == 1:
                out["grad"] = {k: float(g.double().norm()) for k, g in grads.items()}
            ref.adam_step(params, grads, adam, step, c["learning_rate"])
            out["loss"].append(float(loss.detach()))
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
        s, c = self.snap, self.ctx.config
        b = s["before"]
        model = common.reference_model(b["sd"], dtype, self.ctx.device)
        params = dict(model.named_parameters())
        adam = {k: (b["m"][k].to(dtype).clone(), b["v"][k].to(dtype).clone())
                for k in params if k in b["m"]}
        batch = {k: v.to(dtype) for k, v in s["batch"].items()}
        with ref.tf32_convs() if tf32 else contextlib.nullcontext():
            loss = ref.loss(model, batch, s["noise"], common.loss_settings(c))
        loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        out = {"loss": [float(loss.detach())],
               "grad": {k: float(g.double().norm()) for k, g in grads.items()}}
        ref.adam_step(params, grads, adam, s["step"] + 1, c["learning_rate"])
        sd = model.state_dict()
        out["change"] = {k: float((sd[k].double() - b["sd"][k].double()).norm()) for k in params}
        out["stats"] = {k: float((sd[k].double() - b["sd"][k].double()).norm())
                        for k in sd if "running_" in k}
        return out

    def _compare(self, got: dict | None, want: dict, prefix: str = "") -> list:
        """The gaps that the traffic gives a limit, each beside it."""
        lim = self.ctx.traffic["limits"]
        names = [n for n in ("loss", "grad", "change", "stats") if f"{prefix}{n}_gap" in lim]
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
            else:
                gap, k = worst_leaf(got.get(n, {}), want[n], moved if n == "change" else None)
                if k is not None:
                    print(f"portbench: {prefix}{n}_gap worst leaf {k}: {got[n][k]!r} against "
                          f"{want[n][k]!r}, gap {gap!r}", file=sys.stderr, flush=True)
            out.append(check(f"{prefix}{n}_gap", gap, lim[f"{prefix}{n}_gap"]))
        return out

    def check(self, records) -> list:
        window = [float(x) for x in self.losses]
        bad = sum(1 for x in window if x != x or abs(x) == float("inf"))
        held = self.window_got()
        return (self._compare(self.got, self.reference_readings())
                + self._compare(held, self.reference_step() if held else None, "window_")
                + [check("window_nonfinite_losses", bad if window else None, 0)])

    def control(self) -> list:
        """The reference on TF32-rounded inputs in float32 in the program's place."""
        return (self._compare(self.reference_readings(torch.float32, tf32=True),
                              self.reference_readings())
                + self._compare(self.reference_step(torch.float32, tf32=True),
                                self.reference_step(), "window_"))

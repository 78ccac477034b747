"""Ten train steps of `tools/train_convergence.py`'s configuration
(96x320, batch 4, lr 3e-4, the ground-truth-pose path, its scene and its
draw of batches) in both packages, in float64, from the same weights and
batch statistics, on the same batches with the same automask noise. The
StepLR boundary sits halfway (the 2000-step run never reaches its own).

Before every step the port takes the JAX package's weights
(`models/convert.py`); everything else is each package's own from the
start: Adam's moments and count, the batch statistics, the schedule's
step. So a difference that builds up over steps (the statistics'
momentum, Adam's moments and bias correction at a later count, the
schedule) shows in the weights, statistics and losses compared after
every step. The weights are the one part carried across, because two runs
left to go their own ways separate even in float64: Adam moves a weight
by about lr whatever the size of its gradient, so a rounding difference
in a small gradient grows into a difference of order lr within a few
steps. Float32 would not do either: batch norms over 4-120 samples a
channel make both packages' float32 gradients up to ~10% noisy in a few
tensors (the one-step tests of `test_torch_training.py`).

The JAX package's step is its float64 loss (`monodepth_parity.jax_loss64`)
under `make_train_step`'s update (`jax.value_and_grad`, the optimizer of
`make_optimizer`, `optax.apply_updates`); the port's is its own
`make_train_step` on the model in float64.

Tolerances: each step's loss within 1e-12 relative and the batch
statistics after it within 1e-12 of their largest (measured: 8e-15 and
2e-14); the weights within 1e-5 of lr (measured: 1.8e-6 of lr after the
first step, 1.1e-7 after the second, under 3e-8 later: Adam's first
updates are lr g / (|g| + 1e-8), which for a gradient near 1e-8 carries
its float64 rounding into the weight; Adam's second-moment decay at 0.99
in place of 0.999 puts a weight 1.8e-3 of lr off at the second step);
after the last step the depth of the evaluation frames within 1e-6
relative and its metrics within 1e-6 (the port's `make_eval_depth`
resizes the disparity in float32).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from monodepth_parity import jax_loss64, random_variables
from tpu3drec.models import monodepth as jm
from tpu3drec.models import training as jt
from tpu3drec.models.metrics import depth_metrics as jax_metrics
from tpu3drec_torch.models import training as tt
from tpu3drec_torch.models.convert import load_flax, state_dict_from_flax
from tpu3drec_torch.models.metrics import depth_metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, N, LR = 96, 320, 4, 3e-4
FRAMES, STEPS = 12, 10


def test_training_run_matches_jax_step_by_step():
    sys.path.insert(0, ROOT)
    from tools.train_convergence import make_dataset, relative_pose_rows

    rgbs, gt_depth, poses = make_dataset(H, W, n_frames=FRAMES)
    rows = [relative_pose_rows(poses, f, f - 1) + relative_pose_rows(poses, f, f + 1)
            for f in range(1, FRAMES - 1)]
    aa_prev, t_prev, aa_next, t_next = (np.stack(r) for r in zip(*rows))
    kw = dict(height=H, width=W, batch_size=N, use_gt_pose=True, learning_rate=LR,
              scheduler_step_epochs=1)
    jcfg, tcfg = jt.TrainConfig(**kw), tt.TrainConfig(**kw)
    d = jnp.zeros((1, H, W, 3))
    v = random_variables(jm.MonodepthModel(), d, [d, d], seed=9)
    tx = jt.make_optimizer(jcfg, STEPS // 2)
    model, state = tt.init_state(0, tcfg, STEPS // 2, device="cpu")
    load_flax(model, v["params"], v["batch_stats"]).double()
    step = tt.make_train_step(tcfg)

    with jax.enable_x64(True):
        @jax.jit
        def jax_step(params, stats, opt_state, batch, noise):
            (loss, stats), grads = jax.value_and_grad(
                lambda p: jax_loss64(p, stats, batch, jcfg, noise), has_aux=True)(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), stats, opt_state, loss

        params, stats = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), (v["params"], v["batch_stats"]))
        opt_state = tx.init(params)
        rng = np.random.default_rng(0)
        for i in range(STEPS):
            sel = rng.integers(0, FRAMES - 2, size=N)  # the tool's draw
            batch = {"target": rgbs[sel + 1], "prev": rgbs[sel], "next": rgbs[sel + 2],
                     "gt_axisangle": np.stack([aa_prev[sel], aa_next[sel]], axis=1),
                     "gt_translation": np.stack([t_prev[sel], t_next[sel]], axis=1)}
            noise = rng.standard_normal((2, N, H, W))
            # the JAX package's weights; the rest of the state stays the port's own
            missing, _ = model.load_state_dict(
                state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)), strict=False)
            assert all("running_" in k for k in missing)
            params, stats, opt_state, jloss = jax_step(
                params, stats, opt_state, {k: jnp.asarray(x, jnp.float64) for k, x in batch.items()},
                jnp.asarray(noise))
            state, loss, _ = step(state, batch, noise=noise)
            assert state.optimizer.param_groups[0]["lr"] == (LR if i < STEPS // 2 else 0.1 * LR)
            assert abs(float(loss) - float(jloss)) <= 1e-12 * abs(float(jloss)), i
            sd = model.state_dict()
            want = state_dict_from_flax(*jax.tree_util.tree_map(np.asarray, (params, stats)))
            for k, ref in want.items():
                diff = float((sd[k] - ref).abs().max())
                if "running_" in k:
                    assert diff <= 1e-12 * float(ref.abs().max()), (i, k, diff)
                else:
                    assert diff <= 1e-5 * LR, (i, k, diff)

        idx = np.arange(1, FRAMES - 1, 2)
        ref = np.asarray(jt.make_eval_depth(jm.MonodepthModel(dtype=jnp.float64), jcfg)(
            params, stats, jnp.asarray(rgbs[idx], jnp.float64)))
        m_ref = jax_metrics(jnp.asarray(ref), jnp.asarray(gt_depth[idx], jnp.float64),
                            max_depth=80.0)
    got = tt.make_eval_depth(model, tcfg)(torch.as_tensor(rgbs[idx], dtype=torch.float64))
    assert np.abs(got.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
    m_got = depth_metrics(got, torch.as_tensor(gt_depth[idx], dtype=torch.float64),
                          max_depth=80.0)
    for k in m_ref:
        assert abs(float(m_got[k]) - float(m_ref[k])) <= 1e-6, k

"""Parity of the port's training step and depth inference
(`tpu3drec_torch/models/training.py`, `models/convert.py`) with the JAX
package's (`tpu3drec/models/training.py`), and the committed trained
checkpoint read by both.

Tolerances:
- one float32 train step: loss and its parts within 1e-5 relative, batch
  statistics within 1e-6; the updated parameters per element within 1% of
  the learning rate, except elements whose gradient lies inside float32's
  rounding (Adam's first step moves each parameter by lr times the sign of
  its gradient, so a gradient of either sign there flips the update, and a
  near tie of the per-pixel minimum, which float32 may resolve either way,
  moves every gradient a little): at most 10% of a tensor and 5% of the
  model (measured: 0.33% of the model on the pose-net path, 1.5% on the
  GT-pose + stereo path with its six candidates a pixel, 6% of the worst
  tensor, a 256-element bias). A second step after the JAX package's Adam
  state was carried across: the same fractions within 10% of the learning
  rate;
- gradients of both paths in float64 on both sides: 1e-6 of each tensor's
  largest (in float32 both packages move up to ~10% from their own float64
  runs in a few tensors, through batch norms over 6-24 samples);
- the trained checkpoint's depth at 96x320: 1e-4 relative; its metrics
  1e-4 absolute.
"""

import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from monodepth_parity import jax_loss64, loaded, random_variables, t, to_jax
from tpu3drec.models import monodepth as jm
from tpu3drec.models import training as jt
from tpu3drec_torch.models import training as tt
from tpu3drec_torch.models.convert import (
    flatten, load_adam_state, load_flax, state_dict_from_flax, torch_key)
from tpu3drec_torch.models.metrics import depth_metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, N = 64, 96, 2


def _batch(rng, gt_pose=False, stereo=False):
    b = {k: rng.uniform(size=(N, H, W, 3)).astype(np.float32) for k in ("target", "prev", "next")}
    if gt_pose:
        b["gt_axisangle"] = (rng.normal(size=(N, 2, 3)) * 0.05).astype(np.float32)
        b["gt_translation"] = (rng.normal(size=(N, 2, 3)) * 0.3).astype(np.float32)
    if stereo:
        b["stereo"] = rng.uniform(size=(N, H, W, 3)).astype(np.float32)
        b["stereo_sign"] = np.array([-1.0, 1.0], np.float32)
    return b


def _variables(seed):
    d = jnp.zeros((1, H, W, 3))
    return random_variables(jm.MonodepthModel(), d, [d, d], seed=seed)


def _jax_state(v, tx):
    params = to_jax(v["params"])
    return jt.TrainState(params, to_jax(v["batch_stats"]), tx.init(params), jnp.int32(0))


def _port_state(v, tcfg, steps_per_epoch):
    model, state = tt.init_state(0, tcfg, steps_per_epoch, device="cpu")
    loaded(model, v)
    return model, state


def _noise(key, n_src):
    return np.asarray(jax.random.normal(key, (n_src, N, H, W), dtype=jnp.float32))


def _check_step(model, before, jstate, jloss, jaux, loss, aux, lr, within=1e-2):
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for k in jaux:
        assert abs(float(aux[k]) - float(jaux[k])) <= 1e-5 * abs(float(jaux[k])), k
    sd = model.state_dict()
    stats = state_dict_from_flax({}, jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    assert max(float((sd[k] - stats[k]).abs().max()) for k in stats) <= 1e-6
    params = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))
    n_off = 0
    for k in params:
        # the same tensors took a step (the pose net's stay on the GT path)
        moved = float((sd[k] - before[k]).abs().max()) > 0.5 * lr
        assert moved == (float((params[k] - before[k]).abs().max()) > 0.5 * lr), k
        off = int(((sd[k] - params[k]).abs() > within * lr).sum())
        assert off <= 0.1 * params[k].numel(), (k, off)
        n_off += off
    assert n_off <= 0.05 * sum(p.numel() for p in params.values()), n_off


@pytest.mark.parametrize("path", ["pose_net", "gt_pose_stereo"])
def test_train_step_matches_jax(path, rng):
    """One float32 step of each loss path: the pose net's poses (inverted for
    the previous frame), or ground-truth poses with the stereo frame's
    constant transform, with the flip's sign per sample."""
    gt, stereo = path == "gt_pose_stereo", path == "gt_pose_stereo"
    kw = dict(height=H, width=W, batch_size=N, use_gt_pose=gt, use_stereo=stereo)
    jcfg, tcfg = jt.TrainConfig(**kw), tt.TrainConfig(**kw)
    v = _variables(seed=5)
    batch = _batch(rng, gt, stereo)
    model, tx = jm.MonodepthModel(), jt.make_optimizer(jcfg, 10)
    key = jax.random.PRNGKey(11)
    jstate, jloss, jaux = jt.make_train_step(model, tx, jcfg)(
        _jax_state(v, tx), {k: jnp.asarray(x) for k, x in batch.items()}, key)
    pmodel, state = _port_state(v, tcfg, 10)
    before = {k: x.clone() for k, x in pmodel.state_dict().items()}
    state, loss, aux = tt.make_train_step(tcfg)(state, batch, noise=_noise(key, 3 if stereo else 2))
    assert state.step == int(jstate.step) == 1
    _check_step(pmodel, before, jstate, jloss, jaux, loss, aux, tcfg.learning_rate)


@pytest.mark.parametrize("path", ["pose_net", "gt_pose_stereo"])
def test_gradients_match_jax_in_float64(path, rng):
    gt = stereo = path == "gt_pose_stereo"
    kw = dict(height=H, width=W, batch_size=N, use_gt_pose=gt, use_stereo=stereo)
    jcfg, tcfg = jt.TrainConfig(**kw), tt.TrainConfig(**kw)
    v = _variables(seed=6)
    batch = _batch(rng, gt, stereo)
    noise = rng.normal(size=(3 if stereo else 2, N, H, W))

    def f64(tree):
        return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)

    with jax.enable_x64(True):
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p, s, b, n: jax_loss64(p, s, b, jcfg, n)[0]))(
                f64(v["params"]), f64(v["batch_stats"]), f64(batch), jnp.asarray(noise))
        jgrads = {torch_key(p): np.asarray(g) for p, g in flatten(jgrads).items()}
    model, _ = _port_state(v, tcfg, 10)
    model.double()
    b64 = {k: torch.as_tensor(x, dtype=torch.float64) for k, x in batch.items()}
    loss, _ = tt._forward_loss(model, b64, tcfg, torch.as_tensor(noise))
    loss.backward()
    assert abs(float(loss) - float(jloss)) <= 1e-12 * abs(float(jloss))
    for name, p in model.named_parameters():
        g = jgrads[name]
        if p.grad is None:  # the pose net, on the GT path
            assert gt and not np.any(g), name
            continue
        if g.ndim == 4:
            g = g.transpose(3, 2, 0, 1)
        assert np.abs(p.grad.numpy() - g).max() <= 1e-6 * np.abs(g).max(), name


def test_lr_boundary_and_adam_state_carry_over(rng):
    """Two GT-pose steps with the StepLR boundary after the first (one epoch
    of one step): the second takes lr x 0.1 in both packages, as
    optax.piecewise_constant_schedule does from the boundary's own step on.
    Before the second step the port takes the JAX package's state, Adam's
    moments and count included (`convert.load_adam_state`), so both start
    the step from the same point."""
    kw = dict(height=H, width=W, batch_size=N, use_gt_pose=True, scheduler_step_epochs=1,
              learning_rate=1e-3)
    jcfg, tcfg = jt.TrainConfig(**kw), tt.TrainConfig(**kw)
    sched = tt.lr_schedule(tcfg, 1)
    optax_sched = optax.piecewise_constant_schedule(1e-3, {1: 0.1})
    for k in range(4):
        assert sched(k) == pytest.approx(float(optax_sched(k)), rel=1e-7)
    v = _variables(seed=7)
    model, tx = jm.MonodepthModel(), jt.make_optimizer(jcfg, 1)
    jstep = jt.make_train_step(model, tx, jcfg)
    jstate = _jax_state(v, tx)
    pmodel, state = _port_state(v, tcfg, 1)
    step = tt.make_train_step(tcfg)
    for i in range(2):
        batch = _batch(rng, gt_pose=True)
        if i == 1:  # carry the JAX package's state across
            host = jax.tree_util.tree_map(np.asarray, jstate)
            load_flax(pmodel, host.params, host.batch_stats)
            adam = host.opt_state[0]
            load_adam_state(state.optimizer, pmodel, adam.mu, adam.nu, int(adam.count))
        before = {k: x.clone() for k, x in pmodel.state_dict().items()}
        key = jax.random.PRNGKey(20 + i)
        jstate, jloss, jaux = jstep(jstate, {k: jnp.asarray(x) for k, x in batch.items()}, key)
        state, loss, aux = step(state, batch, noise=_noise(key, 2))
        assert state.optimizer.param_groups[0]["lr"] == sched(i)
        # the carried moments make the second update a smooth function of
        # the gradients, so float32's rounding moves it by more than a flip
        _check_step(pmodel, before, jstate, jloss, jaux, loss, aux, sched(i),
                    within=1e-2 if i == 0 else 0.1)
    assert state.step == int(jstate.step) == 2


def test_eval_depth_matches_jax(rng):
    """`make_eval_depth`: the finest disparity resized from 32x48 to the
    config's 64x96, then disp_to_depth; eval-mode statistics."""
    cfg_kw = dict(height=H, width=W)
    jcfg, tcfg = jt.TrainConfig(**cfg_kw), tt.TrainConfig(**cfg_kw)
    v = _variables(seed=8)
    imgs = rng.uniform(size=(3, 32, 48, 3)).astype(np.float32)
    ref = np.asarray(jt.make_eval_depth(jm.MonodepthModel(), jcfg)(
        to_jax(v["params"]), to_jax(v["batch_stats"]), jnp.asarray(imgs)))
    model, _ = _port_state(v, tcfg, 10)
    got = tt.make_eval_depth(model, tcfg)(t(imgs)).numpy()
    assert got.shape == ref.shape == (3, H, W)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_init_state_is_flax_like_and_seeded():
    """Weights from the seed alone (the same on every device), lecun-normal
    kernels (variance 1 / fan_in, truncated at 2 sigma), zero biases, unit
    batch-norm scales and variances."""
    cfg = tt.TrainConfig(height=32, width=64)
    m1, s1 = tt.init_state(3, cfg, 10, device="cpu")
    m2, _ = tt.init_state(3, cfg, 10, device="cpu")
    for (k, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
    w = m1.encoder.blocks[7].convs[1].weight  # 512 x 512 x 3 x 3
    assert abs(float(w.std()) * np.sqrt(512 * 9) - 1.0) < 0.01
    assert float(w.abs().max()) <= 2 / 0.87962566103423978 / np.sqrt(512 * 9) + 1e-6
    assert float(m1.decoder.dispconvs["0"].bias.abs().max()) == 0.0
    bn = m1.encoder.norms[0]
    assert torch.equal(bn.weight, torch.ones(64)) and torch.equal(bn.running_var, torch.ones(64))
    assert s1.step == 0 and s1.schedule(0) == cfg.learning_rate


def test_entry_points_need_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.init_state(0, tt.TrainConfig(height=32, width=64))


# ------------------------------------------------ the trained checkpoint


@pytest.fixture(scope="module")
def trained():
    """The committed orbax checkpoint of `tools/train_convergence.py`
    (1000 steps at 96x320), restored by the JAX package from a copy, and
    the same weights in the port."""
    import tempfile

    from tpu3drec.utils.checkpoint import CheckpointManager

    src = os.path.join(ROOT, "runs", "convergence", "ckpt")
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(src, os.path.join(tmp, "ckpt"))
        cfg = jt.TrainConfig(height=96, width=320, use_gt_pose=True)
        model = jm.MonodepthModel()
        d = jnp.zeros((1, 96, 320, 3))
        shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), d, [d, d], train=False))
        tx = jt.make_optimizer(cfg, 1000)
        zeros = lambda tree: jax.tree_util.tree_map(  # noqa: E731
            lambda s: np.zeros(s.shape, s.dtype), tree)
        params = zeros(shapes["params"])
        template = jt.TrainState(params, zeros(shapes["batch_stats"]),
                                 zeros(jax.eval_shape(tx.init, params)), np.zeros((), np.int32))
        mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
        assert mgr.latest_step() == 1000
        state = mgr.restore(template)
        mgr.close()
    state = jax.tree_util.tree_map(np.asarray, state)
    tcfg = tt.TrainConfig(height=96, width=320, use_gt_pose=True)
    pmodel = tt.MonodepthModel()
    load_flax(pmodel, state.params, state.batch_stats)
    return cfg, tcfg, model, state, pmodel


def test_trained_checkpoint_depth_matches_jax(trained):
    """Depth of the trained model from both packages on frames of the
    scene it was trained on, and the depth metrics against their ground
    truth."""
    sys.path.insert(0, ROOT)
    from tools.train_convergence import make_dataset

    cfg, tcfg, model, state, pmodel = trained
    rgbs, gt_depth, _ = make_dataset(96, 320, n_frames=4)
    ref = np.asarray(jt.make_eval_depth(model, cfg)(
        jax.tree_util.tree_map(jnp.asarray, state.params),
        jax.tree_util.tree_map(jnp.asarray, state.batch_stats), jnp.asarray(rgbs)))
    got = tt.make_eval_depth(pmodel, tcfg)(t(rgbs)).numpy()
    assert got.shape == ref.shape == (4, 96, 320)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    from tpu3drec.models.metrics import depth_metrics as jax_metrics

    m_ref = jax_metrics(jnp.asarray(ref), jnp.asarray(gt_depth))
    m_got = depth_metrics(torch.as_tensor(got), torch.as_tensor(gt_depth))
    for k in m_ref:
        assert abs(float(m_got[k]) - float(m_ref[k])) <= 1e-4, k
    # trained, not random: the summary's final abs_rel is 0.0631 on its 16
    # evaluation frames
    assert float(m_got["abs_rel"]) < 0.2

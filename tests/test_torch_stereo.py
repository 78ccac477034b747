"""Parity of the port's stereo path (`tpu3drec_torch/models/psmnet.py`,
`models/psmnet_training.py`, `pipelines/stereo.py`, the `train-stereo`
subcommand) with the JAX package's, on the same seeded numpy inputs and
the same weights (random flax variables carried across by
`models/convert.py`). Tolerances:
- the cost volume: exactly equal (pure data movement);
- `smooth_l1_loss` and `disparity_to_depth`: 1 float32 ulp;
- eval-mode PSMNet in float32: 1e-4 px, at 32x64 and at 36x68 (H/4 = 9:
  the hourglasses' nearest resize does not double exactly there);
- a train-mode step in float64 on both sides (a few samples per channel in
  the deepest batch norms turn float32 rounding into large relative
  differences): loss 1e-9 relative, running statistics 1e-9, gradients
  1e-6 of each tensor's largest, weights after Adam 1e-5 of lr;
- `pipelines/stereo.run`: depth 1e-5 relative; PLY and `.bt` byte-equal
  when both packages are fed the same depth.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from monodepth_parity import loaded, random_variables, to_jax
from tpu3drec.models import psmnet as jp
from tpu3drec.models import psmnet_training as jpt
from tpu3drec.pipelines import rgbd as jrgbd
from tpu3drec.pipelines import stereo as jst
from tpu3drec.utils import config as jconfig
from tpu3drec_torch.models import psmnet as tp
from tpu3drec_torch.models import psmnet_training as tpt
from tpu3drec_torch.models.convert import flatten, load_adam_state, load_flax, torch_key
from tpu3drec_torch.pipelines import cli
from tpu3drec_torch.pipelines import rgbd as trgbd
from tpu3drec_torch.pipelines import stereo as tst
from tpu3drec_torch.utils import config as tconfig

MAX_DISP, FEAT = 16, 8


def _pairs(rng, n, h, w):
    return (rng.uniform(size=(n, h, w, 3)).astype(np.float32),
            rng.uniform(size=(n, h, w, 3)).astype(np.float32))


def _nchw(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype).permute(0, 3, 1, 2)


def _variables(h, w, seed=0):
    left = jnp.zeros((1, h, w, 3))
    return random_variables(jp.PSMNet(max_disp=MAX_DISP, feat_ch=FEAT), left, left,
                            train=False, seed=seed)


def _port(v, dtype=torch.float32):
    model = tp.PSMNet(max_disp=MAX_DISP, feat_ch=FEAT).to(dtype)
    return loaded(model, v)


@pytest.mark.parametrize("d4", [1, 4, 9])
def test_cost_volume_exactly_equal(d4):
    rng = np.random.default_rng(d4)
    fl = rng.normal(size=(2, 9, 17, 5)).astype(np.float32)
    fr = rng.normal(size=(2, 9, 17, 5)).astype(np.float32)
    ref = np.asarray(jp.build_cost_volume(jnp.asarray(fl), jnp.asarray(fr), d4))
    got = tp.build_cost_volume(_nchw(fl), _nchw(fr), d4)
    assert tuple(got.shape) == (2, 10, d4, 9, 17)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(), ref)


def test_loss_and_depth_within_one_ulp():
    rng = np.random.default_rng(1)
    pred = rng.uniform(0, 20, size=(3, 24, 40)).astype(np.float32)
    gt = (pred + rng.normal(scale=1.5, size=pred.shape)).astype(np.float32)
    mask = (rng.uniform(size=pred.shape) > 0.3).astype(np.float32)
    ref = np.float32(jp.smooth_l1_loss(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask)))
    got = np.float32(tp.smooth_l1_loss(torch.as_tensor(pred), torch.as_tensor(gt),
                                       torch.as_tensor(mask)))
    # one pixel: no sum to reorder, 1 ulp
    for i in range(0, pred.size, 97):
        args = [a.reshape(-1)[i:i + 1] for a in (pred, gt, mask)]
        r = np.float32(jp.smooth_l1_loss(*map(jnp.asarray, args)))
        g = np.float32(tp.smooth_l1_loss(*map(torch.as_tensor, args)))
        assert abs(g - r) <= np.spacing(r), i
    # 2,880 pixels: the two float32 sums add in different orders (measured
    # 8 ulps, 6.1e-7 relative)
    assert abs(got - ref) <= 2e-6 * abs(ref)
    disp = np.concatenate([pred.ravel(), [0.0, 0.05, 0.1, 1e-3]]).astype(np.float32)
    ref_d = np.asarray(jp.disparity_to_depth(jnp.asarray(disp), 600.391, 0.1))
    got_d = tp.disparity_to_depth(torch.as_tensor(disp), 600.391, 0.1).numpy()
    assert np.all(np.abs(got_d - ref_d) <= np.spacing(ref_d))


def test_nearest_resize_is_jax_nearest():
    """jax.image.resize's "nearest" (= F.interpolate "nearest-exact"), on
    the hourglass sizes of 36x68 and sizes that do not divide."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 3, 2, 5, 9)).astype(np.float32)
    for size in ((4, 9, 17), (3, 10, 18), (2, 7, 23)):
        ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, 3) + size, "nearest"))
        got = tp.resize_nearest(torch.as_tensor(x), size).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("hw", [(32, 64), (36, 68)])
def test_psmnet_eval_matches_jax(hw):
    h, w = hw
    rng = np.random.default_rng(h)
    left, right = _pairs(rng, 2, h, w)
    v = _variables(h, w, seed=h)
    jmodel = jp.PSMNet(max_disp=MAX_DISP, feat_ch=FEAT)
    ref = np.asarray(jp.stereo_infer(jmodel, to_jax(v), jnp.asarray(left), jnp.asarray(right)))
    got = tp.stereo_infer(_port(v), _nchw(left), _nchw(right)).numpy()
    assert got.shape == ref.shape == (2, 4 * (h // 4), 4 * (w // 4))
    assert np.abs(got - ref).max() <= 1e-4


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)


@pytest.mark.parametrize("hw", [(32, 64), (36, 68)])
def test_train_step_matches_jax_in_float64(hw):
    """One train-mode step (batch statistics left then right, smooth-L1,
    backward, Adam) in float64 in both packages, from the same weights,
    statistics and batch."""
    h, w = hw
    rng = np.random.default_rng(10 + h)
    left, right = _pairs(rng, 2, h, w)
    ho, wo = 4 * (h // 4), 4 * (w // 4)
    gt = rng.uniform(0, MAX_DISP - 1, size=(2, ho, wo))
    mask = (rng.uniform(size=(2, ho, wo)) > 0.2).astype(np.float64)
    v = _variables(h, w, seed=20 + h)
    lr = 1e-3
    with jax.enable_x64(True):
        jmodel = jp.PSMNet(max_disp=MAX_DISP, feat_ch=FEAT, dtype=jnp.float64)
        params, stats = _f64(v["params"]), _f64(v["batch_stats"])

        def loss_fn(p, l_, r_, g_, m_):
            disp, new = jmodel.apply({"params": p, "batch_stats": stats}, l_, r_, train=True,
                                     mutable=["batch_stats"])
            return jp.smooth_l1_loss(disp, g_, m_), new["batch_stats"]

        (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params, *(jnp.asarray(np.asarray(a, np.float64)) for a in (left, right, gt, mask)))
        tx = optax.adam(lr)
        updates, _ = tx.update(jgrads, tx.init(params), params)
        jparams = optax.apply_updates(params, updates)
        jloss = float(jloss)
        jstats = {torch_key(p): np.asarray(a) for p, a in flatten(jstats).items()}
        jgrads = {torch_key(p): np.asarray(a) for p, a in flatten(jgrads).items()}
        jparams = {torch_key(p): np.asarray(a) for p, a in flatten(jparams).items()}

    cfg = tpt.StereoTrainConfig(learning_rate=lr, batch_size=2, height=h, width=w,
                                max_disp=MAX_DISP, feat_ch=FEAT)
    model, state = tpt.init_stereo_state(0, cfg, device="cpu")
    model.double()
    load_flax(model, _f64(v["params"]), _f64(v["batch_stats"]))
    state, loss = tpt.make_stereo_train_step(cfg)(
        state, {"left": left, "right": right, "disp": gt, "mask": mask})
    assert state.step == 1
    assert abs(float(loss) - jloss) <= 1e-9 * abs(jloss)
    sd = model.state_dict()
    for k, ref in jstats.items():
        assert np.abs(sd[k].numpy() - ref).max() <= 1e-9, k
    g_max = max(np.abs(g).max() for g in jgrads.values())
    for name, p in model.named_parameters():
        g = jgrads[name]
        if g.ndim in (4, 5):
            g = g.transpose((3, 2, 0, 1) if g.ndim == 4 else (4, 3, 0, 1, 2))
        # the last convolution's bias shifts every disparity's logit alike,
        # which the softmax cancels: its gradient is 0 up to rounding
        # (~1e-17 in both packages), so it is held against the model's largest
        scale = np.abs(g).max() if name != "convs.1.bias" else 1e-9 * g_max
        assert np.abs(p.grad.numpy() - g).max() <= 1e-6 * scale, name
        ref = jparams[name]
        if ref.ndim in (4, 5):
            ref = ref.transpose((3, 2, 0, 1) if ref.ndim == 4 else (4, 3, 0, 1, 2))
        assert np.abs(p.detach().numpy() - ref).max() <= 1e-5 * lr, name


def test_adam_state_carries_over():
    """optax's Adam moments and count load into the port's optimizer
    (`convert.load_adam_state`): a second float32 step from the JAX
    package's state equals the JAX package's second step within 1e-2 of lr
    on almost every weight."""
    h, w = 32, 64
    rng = np.random.default_rng(4)
    v = _variables(h, w, seed=4)
    cfg_kw = dict(learning_rate=1e-3, batch_size=2, height=h, width=w, max_disp=MAX_DISP,
                  feat_ch=FEAT)
    jmodel = jp.PSMNet(max_disp=MAX_DISP, feat_ch=FEAT)
    tx = optax.adam(1e-3)
    params = to_jax(v["params"])
    from tpu3drec.models.training import TrainState as JState

    jstate = JState(params, to_jax(v["batch_stats"]), tx.init(params), jnp.int32(0))
    jstep = jpt.make_stereo_train_step(jmodel, tx)
    batches = []
    for _ in range(2):
        left, right = _pairs(rng, 2, h, w)
        gt = rng.uniform(0, MAX_DISP - 1, size=(2, h, w)).astype(np.float32)
        batches.append({"left": left, "right": right, "disp": gt,
                        "mask": np.ones((2, h, w), np.float32)})
    jstate, _ = jstep(jstate, {k: jnp.asarray(x) for k, x in batches[0].items()})
    host = jax.tree_util.tree_map(np.asarray, jstate)
    model, state = tpt.init_stereo_state(0, tpt.StereoTrainConfig(**cfg_kw), device="cpu")
    load_flax(model, host.params, host.batch_stats)
    adam = host.opt_state[0]
    load_adam_state(state.optimizer, model, adam.mu, adam.nu, int(adam.count))
    jstate, jloss = jstep(jstate, {k: jnp.asarray(x) for k, x in batches[1].items()})
    state, loss = tpt.make_stereo_train_step(tpt.StereoTrainConfig(**cfg_kw))(state, batches[1])
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    ref = {torch_key(p): np.asarray(a) for p, a in flatten(jstate.params).items()}
    off = total = 0
    for name, p in model.named_parameters():
        r = ref[name]
        if r.ndim in (4, 5):
            r = r.transpose((3, 2, 0, 1) if r.ndim == 4 else (4, 3, 0, 1, 2))
        off += int((np.abs(p.detach().numpy() - r) > 1e-2 * 1e-3).sum())
        total += r.size
    assert off <= 0.05 * total, (off, total)


@pytest.mark.parametrize("shuffle", [False, True])
def test_batches_match_jax(shuffle):
    rng = np.random.default_rng(5)
    arrays = [rng.normal(size=(11, 4, 6, 3)), rng.normal(size=(11, 4, 6, 3)),
              rng.normal(size=(11, 4, 6)), rng.normal(size=(11, 4, 6))]
    arrays = [a.astype(np.float32) for a in arrays]
    ref = list(jpt.iterate_stereo_batches(*arrays, 4, np.random.default_rng(3) if shuffle
                                          else None))
    got = list(tpt.iterate_stereo_batches(*arrays, 4, np.random.default_rng(3) if shuffle
                                          else None))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        for k in ("left", "right", "disp", "mask"):
            np.testing.assert_array_equal(g[k], np.asarray(r[k]))


def test_init_is_flax_like_and_seeded():
    cfg = tpt.StereoTrainConfig(height=32, width=64, max_disp=MAX_DISP, feat_ch=FEAT)
    m1, s1 = tpt.init_stereo_state(3, cfg, device="cpu")
    m2, _ = tpt.init_stereo_state(3, cfg, device="cpu")
    for (k, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
    w = m1.convs[0].weight  # Conv3d, fan_in 2C x 27
    fan_in = 2 * FEAT * 27
    assert float(w.abs().max()) <= 2 / 0.87962566103423978 / np.sqrt(fan_in) + 1e-6
    assert float(m1.convs[1].bias.abs().max()) == 0.0
    assert s1.step == 0 and s1.schedule(0) == cfg.learning_rate
    batch = {"left": np.zeros((1, 32, 64, 3)), "right": np.zeros((1, 32, 64, 3)),
             "disp": np.zeros((1, 32, 64)), "mask": np.zeros((1, 32, 64))}
    with pytest.raises(ValueError, match="compute_dtype"):
        tpt.make_stereo_train_step(tpt.StereoTrainConfig(compute_dtype="float16"))(s1, batch)


def _rgbd_cfgs(tmp_path, binary):
    kw = dict(fx=40.0, fy=40.0, cx=31.5, cy=15.5, width=64, height=32)
    out = {}
    for name, mod in (("jax", jconfig), ("port", tconfig)):
        out[name] = mod.RGBDPipelineConfig(
            camera=mod.CameraConfig(**kw), map=mod.MapConfig(voxel_res=0.05, ply_binary=binary),
            out_ply=str(tmp_path / f"{name}.ply"), out_bt=str(tmp_path / f"{name}.bt"))
    return out


def test_stereo_run_matches_jax(tmp_path):
    """Three pairs in batches of 2 (the last padded): depth within 1e-5
    relative; fed the same depth, both packages write the same files."""
    rng = np.random.default_rng(6)
    h, w = 32, 64
    left, right = _pairs(rng, 3, h, w)
    q = np.tile(np.array([0, 0, 0, 1], np.float32), (3, 1))
    t = rng.normal(size=(3, 3)).astype(np.float32)
    v = _variables(h, w, seed=6)
    model = _port(v)
    cfgs = _rgbd_cfgs(tmp_path, binary=False)
    kw = dict(baseline_m=0.1, max_disp=MAX_DISP, feat_ch=FEAT, batch=2)
    jres = jst.run(jst.StereoPipelineConfig(rgbd=cfgs["jax"], **kw), left, right, q, t,
                   variables=to_jax(v))
    tres = tst.run(tst.StereoPipelineConfig(rgbd=cfgs["port"], **kw), left, right, q, t,
                   model=model, device="cpu")
    assert tres.n_points == jres.n_points == 3 * h * w
    jdisp = jst.infer_disparity(jp.PSMNet(max_disp=MAX_DISP, feat_ch=FEAT), to_jax(v), left,
                                right, batch=2)
    tdisp = tst.infer_disparity(model, left, right, batch=2)
    jdepth = np.asarray(jp.disparity_to_depth(jnp.asarray(jdisp), 40.0, 0.1))
    tdepth = tp.disparity_to_depth(torch.as_tensor(tdisp), 40.0, 0.1).numpy()
    assert np.abs(tdepth - jdepth).max() <= 1e-5 * np.abs(jdepth).max()
    for binary in (False, True):
        cfgs = _rgbd_cfgs(tmp_path, binary)
        jrgbd.run_arrays(jdepth, q, t, cfgs["jax"])
        trgbd.run_arrays(jdepth, q, t, cfgs["port"], device="cpu")
        for ext in ("ply", "bt"):
            with open(tmp_path / f"jax.{ext}", "rb") as a, open(tmp_path / f"port.{ext}", "rb") as b:
                assert a.read() == b.read(), (ext, binary)


def test_train_checkpoint_resume_and_load(tmp_path):
    """`train` for 5 epochs (a checkpoint at epoch 4 and at the end), again
    with resume (the step count carries on), then `load_trained`."""
    rng = np.random.default_rng(7)
    left, right = _pairs(rng, 4, 32, 64)
    disp = rng.uniform(0, 10, size=(4, 32, 64)).astype(np.float32)
    mask = np.ones_like(disp)
    cfg = tpt.StereoTrainConfig(num_epochs=5, batch_size=2, height=32, width=64,
                                max_disp=MAX_DISP, feat_ch=FEAT)
    log_dir = str(tmp_path / "run")
    model, state, loss = tst.train(cfg, left, right, disp, mask, log_dir=log_dir, log_every=3,
                                   device="cpu")
    assert state.step == 10 and np.isfinite(loss)
    assert sorted(os.listdir(log_dir + "/ckpt")) == ["10.pt", "4.pt", "opt.json"]
    with open(os.path.join(log_dir, "train.jsonl")) as f:
        assert [int(json.loads(line)["step"]) for line in f] == [3, 6, 9]
    model2, state2, _ = tst.train(cfg, left, right, disp, mask, log_dir=log_dir, log_every=100,
                                  device="cpu")
    assert state2.step == 20
    loaded_model = tst.load_trained(log_dir, cfg, device="cpu")
    for (k, a), b in zip(model2.state_dict().items(), loaded_model.state_dict().values()):
        assert torch.equal(a, b), k


def _jax_cli_sim(n, height, width, baseline, seed):
    """The JAX CLI's ``--sim`` pairs (`tpu3drec/pipelines/cli.py`), built
    with the JAX package's renderer."""
    from scipy.spatial.transform import Rotation as ScipyR

    from tpu3drec.data.capture_sim import PlanarScene, render_stereo_pairs

    rng = np.random.default_rng(seed)
    scene = PlanarScene.urban(rng, n_boxes=12, extent=35.0)
    cam = jconfig.CameraConfig(fx=width * 0.9, fy=width * 0.9, cx=(width - 1) / 2,
                               cy=(height - 1) / 2, width=width, height=height)
    poses = []
    for f in range(n):
        R = ScipyR.from_rotvec([0, 0.02 * f, 0]).as_matrix().astype(np.float32)
        C = np.array([0.4 * f, -1.2, 0.8 * f], np.float32)
        poses.append((R, (-R @ C).astype(np.float32)))
    return render_stereo_pairs(scene, poses, cam, baseline=baseline)


def test_cli_train_stereo_sim(tmp_path, capsys):
    ref = _jax_cli_sim(4, 32, 64, 0.1, 0)
    got = cli._sim_stereo_pairs(4, 32, 64, 0.1, 0)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    log_dir = str(tmp_path / "stereo")
    cli.main(["--device", "cpu", "train-stereo", "--sim", "4", "--height", "32", "--width",
              "64", "--max-disp", "16", "--batch-size", "2", "--epochs", "1",
              "--log-dir", log_dir])
    assert "trained 2 steps" in capsys.readouterr().out
    assert os.path.exists(os.path.join(log_dir, "ckpt", "2.pt"))


def test_cli_train_stereo_data_dir(tmp_path, capsys):
    from PIL import Image

    rng = np.random.default_rng(8)
    for sub in ("left", "right", "disp"):
        os.makedirs(tmp_path / "data" / sub)
    for i in range(2):
        for sub in ("left", "right"):
            img = rng.integers(0, 256, size=(32, 64, 3), dtype=np.uint8)
            Image.fromarray(img).save(tmp_path / "data" / sub / f"{i}.png")
        np.save(tmp_path / "data" / "disp" / f"{i}.npy",
                rng.uniform(0, 10, size=(32, 64)).astype(np.float32))
    cli.main(["--device", "cpu", "train-stereo", "--data", str(tmp_path / "data"),
              "--max-disp", "16", "--batch-size", "2", "--epochs", "1",
              "--log-dir", str(tmp_path / "run")])
    assert "trained 1 steps" in capsys.readouterr().out
    assert glob.glob(str(tmp_path / "run" / "ckpt" / "*.pt"))


def test_entry_points_need_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpt.init_stereo_state(0, tpt.StereoTrainConfig(height=32, width=64))

"""The port's monocular data and pipeline layer against the JAX package's:
datasets, the triplet loader (bit-equal batches for one seed),
`read_ccam`, `infer_depth_maps`, the checkpoint manager, the epoch loop
with resume, and the `train-mono` subcommand on an InteriorNet-layout
tree. Mirrors `tests/test_pipeline_glue.py` and `tests/test_stereo_data.py`.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from monodepth_parity import loaded, random_variables, to_jax
from tpu3drec.data import datasets as jds
from tpu3drec.data import loader as jld
from tpu3drec.models import monodepth as jm
from tpu3drec.models import training as jt
from tpu3drec.pipelines import monocular as jmono
from tpu3drec.utils import poseio as jpio
from tpu3drec_torch.data import datasets as tds
from tpu3drec_torch.data import loader as tld
from tpu3drec_torch.models import training as tt
from tpu3drec_torch.pipelines import monocular as tmono
from tpu3drec_torch.utils import poseio as tpio
from tpu3drec_torch.utils.checkpoint import CheckpointManager, restore_partial
from tpu3drec_torch.utils.metrics_logger import MetricsLogger, ThroughputMeter

H, W = 32, 64


def _interiornet(tmp_path, rng, n=8, euler_rot=True):
    """An InteriorNet-layout scene: jpg frames, 16-bit depth PNGs and a
    cam0.ccam with rotating, moving poses."""
    scene = tmp_path / "scene1"
    os.makedirs(scene / "jpg")
    os.makedirs(scene / "depth")
    for i in range(n):
        img = (rng.uniform(size=(48, 64, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(scene / "jpg" / f"{i}.jpg")
        d = rng.uniform(500, 5000, size=(48, 64)).astype(np.int32)
        Image.fromarray(d, mode="I").save(scene / "depth" / f"{i}.png")
    with open(scene / "cam0.ccam", "w") as f:
        f.write("# header\n")
        for i in range(n):
            q = rng.normal(size=4) if euler_rot else np.array([1.0, 0, 0, 0])
            q = q / np.linalg.norm(q)
            t = [0.1 * i, 0.02 * i, -0.05 * i]
            f.write(" ".join(map(str, [0] * 6 + list(q) + t + [0, 0])) + "\n")
    return str(tmp_path), "scene1"


def test_read_ccam_matches_jax(tmp_path, rng):
    root, scene = _interiornet(tmp_path, rng)
    path = os.path.join(root, scene, "cam0.ccam")
    ref, got = jpio.read_ccam(path), tpio.read_ccam(path)
    assert len(got) == len(ref) == 8
    for (qa, ta), (qb, tb) in zip(got, ref):
        np.testing.assert_array_equal(qa, qb)
        np.testing.assert_array_equal(ta, tb)


@pytest.mark.parametrize("euler_compat", [False, True])
def test_interiornet_reader_matches_jax(tmp_path, rng, euler_compat):
    root, scene = _interiornet(tmp_path, rng)
    a = tds.InteriorNetDataset(root, euler_compat=euler_compat)
    b = jds.InteriorNetDataset(root, euler_compat=euler_compat)
    np.testing.assert_array_equal(a.load_color(scene, 3, size=(W, H)),
                                  b.load_color(scene, 3, size=(W, H)))
    np.testing.assert_array_equal(a.load_gt_depth(scene, 1), b.load_gt_depth(scene, 1))
    for got, ref in zip(a.gt_relative_pose(scene, 2), b.gt_relative_pose(scene, 2)):
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


def test_split_files_and_airsim_layout_match_jax(tmp_path, rng):
    tr, va = tds.write_split_files(str(tmp_path / "s"), "sceneA", range(100))
    assert [(s.folder, s.frame_index) for s in tds.read_split_file(tr)] == \
        [(s.folder, s.frame_index) for s in jds.read_split_file(tr)]
    assert len(tds.read_split_file(tr)) + len(tds.read_split_file(va)) == 100
    os.makedirs(tmp_path / "front")
    os.makedirs(tmp_path / "depth")
    for i in (0, 1, 5):
        img = (rng.uniform(size=(24, 32, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(tmp_path / "front" / f"{i}.jpg")
        Image.fromarray(img).save(tmp_path / "depth" / f"{i}.jpg")
    a, b = tds.AirSimCaptureDataset(str(tmp_path)), jds.AirSimCaptureDataset(str(tmp_path))
    assert a.frame_ids() == b.frame_ids() == [0, 1, 5]
    np.testing.assert_array_equal(a.load_depth(5), b.load_depth(5))


@pytest.mark.parametrize("prefetch", [0, 2])
def test_loader_batches_bit_equal_to_jax(tmp_path, rng, prefetch):
    """Two epochs of shuffled, jittered, flipped triplets with GT poses and
    depth from one seed: every batch equal bit for bit."""
    root, scene = _interiornet(tmp_path, rng)
    specs = [tds.SequenceSpec(scene, i) for i in range(1, 7)]
    kw = dict(batch_size=2, height=H, width=W, augment=True, with_gt_pose=True,
              with_gt_depth=True, seed=3, prefetch=prefetch)
    a = tld.TripletLoader(tds.InteriorNetDataset(root), specs, **kw)
    b = jld.TripletLoader(jds.InteriorNetDataset(root),
                          [jds.SequenceSpec(s.folder, s.frame_index) for s in specs], **kw)
    assert len(a) == len(b) == 3
    for _ in range(2):
        got, ref = list(a), list(b)
        assert len(got) == len(ref) == 3
        for x, y in zip(got, ref):
            assert sorted(x) == sorted(y)
            for k in y:
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


def test_loader_stereo_frame():
    class StereoDS:
        def load_color(self, folder, idx, size=None):
            return (np.random.default_rng(idx).uniform(size=(16, 24, 3)) * 255).astype(np.uint8)

        def load_stereo_color(self, folder, idx, size=None):
            r = np.random.default_rng(1000 + idx)
            return (r.uniform(size=(16, 24, 3)) * 255).astype(np.uint8)

    specs = [tds.SequenceSpec("x", i) for i in (1, 2, 3, 4)]
    b = next(iter(tld.TripletLoader(StereoDS(), specs, batch_size=2, height=16, width=24,
                                    augment=False, with_stereo=True, prefetch=0)))
    assert b["stereo"].shape == (2, 16, 24, 3)
    np.testing.assert_array_equal(b["stereo_sign"], [-1.0, -1.0])


def test_loader_raises_what_its_thread_raised():
    """A failure the loader does not skip (not a bad file) ends the epoch
    with the error in the consuming thread, not with a short epoch."""
    class Broken:
        def load_color(self, folder, idx, size=None):
            raise RuntimeError("decoder crashed")

    loader = tld.TripletLoader(Broken(), [tds.SequenceSpec("x", 1)], prefetch=2)
    with pytest.raises(RuntimeError, match="decoder crashed"):
        list(loader)


def test_infer_depth_maps_matches_jax_and_padding(rng):
    """5 uint8 frames in chunks of 2 (the last padded with a zero frame)
    against one chunk of 5, and against the JAX package's."""
    cfg_j, cfg_t = jt.TrainConfig(height=H, width=W), tt.TrainConfig(height=H, width=W)
    d = jnp.zeros((1, H, W, 3))
    v = random_variables(jm.MonodepthModel(), d, [d, d], seed=9)
    frames = (rng.uniform(size=(5, H, W, 3)) * 255).astype(np.uint8)
    model, _ = tt.init_state(0, cfg_t, 10, device="cpu")
    loaded(model, v)
    padded = tmono.infer_depth_maps(model, frames, cfg_t, batch=2)
    whole = tmono.infer_depth_maps(model, frames, cfg_t, batch=5)
    assert padded.shape == whole.shape == (5, H, W) and padded.dtype == np.float32
    np.testing.assert_allclose(padded, whole, rtol=1e-6, atol=0)

    class State:
        params, batch_stats = to_jax(v["params"]), to_jax(v["batch_stats"])

    ref = jmono.infer_depth_maps(jm.MonodepthModel(), State, frames, cfg_j, batch=2)
    np.testing.assert_allclose(padded, ref, rtol=1e-5, atol=0)


# ---------------------------------------------------------- checkpoints


def test_checkpoint_roundtrip_keep_and_partial(tmp_path):
    cfg = tt.TrainConfig(height=H, width=W)
    model, state = tt.init_state(0, cfg, 10, device="cpu")
    state.step = 3
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2, save_frequency=5)
    mgr.save_config(cfg)
    assert json.load(open(tmp_path / "ckpt" / "opt.json"))["height"] == H
    assert not mgr.maybe_save(0, state) and mgr.maybe_save(4, state)  # epoch 5
    for step in (3, 7, 9):
        state.step = step
        mgr.save(step, state)
    assert mgr.steps() == [7, 9] and mgr.latest_step() == 9
    assert not [f for f in os.listdir(tmp_path / "ckpt") if f.endswith(".tmp")]
    _, template = tt.init_state(1, cfg, 10, device="cpu")  # other weights
    restored = mgr.restore(template, step=7)
    assert restored.step == 7
    for (k, a), b in zip(model.state_dict().items(), restored.model.state_dict().values()):
        assert torch.equal(a, b), k
    empty = CheckpointManager(str(tmp_path / "none"))
    assert empty.latest_step() is None and empty.restore(template) is template

    sd = {"a": torch.zeros(3), "b": torch.zeros(2)}
    merged = restore_partial(sd, {"a": torch.ones(3), "b": torch.ones(5), "c": torch.ones(1)})
    assert torch.equal(merged["a"], torch.ones(3)) and torch.equal(merged["b"], torch.zeros(2))
    assert "c" not in merged


def test_metrics_logger_and_meter(tmp_path):
    log = MetricsLogger(str(tmp_path), "train")
    log.log(5, {"loss": 0.25})
    log.close()
    rec = json.loads(open(tmp_path / "train.jsonl").read())
    assert rec["step"] == 5 and rec["loss"] == 0.25 and rec["mode"] == "train"
    r = ThroughputMeter(100, 2).report(10)
    assert r["examples_per_s"] > 0 and r["eta_s"] >= 0


# --------------------------------------------------------- the pipeline


class _FakeDS:
    def load_color(self, folder, idx, size=None):
        return (np.random.default_rng(idx).uniform(size=(H, W, 3)) * 255).astype(np.uint8)


def test_train_then_resume(tmp_path):
    """Two steps, a checkpoint, then a second run that resumes from it and
    takes two more: the reference's load_weights_folder flow."""
    specs = [tds.SequenceSpec("x", i) for i in range(1, 5)]

    def run(max_steps):
        loader = tld.TripletLoader(_FakeDS(), specs, batch_size=2, height=H, width=W,
                                   augment=False, prefetch=0)
        cfg = tmono.MonocularRunConfig(
            train=tt.TrainConfig(height=H, width=W, num_epochs=1, batch_size=2),
            log_dir=str(tmp_path / "run"), log_every=1, val_every=1, max_steps=max_steps)
        return tmono.train(cfg, loader, val_loader=loader, device="cpu")

    model, state = run(2)
    assert state.step == 2
    first = {k: v.clone() for k, v in model.state_dict().items()}
    mgr = CheckpointManager(str(tmp_path / "run" / "ckpt"))
    assert mgr.steps() == [2]
    model, state = run(4)
    assert state.step == 4 and mgr.steps() == [2, 4]
    _, at2 = tt.init_state(5, tt.TrainConfig(height=H, width=W), 2, device="cpu")
    for k, v in mgr.restore(at2, step=2).model.state_dict().items():
        assert torch.equal(v, first[k]), k
    lines = open(tmp_path / "run" / "train.jsonl").read().strip().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [1, 2, 3, 4]
    val = [json.loads(x) for x in open(tmp_path / "run" / "val.jsonl").read().splitlines()]
    assert [x["step"] for x in val] == [1, 2, 3, 4]

    depths = tmono.infer_depth_maps(model, np.zeros((3, H, W, 3), np.float32),
                                    tt.TrainConfig(height=H, width=W), batch=2)
    assert depths.shape == (3, H, W) and (depths > 0).all()


def test_train_mono_cli_from_disk(tmp_path, rng):
    """`train-mono` on an InteriorNet-layout tree at 32x64 with GT poses
    and a validation split: the reference's Trainer.train() entry."""
    from tpu3drec_torch.pipelines.cli import main

    root, scene = _interiornet(tmp_path, rng, n=7)
    tr, va = tds.write_split_files(str(tmp_path / "splits"), scene, range(1, 6), train_frac=0.8)
    main(["--device", "cpu", "train-mono", "--data-path", root, "--split-train", tr,
          "--split-val", va, "--height", str(H), "--width", str(W), "--batch-size", "2",
          "--epochs", "1", "--use-gt-pose", "--log-dir", str(tmp_path / "run")])
    assert os.path.exists(tmp_path / "run" / "train.jsonl")
    assert CheckpointManager(str(tmp_path / "run" / "ckpt")).steps() == [2]
    opt = json.load(open(tmp_path / "run" / "ckpt" / "opt.json"))
    assert opt["use_gt_pose"] is True and opt["height"] == H

"""The port's published PSMNet (`tpu3drec_torch/models/psmnet.py::
StackHourglassPSMNet`) and its training step against the benchmark's plain
reference (`portbench/references/psmnet.py`) on the CPU, on the reference's
seeded weights, at the published widths with the SPP pools scaled to a
64x128 input. No JAX: the JAX package has no such net.

Tolerances, in float64 on both sides:
- the cost volume: exactly equal (data movement only);
- the disparities (eval and the three train-mode heads), the loss and the
  running statistics: 1e-12 relative. The two sides run the same
  arithmetic but for a few constants and orders (a batch norm keeps
  ``0.9 * r + (1 - 0.9) * b`` in the port, ``0.9 r + 0.1 b`` in the
  reference), each moving a result by ~1e-16 relative; batch norms over 2
  samples amplify that a little (measured: 0 to 4e-15);
- every gradient: 1e-10 of the leaf's norm (measured at most 1e-14; the
  gradient passes back through every batch norm);
- the weights after one Adam step: 1e-10 absolute against a step of
  ~1e-3. Where a gradient element is near Adam's eps (1e-8), the update
  moves by lr eps / (|g| + eps)^2 per unit of gradient, ~1e4, so the
  gradients' 1e-17 gaps show as up to 1.8e-12 (measured).

Also the parameter count at the published widths, the published
initialisation, and the normal entry points with the net:
`train-stereo --arch stackhourglass` writes a checkpoint that
`pipelines/stereo.load_trained` restores, and `pipelines/stereo.run` with
the restored net writes the `.bt`.
"""

import math
import os

import numpy as np
import pytest
import torch

from portbench.references import psmnet as ref
from tpu3drec_torch.models import psmnet as tp
from tpu3drec_torch.models import psmnet_training as tpt
from tpu3drec_torch.pipelines import cli
from tpu3drec_torch.pipelines import stereo as tst
from tpu3drec_torch.utils import config as tconfig

torch.set_num_threads(2)

N, H, W, MAX_DISP, POOLS = 2, 64, 128, 32, (16, 8, 4, 2)
SEED = 2 ** 31 + 77


def _cfg(**kw):
    base = dict(arch="stackhourglass", max_disp=MAX_DISP, spp_pools=POOLS, batch_size=N,
                height=H, width=W)
    base.update(kw)
    return tpt.StereoTrainConfig(**base)


def _weights():
    with torch.device("meta"):
        shapes = ref.PSMNet(MAX_DISP, POOLS)
    return ref.make_weights(shapes, SEED, "cpu")


def _batch(seed=3):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.rand(s, generator=g, dtype=torch.float64)  # noqa: E731
    disp = r(N, H, W) * 1.3 * MAX_DISP  # about a quarter at or over max_disp: masked
    mask = (r(N, H, W) > 0.1).double()
    return {"left": r(N, H, W, 3), "right": r(N, H, W, 3), "disp": disp, "mask": mask}


def _pair():
    weights = _weights()
    port = tp.StackHourglassPSMNet(MAX_DISP, POOLS)
    port.load_state_dict(weights)
    plain = ref.PSMNet(MAX_DISP, POOLS)
    plain.load_state_dict(weights)
    return port.double(), plain.double()


def _close(a, b, rtol):
    scale = max(float(b.abs().max()), 1e-300)
    assert float((a - b).abs().max()) <= rtol * scale, (float((a - b).abs().max()), scale)


def test_parameter_count_and_names_at_published_widths():
    port, plain = tp.StackHourglassPSMNet(), ref.PSMNet()
    assert sum(p.numel() for p in port.parameters()) == 5_224_768
    assert sum(p.numel() for p in plain.parameters()) == 5_224_768
    assert {k: v.shape for k, v in port.state_dict().items()} == {
        k: v.shape for k, v in plain.state_dict().items()}


@pytest.mark.parametrize("d4", [1, 5, 13])
def test_cost_volume_equals_the_reference_exactly(d4):
    g = torch.Generator().manual_seed(d4)
    fl, fr = torch.randn(2, 6, 5, 17, generator=g), torch.randn(2, 6, 5, 17, generator=g)
    got = tp.build_stack_cost_volume(fl, fr, d4)
    want = ref.cost_volume(fl, fr, d4)
    assert got.shape == (2, 12, d4, 5, 17) and torch.equal(got, want)
    for d in range(d4):  # both halves zero left of d
        assert not got[..., d, :, :d].any()


def test_eval_forward_matches_the_reference():
    port, plain = _pair()
    g = torch.Generator().manual_seed(9)
    for (k, a), b in zip(port.state_dict().items(), plain.state_dict().values()):
        if "running_" in k:  # statistics away from 0 and 1
            v = torch.rand(a.shape, generator=g, dtype=torch.float64) + 0.5
            a.copy_(v)
            b.copy_(v)
    b = _batch()
    left, right = b["left"].permute(0, 3, 1, 2), b["right"].permute(0, 3, 1, 2)
    with torch.no_grad():
        got = port(left, right, train=False)
        want = plain(left, right, False)
    assert got.shape == (N, H, W)
    _close(got, want, 1e-12)


def test_train_step_matches_the_reference():
    """One step through `make_stereo_train_step`: the three heads, the
    loss, every gradient, the running statistics, Adam's update; the
    reference's forward checkpointed by stage, as the benchmark runs it."""
    port, plain = _pair()
    state = tpt.TrainState(port, tpt.make_optimizer(_cfg(), port.parameters()),
                           lambda step: 1e-3)
    seen = {}
    hook = port.register_forward_hook(lambda m, a, out: seen.setdefault("preds", out) and None)
    batch = _batch()
    state, loss = tpt.make_stereo_train_step(_cfg())(state, batch)
    hook.remove()
    want_loss, want_preds = ref.loss(plain, batch, checkpoint=True)
    with ref.frozen_statistics():
        want_loss.backward()
    assert abs(float(loss) - float(want_loss.detach())) <= 1e-12 * abs(float(want_loss.detach()))
    assert len(seen["preds"]) == 3
    for a, b in zip(seen["preds"], want_preds):
        _close(a.detach(), b.detach(), 1e-12)
    got_sd, want_sd = port.state_dict(), plain.state_dict()
    for k in want_sd:
        if "running_" in k:
            _close(got_sd[k], want_sd[k], 1e-12)
    params = dict(plain.named_parameters())
    for k, p in port.named_parameters():
        gap = float((p.grad - params[k].grad).norm())
        assert gap <= 1e-10 * max(float(params[k].grad.norm()), 1e-30), k
    before = {k: p.detach().clone() for k, p in params.items()}
    ref.adam_step(params, {k: p.grad for k, p in params.items()}, {}, 1, 1e-3)
    for k, p in port.named_parameters():
        assert float((p - params[k]).abs().max()) <= 1e-10, k
        assert float((params[k] - before[k]).abs().max()) > 1e-4, k  # the step moved it


def test_loss_masks_disparities_at_or_over_max_disp():
    """A batch whose every valid pixel lies at or over max_disp leaves a zero
    loss; one in range gives the heads' weighted smooth-L1."""
    port, _ = _pair()
    port = port.float()
    opt = tpt.make_optimizer(_cfg(), port.parameters())
    state = tpt.TrainState(port, opt, lambda step: 0.0)
    batch = {k: v.float() for k, v in _batch().items()}
    batch["disp"] = torch.full_like(batch["disp"], float(MAX_DISP))
    state, loss = tpt.make_stereo_train_step(_cfg())(state, batch)
    assert float(loss) == 0.0


def test_init_follows_the_published_rule():
    gen = torch.Generator().manual_seed(5)
    model = tp.StackHourglassPSMNet()
    tp.init_psmnet_params(model, gen)
    again = tp.StackHourglassPSMNet()
    tp.init_psmnet_params(again, torch.Generator().manual_seed(5))
    for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    w = model.feature_extraction.layer2[5].conv1.conv.weight  # 64 x 64 x 3 x 3
    assert abs(float(w.std()) / math.sqrt(2.0 / (9 * 64)) - 1) < 0.02
    assert abs(float(w.mean())) < 0.01 * float(w.std())
    t = model.dres2.conv5.conv.weight  # ConvTranspose3d: in 64, out 64, 27 taps
    bound = 1.0 / math.sqrt(64 * 27)
    assert float(t.abs().max()) <= bound and float(t.abs().max()) > 0.95 * bound
    bn = model.dres0[0].bn
    assert torch.equal(bn.weight, torch.ones(32)) and not bn.bias.any()
    assert bn.momentum == 0.9 and torch.equal(bn.running_var, torch.ones(32))
    model2, state = tpt.init_stereo_state(5, _cfg(), device="cpu")
    assert isinstance(model2, tp.StackHourglassPSMNet) and model2.max_disp == MAX_DISP
    with pytest.raises(ValueError, match="arch"):
        tpt.init_stereo_state(5, _cfg(arch="resnet"), device="cpu")


def test_cli_trains_restores_and_maps_with_the_published_net(tmp_path, capsys):
    """`train-stereo --arch stackhourglass` on a directory of two 256x256
    pairs (the published pools need 256 px), one step; `load_trained`
    restores the checkpoint's weights; `run` with that net writes the
    `.bt`."""
    from PIL import Image

    rng = np.random.default_rng(8)
    data = tmp_path / "data"
    for sub in ("left", "right", "disp"):
        os.makedirs(data / sub)
    for i in range(2):
        for sub in ("left", "right"):
            img = rng.integers(0, 256, size=(256, 256, 3), dtype=np.uint8)
            Image.fromarray(img).save(data / sub / f"{i}.png")
        np.save(data / "disp" / f"{i}.npy",
                rng.uniform(0, 20, size=(256, 256)).astype(np.float32))
    log_dir = str(tmp_path / "run")
    cli.main(["--device", "cpu", "train-stereo", "--arch", "stackhourglass", "--data",
              str(data), "--max-disp", "16", "--batch-size", "2", "--epochs", "1",
              "--log-dir", log_dir])
    assert "trained 1 steps" in capsys.readouterr().out
    assert sorted(os.listdir(os.path.join(log_dir, "ckpt"))) == ["1.pt", "opt.json"]
    cfg = tpt.StereoTrainConfig(arch="stackhourglass", max_disp=16, batch_size=2,
                                height=256, width=256)
    model = tst.load_trained(log_dir, cfg, device="cpu")
    fresh, _ = tpt.init_stereo_state(0, cfg, device="cpu")
    assert isinstance(model, tp.StackHourglassPSMNet)
    saved = torch.load(os.path.join(log_dir, "ckpt", "1.pt"), weights_only=True)
    assert saved["step"] == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    w = "feature_extraction.lastconv_out.weight"
    assert not torch.equal(model.state_dict()[w], fresh.state_dict()[w])  # trained, restored
    lefts = rng.uniform(size=(2, 256, 256, 3)).astype(np.float32)
    rights = rng.uniform(size=(2, 256, 256, 3)).astype(np.float32)
    rgbd_cfg = tconfig.RGBDPipelineConfig(
        camera=tconfig.CameraConfig(fx=200.0, fy=200.0, cx=127.5, cy=127.5, width=256,
                                    height=256),
        map=tconfig.MapConfig(voxel_res=0.1), out_ply="", out_bt=str(tmp_path / "map.bt"))
    res = tst.run(tst.StereoPipelineConfig(rgbd=rgbd_cfg, max_disp=16, batch=2,
                                           arch="stackhourglass"),
                  lefts, rights, np.tile([0, 0, 0, 1.0], (2, 1)).astype(np.float32),
                  np.zeros((2, 3), np.float32), model=model, device="cpu")
    assert res.n_points > 0
    with open(tmp_path / "map.bt", "rb") as f:
        assert f.read().startswith(b"# Octomap OcTree binary file")

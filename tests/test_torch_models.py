"""Parity of the port's depth nets and losses (`tpu3drec_torch/models/`)
with the JAX package's (`tpu3drec/models/`), mirroring `tests/test_models.py`.

The same numpy inputs and the same weights (random flax variables carried
across by `models/convert.py`) go through both packages. Tolerances:
- forward in eval mode: 1e-5 of the reference's largest magnitude (1e-5
  absolute for disparities in (0, 1));
- forward in train mode, whose batch norms normalise by a handful of
  samples at the deepest scales, in float64 on both sides: 1e-9 of the
  largest magnitude (in float32 both packages move ~1e-4 from their own
  float64 runs there, which would mask a real difference);
- batch-norm running statistics after a train-mode call: 1e-6 in float32
  (ResNet18), 1e-12 in float64;
- losses: 1e-5 relative; their gradients: 1e-4 of the largest.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monodepth_parity import loaded, nchw, random_variables, t, to_jax
from tpu3drec.models import depth_decoder as jdd
from tpu3drec.models import metrics as jmet
from tpu3drec.models import monodepth as jm
from tpu3drec.models import pose_net as jpn
from tpu3drec.models import resnet as jr
from tpu3drec_torch.models import depth_decoder as tdd
from tpu3drec_torch.models import metrics as tmet
from tpu3drec_torch.models import monodepth as tm
from tpu3drec_torch.models import pose_net as tpn
from tpu3drec_torch.models import resnet as tr
from tpu3drec_torch.models.convert import flatten, torch_key

H, W = 64, 96  # divisible by 32 for the 5-level pyramid


def _img(rng, n=2, h=H, w=W, c=3):
    return rng.uniform(size=(n, h, w, c)).astype(np.float32)


def _stats_sd(updates):
    """flax batch statistics -> {port key: float64 tensor}, unrounded."""
    return {torch_key(p): torch.as_tensor(np.array(v, np.float64))
            for p, v in flatten(updates["batch_stats"]).items()}


# ------------------------------------------------------------------ nets


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)


def _apply(module, variables, *args, **kwargs):
    """``module.apply`` compiled as one program (much faster than op by op)."""
    return jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(variables, *args)


def _assert_close(got, ref, rel):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err, scale = np.abs(got - ref).max(), max(np.abs(ref).max(), 1.0)
    assert err <= rel * scale, (got.shape, err, rel * scale)


@pytest.mark.parametrize("depth", [18, 50])
def test_encoder_matches_jax(depth):
    """Eval mode in float32. Train mode in float64 on both sides: with a few
    samples per channel at the deepest scales, batch normalisation turns
    float32 rounding into differences of 1e-4 (measured: both packages move
    that far from their own float64 runs), which would mask a real one."""
    rng = np.random.default_rng(depth)
    x = _img(rng)
    v = random_variables(jr.ResNetEncoder(depth=depth), jnp.asarray(x), seed=depth)
    port = loaded(tr.ResNetEncoder(depth=depth), v)
    ref = _apply(jr.ResNetEncoder(depth=depth), to_jax(v), jnp.asarray(x))
    with torch.no_grad():
        got = port(nchw(x))
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        _assert_close(g.permute(0, 2, 3, 1), r, 1e-5)

    with jax.enable_x64(True):
        ref, upd = _apply(jr.ResNetEncoder(depth=depth, dtype=jnp.float64), _f64(v),
                          jnp.asarray(x, jnp.float64), train=True, mutable=["batch_stats"])
        ref, ref_sd = [np.asarray(r) for r in ref], _stats_sd(upd)
    port64 = copy.deepcopy(port).double()
    with torch.no_grad():
        got = port64(nchw(x).double(), train=True)
    for g, r in zip(got, ref):
        _assert_close(g.permute(0, 2, 3, 1), r, 1e-9)
    sd = port64.state_dict()
    for k in ref_sd:  # the running statistics after one train-mode call
        assert float((sd[k] - ref_sd[k]).abs().max()) <= 1e-12, k


def test_encoder_batch_stats_float32_match_jax():
    """ResNet18's running statistics after a float32 train-mode call: flax's
    momentum 0.99 and biased variance, within 1e-6."""
    rng = np.random.default_rng(18)
    x = _img(rng)
    enc = jr.ResNetEncoder(depth=18)
    v = random_variables(enc, jnp.asarray(x), seed=18)
    _, upd = _apply(enc, to_jax(v), jnp.asarray(x), train=True, mutable=["batch_stats"])
    port = loaded(tr.ResNetEncoder(depth=18), v)
    with torch.no_grad():
        port(nchw(x), train=True)
    ref_sd, sd = _stats_sd(upd), port.state_dict()
    assert max(float((sd[k].double() - ref_sd[k]).abs().max()) for k in ref_sd) <= 1e-6


def test_decoder_matches_jax():
    rng = np.random.default_rng(1)
    chans = [64, 64, 128, 256, 512]
    feats = [rng.normal(size=(2, H >> (i + 1), W >> (i + 1), c)).astype(np.float32)
             for i, c in enumerate(chans)]
    dec = jdd.DepthDecoder(num_ch_enc=chans)
    v = random_variables(dec, [jnp.asarray(f) for f in feats], seed=2)
    ref = _apply(dec, to_jax(v), [jnp.asarray(f) for f in feats])
    port = loaded(tdd.DepthDecoder(chans), v)
    with torch.no_grad():
        got = port([nchw(f) for f in feats])
    assert set(got) == set(ref) == {0, 1, 2, 3}
    for s in ref:
        g = got[s].permute(0, 2, 3, 1).numpy()
        assert g.shape == ref[s].shape
        np.testing.assert_allclose(g, np.asarray(ref[s]), atol=1e-5, rtol=0)


def test_pose_net_matches_jax():
    """Eval mode in float32, train mode in float64 (see the encoder's test)."""
    rng = np.random.default_rng(3)
    a, b = _img(rng), _img(rng)
    v = random_variables(jpn.PoseNet(), jnp.asarray(a), jnp.asarray(b), seed=3)
    ref = _apply(jpn.PoseNet(), to_jax(v), jnp.asarray(a), jnp.asarray(b))
    port = loaded(tpn.PoseNet(), v)
    with torch.no_grad():
        got = port(nchw(a), nchw(b))
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape == (2, 3)
        _assert_close(g, r, 1e-5)
    with jax.enable_x64(True):
        ref, upd = _apply(jpn.PoseNet(dtype=jnp.float64), _f64(v), jnp.asarray(a, jnp.float64),
                          jnp.asarray(b, jnp.float64), train=True, mutable=["batch_stats"])
        ref, ref_sd = [np.asarray(r) for r in ref], _stats_sd(upd)
    port64 = copy.deepcopy(port).double()
    with torch.no_grad():
        got = port64(nchw(a).double(), nchw(b).double(), train=True)
    for g, r in zip(got, ref):
        _assert_close(g, r, 1e-9)
    sd = port64.state_dict()
    assert max(float((sd[k] - ref_sd[k]).abs().max()) for k in ref_sd) <= 1e-12


@pytest.mark.parametrize("h,w", [(H, W), (32, 64)])
def test_model_depth_matches_jax(h, w):
    """MonodepthModel.depth, eval in float32 (and, at 64x96, train in
    float64); at 32x64 the deepest feature is 1x2, where the decoder's
    reflect padding repeats the one row as jnp.pad does."""
    rng = np.random.default_rng(4)
    x = _img(rng, 1, h, w)
    d = jnp.asarray(x)
    v = random_variables(jm.MonodepthModel(), d, [d, d], seed=4)
    ref = _apply(jm.MonodepthModel(), to_jax(v), d, method=jm.MonodepthModel.depth)
    port = loaded(tm.MonodepthModel(), v)
    with torch.no_grad():
        got = port.depth(t(x))
    for s in ref:
        assert tuple(got[s].shape) == ref[s].shape == (1, h >> s, w >> s, 1)
        _assert_close(got[s], ref[s], 1e-5)
    if h == 32:
        return
    with jax.enable_x64(True):
        ref, _ = _apply(jm.MonodepthModel(dtype=jnp.float64), _f64(v),
                        jnp.asarray(x, jnp.float64), train=True,
                        method=jm.MonodepthModel.depth, mutable=["batch_stats"])
        ref = {s: np.asarray(r) for s, r in ref.items()}
    with torch.no_grad():
        got = copy.deepcopy(port).double().depth(t(x, torch.float64), train=True)
    for s in ref:
        _assert_close(got[s], ref[s], 1e-9)


def test_num_parameters_match_jax():
    """26,828,186 parameters in both: ResNet18 depth + ResNet18 pose."""
    d = jnp.zeros((1, 32, 64, 3))
    v = random_variables(jm.MonodepthModel(), d, [d, d])
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(v["params"]))
    n_port = sum(p.numel() for p in tm.MonodepthModel().parameters())
    assert n_jax == n_port == 26_828_186


# ------------------------------------------------------------ depth math


def test_disp_to_depth_range():
    sd, d = tm.disp_to_depth(torch.tensor([0.0, 1.0]))
    np.testing.assert_allclose(d.numpy(), [100.0, 0.1], rtol=1e-5)


@pytest.mark.parametrize("invert", [False, True])
def test_transformation_from_parameters_matches_jax(invert, rng):
    aa = (rng.normal(size=(4, 3)) * 0.3).astype(np.float32)
    tr_ = rng.normal(size=(4, 3)).astype(np.float32)
    ref = np.asarray(jm.transformation_from_parameters(jnp.asarray(aa), jnp.asarray(tr_),
                                                       invert=invert))
    got = tm.transformation_from_parameters(t(aa), t(tr_), invert=invert).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_transformation_invert_roundtrip(rng):
    aa = t(rng.normal(size=(4, 3)) * 0.3)
    tr_ = t(rng.normal(size=(4, 3)))
    T = tm.transformation_from_parameters(aa, tr_)
    Ti = tm.transformation_from_parameters(aa, tr_, invert=True)
    np.testing.assert_allclose((T @ Ti).numpy(), np.broadcast_to(np.eye(4), (4, 4, 4)), atol=1e-5)


# ------------------------------------------------------------------ warp


def test_bilinear_identity(rng):
    img = t(rng.uniform(size=(8, 10, 3)))
    x = torch.arange(10, dtype=torch.float32).repeat(8, 1)
    y = torch.arange(8, dtype=torch.float32)[:, None].repeat(1, 10)
    np.testing.assert_allclose(tm.bilinear_sample(img, x, y).numpy(), img.numpy(), atol=1e-6)


def test_bilinear_halfpixel():
    img = torch.arange(12, dtype=torch.float32).reshape(3, 4, 1)
    out = tm.bilinear_sample(img, torch.full((1, 1), 0.5), torch.zeros((1, 1)))
    assert float(out[0, 0, 0]) == 0.5


def test_bilinear_sample_and_its_gradient_match_jax(rng):
    """Inside, outside and exactly on the border, where jnp.clip's
    derivative is one half and torch.clamp's would be one."""
    img = rng.uniform(size=(6, 9, 3)).astype(np.float32)
    x = np.concatenate([rng.uniform(-2, 10, 40), [0.0, 8.0, 3.25, 0.0]]).astype(np.float32)
    y = np.concatenate([rng.uniform(-2, 7, 40), [2.5, 5.0, 0.0, 5.0]]).astype(np.float32)

    def jax_f(x, y):
        return jnp.sum(jm.bilinear_sample(jnp.asarray(img), x, y) * jnp.arange(3.0))

    ref, (gx, gy) = jax.value_and_grad(jax_f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt, yt = t(x).requires_grad_(), t(y).requires_grad_()
    got = (tm.bilinear_sample(t(img), xt, yt) * torch.arange(3.0)).sum()
    got.backward()
    assert abs(float(got) - float(ref)) <= 1e-5 * abs(float(ref))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(gy), atol=1e-5, rtol=0)


def test_warp_frame_matches_jax(rng):
    src = rng.uniform(size=(2, 16, 20, 3)).astype(np.float32)
    depth = rng.uniform(2.0, 8.0, size=(2, 16, 20)).astype(np.float32)
    aa = (rng.normal(size=(2, 3)) * 0.05).astype(np.float32)
    tr_ = (rng.normal(size=(2, 3)) * 0.3).astype(np.float32)
    T = np.asarray(jm.transformation_from_parameters(jnp.asarray(aa), jnp.asarray(tr_)))
    args = (20.0, 18.0, 10.0, 8.0)
    ref = np.asarray(jm.warp_frame(jnp.asarray(src), jnp.asarray(depth), jnp.asarray(T), *args))
    got = tm.warp_frame(t(src), t(depth), t(T), *args).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_warp_identity_pose_exact(rng):
    src = t(rng.uniform(size=(1, 16, 20, 3)))
    out = tm.warp_frame(src, torch.full((1, 16, 20), 5.0), torch.eye(4)[None], 20.0, 20.0,
                        10.0, 8.0)
    np.testing.assert_allclose(out.numpy(), src.numpy(), atol=1e-5)


def test_warp_translation_shifts():
    """A +x camera translation shifts sampling by fx * tx / Z pixels."""
    src = torch.zeros((1, 8, 16, 1))
    src[0, :, 8, 0] = 1.0
    T = torch.eye(4)[None].clone()
    T[0, 0, 3] = 1.0  # 1 m along +x; shift = fx * 1 / 2 = 2 px
    got = tm.warp_frame(src, torch.full((1, 8, 16), 2.0), T, 4.0, 4.0, 8.0, 4.0)[0, 4]
    assert float(got[6, 0]) > 0.9
    assert float(got[8, 0]) < 0.1


# ---------------------------------------------------------------- losses


def test_ssim_and_reprojection_loss_match_jax(rng):
    x = _img(rng, 2, 12, 14)
    y = np.clip(x + 0.2 * rng.normal(size=x.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(tm.ssim(t(x), t(y)).numpy(),
                               np.asarray(jm.ssim(jnp.asarray(x), jnp.asarray(y))),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(tm.reprojection_loss(t(x), t(y)).numpy(),
                               np.asarray(jm.reprojection_loss(jnp.asarray(x), jnp.asarray(y))),
                               atol=1e-6, rtol=0)


def test_ssim_identical_zero(rng):
    x = t(rng.uniform(size=(1, 12, 12, 3)))
    assert float(tm.ssim(x, x).max()) < 1e-5


def test_reprojection_loss_ordering(rng):
    x = t(rng.uniform(size=(1, 12, 12, 3)))
    noisy = x + 0.3 * t(rng.normal(size=x.shape))
    same, diff = tm.reprojection_loss(x, x).mean(), tm.reprojection_loss(noisy, x).mean()
    assert float(same) < 1e-5 < float(diff)


def test_smoothness_loss_matches_jax(rng):
    disp = rng.uniform(0.05, 1.0, size=(2, 16, 24, 1)).astype(np.float32)
    img = _img(rng, 2, 16, 24)
    ref = float(jm.smoothness_loss(jnp.asarray(disp), jnp.asarray(img)))
    assert abs(float(tm.smoothness_loss(t(disp), t(img))) - ref) <= 1e-5 * ref


def _near_tie_masks(logits, Ts, target, sources, noise, cfg, gap=1e-6):
    """Per scale, the logits whose gradient a near tie can move: where the
    JAX package's two smallest candidates of the per-pixel minimum are
    within ``gap``, float32 rounding may pick either, and the gradient
    follows the pick. The mask covers the SSIM window around such a pixel
    and, at coarser scales, the logits the upsampling spreads over it."""
    N, h, w, _ = target.shape
    masks = []
    for s, raw in enumerate(logits):
        disp = jax.image.resize(jax.nn.sigmoid(jnp.asarray(raw)), (N, h, w, 1), "bilinear")
        _, depth = jm.disp_to_depth(disp[..., 0], cfg.min_depth, cfg.max_depth)
        cand = [jm.reprojection_loss(jm.warp_frame(jnp.asarray(src), depth, jnp.asarray(T),
                                                   cfg.fx, cfg.fy, cfg.cx, cfg.cy),
                                     jnp.asarray(target)) for src, T in zip(sources, Ts)]
        if cfg.automask:
            cand += [jm.reprojection_loss(jnp.asarray(src), jnp.asarray(target)) + n
                     for src, n in zip(sources, noise)]
        srt = np.sort(np.stack([np.asarray(c) for c in cand]), axis=0)
        m = torch.as_tensor(srt[1] - srt[0] < gap, dtype=torch.float32)[:, None]
        m = torch.nn.functional.max_pool2d(m, 3, stride=1, padding=1)
        k = 2 ** s
        if k > 1:
            m = torch.nn.functional.max_pool2d(m, 3 * k, stride=k, padding=k)
        masks.append(m[:, 0, :, :, None].bool().numpy())
    return masks


@pytest.mark.parametrize("automask", [True, False])
@pytest.mark.parametrize("stereo", [False, True])
def test_monodepth_loss_value_and_grads_match_jax(automask, stereo, rng):
    """The multi-scale loss and its gradient with respect to the
    disparities' logits at every scale, JAX's automask noise injected.
    Gradients are compared away from near ties of the per-pixel minimum
    (`_near_tie_masks`; one pixel in 3,072 at scale 0 here)."""
    N, h, w = 2, 32, 48
    cfg = jm.MonodepthLossConfig(automask=automask, fx=40.0, fy=36.0, cx=24.0, cy=16.0)
    tcfg = tm.MonodepthLossConfig(automask=automask, fx=40.0, fy=36.0, cx=24.0, cy=16.0)
    target = _img(rng, N, h, w)
    sources = [_img(rng, N, h, w) for _ in range(3 if stereo else 2)]
    aa = (rng.normal(size=(len(sources), N, 3)) * 0.02).astype(np.float32)
    tt_ = (rng.normal(size=(len(sources), N, 3)) * 0.1).astype(np.float32)
    Ts = [np.asarray(jm.transformation_from_parameters(jnp.asarray(a), jnp.asarray(b)))
          for a, b in zip(aa, tt_)]
    logits = [rng.normal(size=(N, h >> s, w >> s, 1)).astype(np.float32) for s in range(4)]
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (len(sources), N, h, w))) * 1e-5

    def jax_loss(raw):
        disps = {s: jax.nn.sigmoid(r) for s, r in enumerate(raw)}
        loss, _ = jm.monodepth_loss(disps, [jnp.asarray(T) for T in Ts], jnp.asarray(target),
                                    [jnp.asarray(s) for s in sources], cfg,
                                    identity_noise=jnp.asarray(noise))
        return loss

    ref, ref_g = jax.jit(jax.value_and_grad(jax_loss))([jnp.asarray(x) for x in logits])
    raw = [t(x).requires_grad_() for x in logits]
    got, aux = tm.monodepth_loss({s: torch.sigmoid(r) for s, r in enumerate(raw)},
                                 [t(T) for T in Ts], t(target), [t(s) for s in sources], tcfg,
                                 identity_noise=t(noise))
    got.backward()
    assert abs(float(got) - float(ref)) <= 1e-5 * float(ref)
    assert aux["loss/total"] is got
    masks = _near_tie_masks(logits, Ts, target, sources, noise, cfg)
    for r, g, near in zip(raw, ref_g, masks):
        g = np.asarray(g)
        assert near.mean() < 0.02
        err = np.where(near, 0.0, np.abs(r.grad.numpy() - g))
        assert err.max() <= 1e-4 * np.abs(g).max()


def test_monodepth_loss_runs_and_grads():
    """tests/test_models.py's case: sigmoid(0) disparities at two scales,
    identity poses, the constant tiebreak."""
    rng = np.random.default_rng(0)
    N, h, w = 1, 32, 32
    cfg = tm.MonodepthLossConfig(scales=(0, 1), fx=30.0, fy=30.0, cx=16.0, cy=16.0)
    target, prev, nxt = (t(rng.uniform(size=(N, h, w, 3))) for _ in range(3))
    T = torch.eye(4)[None]
    raw = torch.zeros((N, h, w, 1), requires_grad=True)
    loss, _ = tm.monodepth_loss({0: torch.sigmoid(raw), 1: torch.sigmoid(raw[:, ::2, ::2])},
                                [T, T], target, [prev, nxt], cfg)
    loss.backward()
    assert np.isfinite(float(loss)) and torch.isfinite(raw.grad).all()


# --------------------------------------------------------------- metrics


def test_depth_metrics_match_jax_on_an_even_count(rng):
    """An even number of valid pixels: both packages take the upper median
    (sorted[n // 2]); torch.median's lower one would change the scale."""
    gt = rng.uniform(1.0, 10.0, size=(2, 8, 8)).astype(np.float32)
    gt[0, :2] = 0.0   # 48 valid
    gt[1, 0, :6] = 0.0  # 58 valid
    pred = (gt * rng.uniform(0.7, 1.4, size=gt.shape) + 0.3).astype(np.float32)
    ref = jmet.depth_metrics(jnp.asarray(pred), jnp.asarray(gt))
    got = tmet.depth_metrics(t(pred), t(gt))
    assert set(got) == set(ref)
    for k in ref:
        assert abs(float(got[k]) - float(ref[k])) <= 1e-5 * max(1.0, abs(float(ref[k]))), k
    mask = t(gt[0]) > 1e-3
    vals = t(gt[0])[mask]
    assert float(tmet._masked_median(t(gt[0]), mask)) == float(torch.sort(vals).values[24])
    assert float(torch.median(vals)) != float(torch.sort(vals).values[24])


def test_perfect_prediction(rng):
    gt = t(rng.uniform(1.0, 10.0, size=(2, 8, 8)))
    m = tmet.depth_metrics(gt, gt)
    assert float(m["abs_rel"]) < 1e-6 and float(m["a1"]) == 1.0 and float(m["rmse"]) < 1e-3


def test_median_scaling_invariance(rng):
    gt = t(rng.uniform(1.0, 10.0, size=(1, 8, 8)))
    pred = gt * 1.07
    m1, m2 = tmet.depth_metrics(pred, gt), tmet.depth_metrics(pred * 5.0, gt)
    assert abs(float(m1["abs_rel"]) - float(m2["abs_rel"])) < 1e-6


def test_invalid_pixels_ignored():
    gt = torch.full((1, 8, 8), 5.0)
    gt[0, 0, :] = 0.0
    pred = torch.full((1, 8, 8), 5.0)
    pred[0, 0, :] = 999.0
    assert float(tmet.depth_metrics(pred, gt)["abs_rel"]) < 1e-6


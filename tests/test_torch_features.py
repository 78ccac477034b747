"""Parity of the port's quad-pack sampling and feature front end
(`tpu3drec_torch/ops/quadpack.py`, `tpu3drec_torch/sfm/features.py`) with
the JAX package on the CPU.

Tolerances. Quad packing, gathers and the extremum and edge masks (given
the same DoG) are exact. Blurs, DoG stacks and descriptors differ from
XLA's by summation order and by XLA's fused multiply-adds: within 1e-6
(images in [0, 1]) and 2e-5 (descriptor entries). Detection gives the same
valid keypoint set, with xy within 1e-3 px, scales equal and angles within
1e-4 rad, on the dots and textured fixtures of tests/test_features.py. On
images with DoG plateaus (its symmetric two-scale blobs, a capture-sim
frame) the sets agree as positions (`test_pyramid_on_dog_plateaus`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3drec.ops import quadpack as jq
from tpu3drec.sfm import features as jf
from tpu3drec_torch.ops import quadpack
from tpu3drec_torch.sfm import features as tf

from test_features import _dots_image


def _t(x):
    return torch.tensor(np.array(x))


def _textured(rng, h=128, w=160):
    from scipy.ndimage import gaussian_filter

    img = gaussian_filter(rng.normal(size=(h, w)), 2.0)
    return ((img - img.min()) / np.ptp(img)).astype(np.float32)


def _two_scale_blobs(rng):
    h, w = 192, 256
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w), np.float32)
    for (x, y) in [(40, 40), (200, 40), (120, 150)]:
        img += np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / (2 * 2.0 ** 2))
    for (x, y) in [(60, 120), (190, 150)]:
        img += 0.8 * np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / (2 * 8.0 ** 2))
    return np.clip(img, 0, 1).astype(np.float32)


def _capture_sim_frame(rng):
    from tpu3drec.data.capture_sim import SimScene, render_frame
    from tpu3drec.utils.config import CameraConfig

    scene = SimScene.clustered(rng, n_landmarks=150, sats=4)
    cam = CameraConfig(fx=220.0, fy=220.0, cx=128.0, cy=96.0, width=256, height=192)
    rgb, _ = render_frame(scene, np.eye(3), np.zeros(3), cam)
    return (rgb.astype(np.float32) @ np.array([0.299, 0.587, 0.114], np.float32)) / 255.0


FIXTURES = {
    "dots": lambda rng: _dots_image(rng, n=15)[0],
    "textured": _textured,
}
# images with exact or near (one-ulp) DoG plateaus: symmetric blobs centred
# between the pixels of the upsampled octave, and a rendered uint8 frame
PLATEAU_FIXTURES = {
    "two_scale": _two_scale_blobs,
    "capture_sim": _capture_sim_frame,
}


# ---------------------------------------------------------------- quadpack

def test_quadpack_matches_jax(rng):
    img = rng.normal(size=(9, 11, 3)).astype(np.float32)
    q = quadpack.quad_pack(_t(img))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq.quad_pack(jnp.asarray(img))))
    y0 = rng.integers(0, 9, (5, 7))
    x0 = rng.integers(0, 11, (5, 7))
    got = quadpack.quad_gather(q, _t(y0), _t(x0))
    want = jq.quad_gather(jq.quad_pack(jnp.asarray(img)), jnp.asarray(y0), jnp.asarray(x0))
    corners = quadpack.gather_corners(_t(img), _t(y0), _t(x0))
    for g, c, w in zip(got, corners, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(c.numpy(), np.asarray(w))
    x = rng.uniform(-2, 13, (4, 6)).astype(np.float32)
    y = rng.uniform(-2, 11, (4, 6)).astype(np.float32)
    s = quadpack.bilinear_sample_quad(q, _t(x), _t(y)).numpy()
    sj = np.asarray(jq.bilinear_sample_quad(jq.quad_pack(jnp.asarray(img)), jnp.asarray(x),
                                            jnp.asarray(y)))
    np.testing.assert_allclose(s, sj, rtol=0, atol=1e-6)
    # border-clamped bilinear == grid_sample(padding_mode="border") in pixels
    gx = 2 * (np.clip(x, 0, 10) + 0.5) / 11 - 1
    gy = 2 * (np.clip(y, 0, 8) + 0.5) / 9 - 1
    grid = _t(np.stack([gx, gy], -1))[None]
    ref = torch.nn.functional.grid_sample(_t(img).permute(2, 0, 1)[None], grid,
                                          padding_mode="border", align_corners=False)
    np.testing.assert_allclose(s, ref[0].permute(1, 2, 0).numpy(), atol=1e-5)


# ----------------------------------------------------------- scale pyramid

def test_blur_and_stacks_match_jax(rng):
    img = rng.uniform(size=(40, 52)).astype(np.float32)
    np.testing.assert_allclose(tf.gaussian_kernel1d(1.6, 5).numpy(),
                               np.asarray(jf.gaussian_kernel1d(1.6, 5)), rtol=1e-6)
    for sigma in (0.8, 1.6, 4.8):
        np.testing.assert_allclose(tf.gaussian_blur(_t(img), sigma).numpy(),
                                   np.asarray(jf.gaussian_blur(jnp.asarray(img), sigma)),
                                   atol=1e-6)
    out = tf.gaussian_blur(_t(img), 1.5).numpy()
    np.testing.assert_allclose(out.mean(), img.mean(), rtol=5e-3)
    assert out.std() < img.std()
    for fn in ("dog_stack", "dog_stack_from_base"):
        G, D, s = getattr(tf, fn)(_t(img))
        Gj, Dj, sj = getattr(jf, fn)(jnp.asarray(img))
        np.testing.assert_allclose(G.numpy(), np.asarray(Gj), atol=1e-6)
        np.testing.assert_allclose(D.numpy(), np.asarray(Dj), atol=1e-6)
        np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


def test_extrema_and_edge_masks_match_jax(rng):
    """Same DoG in, same masks out (the DoG comes from JAX, so only the
    comparisons and the Hessian test are under test)."""
    _, Dj, _ = jf.dog_stack_from_base(jnp.asarray(_textured(rng)))
    D = np.asarray(Dj)
    np.testing.assert_array_equal(tf._local_extrema(_t(D), 0.006).numpy(),
                                  np.asarray(jf._local_extrema(Dj, 0.006)))
    np.testing.assert_array_equal(tf._edge_response_ok(_t(D)).numpy(),
                                  np.asarray(jf._edge_response_ok(Dj)))


# --------------------------------------------------------------- detection

def _assert_same_keypoints(kj, kt, desc_j=None, desc_t=None):
    vj, vt = np.asarray(kj.valid), kt.valid.numpy()
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_allclose(kt.xy.numpy()[vt], np.asarray(kj.xy)[vj], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(kt.scale.numpy()[vt], np.asarray(kj.scale)[vj])
    np.testing.assert_allclose(kt.angle.numpy()[vt], np.asarray(kj.angle)[vj], atol=1e-4)
    if desc_j is not None:
        np.testing.assert_allclose(desc_t.numpy(), np.asarray(desc_j), rtol=0, atol=2e-5)


@pytest.mark.parametrize("upright", [True, False])
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_pyramid_matches_jax(fixture, upright, rng):
    img = FIXTURES[fixture](rng)
    kj, dj = jf.detect_and_describe_pyramid(jnp.asarray(img), max_keypoints=96, upright=upright)
    kt, dt = tf.detect_and_describe_pyramid(_t(img), max_keypoints=96, upright=upright)
    assert kt.valid.sum() >= 5
    _assert_same_keypoints(kj, kt, dj, dt)


@pytest.mark.parametrize("upright", [True, False])
@pytest.mark.parametrize("fixture", sorted(PLATEAU_FIXTURES))
def test_pyramid_on_dog_plateaus(fixture, upright, rng):
    """Where the DoG has a plateau, equal to the last bit or within one ulp,
    the packages' different roundings make different members of it the
    extremum, so the order of the top-K list and which duplicates the NMS
    drops differ (ROADMAP.md Queue C). The keypoint sets still agree as
    positions: >= 97% of each side's keypoints lie within 1e-2 px of one of
    the other's, at the same scale."""
    img = PLATEAU_FIXTURES[fixture](rng)
    kj, _ = jf.detect_and_describe_pyramid(jnp.asarray(img), max_keypoints=96, upright=upright)
    kt, _ = tf.detect_and_describe_pyramid(_t(img), max_keypoints=96, upright=upright)
    vj, vt = np.asarray(kj.valid), kt.valid.numpy()
    xj, xt = np.asarray(kj.xy)[vj], kt.xy.numpy()[vt]
    assert len(xj) >= 5
    d = np.linalg.norm(xj[:, None] - xt[None], axis=-1)
    assert (d.min(1) < 1e-2).mean() >= 0.97
    assert (d.min(0) < 1e-2).mean() >= 0.97
    near = d.argmin(1)
    np.testing.assert_array_equal(kt.scale.numpy()[vt][near], np.asarray(kj.scale)[vj])


def test_single_octave_matches_jax(rng):
    img, _ = _dots_image(rng, n=12)
    kj = jf.detect_keypoints(jnp.asarray(img), max_keypoints=64)
    kt = tf.detect_keypoints(_t(img), max_keypoints=64)
    _assert_same_keypoints(kj, kt)
    # descriptors of the JAX keypoints, fed to both
    kin = tf.Keypoints.from_numpy(*(np.asarray(x) for x in kj), device="cpu")
    np.testing.assert_allclose(tf.describe_keypoints(_t(img), kin).numpy(),
                               np.asarray(jf.describe_keypoints(jnp.asarray(img), kj)),
                               atol=2e-5)
    for upright in (True, False):
        kj, dj = jf.detect_and_describe(jnp.asarray(img), max_keypoints=64, upright=upright,
                                        num_octaves=1)
        kt, dt = tf.detect_and_describe(_t(img), max_keypoints=64, upright=upright,
                                        num_octaves=1)
        _assert_same_keypoints(kj, kt, dj, dt)


def test_batched_frames_equal_single_frames(rng):
    imgs = np.stack([_dots_image(rng, n=12)[0], _textured(rng, 96, 128)])
    kb, db = tf.detect_and_describe(_t(imgs), max_keypoints=64, upright=True)
    assert tuple(db.shape) == (2, 64, 128)
    for i in range(2):
        ks, ds = tf.detect_and_describe(_t(imgs[i]), max_keypoints=64, upright=True)
        assert torch.equal(kb.valid[i], ks.valid)
        assert torch.equal(kb.xy[i], ks.xy)
        assert torch.equal(db[i], ds)


def test_dense_orientation_matches_jax_and_gather_form(rng):
    H, W, S = 96, 128, 3
    img = rng.uniform(size=(H, W)).astype(np.float32)
    G = np.stack([np.asarray(jf.gaussian_blur(jnp.asarray(img), s)) for s in (1.0, 1.6, 2.2)])
    Gj = jnp.asarray(G)
    gx = (jnp.roll(Gj, -1, 2) - jnp.roll(Gj, 1, 2)) * 0.5
    gy = (jnp.roll(Gj, -1, 1) - jnp.roll(Gj, 1, 1)) * 0.5
    mag, ori = jnp.sqrt(gx * gx + gy * gy), jnp.arctan2(gy, gx)
    K = 64
    s_idx = rng.integers(0, S, K)
    x_idx = rng.integers(10, W - 10, K)
    y_idx = rng.integers(10, H - 10, K)
    args_j = (jnp.asarray(s_idx), jnp.asarray(x_idx), jnp.asarray(y_idx))
    args_t = tuple(_t(a)[None] for a in (s_idx, x_idx, y_idx))
    mt, ot = _t(np.asarray(mag))[None], _t(np.asarray(ori))[None]

    def wrapped(a, b):  # compare angles on the circle
        return np.abs((a - b + np.pi) % (2 * np.pi) - np.pi)

    dense_t = tf._dominant_orientation_dense(mt, ot, *args_t)[0].numpy()
    dense_j = np.asarray(jf._dominant_orientation_dense(mag, ori, *args_j))
    gather_t = tf._dominant_orientation(mt, ot, *args_t)[0].numpy()
    gather_j = np.asarray(jf._dominant_orientation(mag, ori, *args_j))
    assert wrapped(dense_t, dense_j).max() < 1e-4
    assert wrapped(gather_t, gather_j).max() < 1e-4
    # the reference test's bar between the two forms, on the port
    assert (wrapped(dense_t, gather_t) < np.deg2rad(2.0)).mean() > 0.9


def test_reference_feature_bars_on_the_port(rng):
    """tests/test_features.py's detection and descriptor checks, on the port."""
    img, pts = _dots_image(rng, n=12)
    kps = tf.detect_keypoints(_t(img), max_keypoints=64)
    found = kps.xy.numpy()[kps.valid.numpy()]
    assert len(found) >= 10
    assert (np.linalg.norm(pts[:, None] - found[None], axis=-1).min(1) < 2.0).mean() > 0.8
    kps, desc = tf.detect_and_describe(_t(_dots_image(rng)[0]), max_keypoints=64)
    norms = np.linalg.norm(desc.numpy(), axis=1)
    np.testing.assert_allclose(norms[kps.valid.numpy()], 1.0, atol=1e-4)
    assert (norms[~kps.valid.numpy()] == 0).all()
    kps, _ = tf.detect_and_describe_pyramid(_t(_two_scale_blobs(rng)), max_keypoints=64)
    xy = kps.xy.numpy()[kps.valid.numpy()]
    sc = kps.scale.numpy()[kps.valid.numpy()]
    for (x, y), small in [((40, 40), True), ((200, 40), True), ((60, 120), False)]:
        d = np.linalg.norm(xy - [x, y], axis=1)
        assert d.min() < (2.5 if small else 4.0)
        assert (sc[d.argmin()] < 4.0) == small

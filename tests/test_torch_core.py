"""Parity of the port's core geometry (`tpu3drec_torch/core/`) with the JAX
package: the same seeded numpy inputs through both, on the CPU.

Tolerance: atol 1e-5 times the scene scale (1 for unit quaternions and
rotations, the largest coordinate for points). Both sides compute in
float32; the bound covers a few roundings of the largest term.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3drec.core import camera as jcam
from tpu3drec.core import quaternion as jq
from tpu3drec.core import se3 as jse3
from tpu3drec.core import unproject as jun
from tpu3drec_torch.core import camera as tcam
from tpu3drec_torch.core import quaternion as tq
from tpu3drec_torch.core import se3 as tse3
from tpu3drec_torch.core import unproject as tun

torch.set_num_threads(2)
CPU = "cpu"
SEEDS = [0, 1, 2]


def _close(got, want, scale=1.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5 * scale)


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _rotations(rng, n):
    return np.array(jq.quat_wxyz_to_matrix(jnp.asarray(_quats(rng, n))))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fn", ["quat_wxyz_to_matrix", "quat_xyzw_to_matrix",
                                "quat_normalize", "quat_conjugate",
                                "quat_wxyz_from_xyzw", "quat_xyzw_from_wxyz"])
def test_quaternion_unary(seed, fn):
    q = (_quats(np.random.default_rng(seed), 64) * 1.7).astype(np.float32)
    _close(getattr(tq, fn)(torch.from_numpy(q)), getattr(jq, fn)(jnp.asarray(q)))


@pytest.mark.parametrize("seed", SEEDS)
def test_quat_multiply(seed):
    rng = np.random.default_rng(seed)
    a, b = _quats(rng, 32), _quats(rng, 32)
    _close(tq.quat_multiply(torch.from_numpy(a), torch.from_numpy(b)),
           jq.quat_multiply(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("seed", SEEDS)
def test_matrix_to_quat_wxyz(seed):
    R = _rotations(np.random.default_rng(seed), 64)
    # include the w ~ 0 branch: rotations by pi about each axis
    R = np.concatenate([R, np.diag([1.0, -1, -1])[None], np.diag([-1.0, 1, -1])[None],
                        np.diag([-1.0, -1, 1])[None]]).astype(np.float32)
    _close(tq.matrix_to_quat_wxyz(torch.from_numpy(R)),
           jq.matrix_to_quat_wxyz(jnp.asarray(R)))


@pytest.mark.parametrize("seed", SEEDS)
def test_se3_ops(seed):
    rng = np.random.default_rng(seed)
    R1, R2 = _rotations(rng, 8).copy(), _rotations(rng, 8).copy()
    t1, t2 = (rng.normal(size=(8, 3)) * 5).astype(np.float32), rng.normal(size=(8, 3)).astype(np.float32)
    pts = (rng.normal(size=(8, 50, 3)) * 10).astype(np.float32)
    A, B = tse3.SE3(torch.from_numpy(R1), torch.from_numpy(t1)), tse3.SE3(torch.from_numpy(R2), torch.from_numpy(t2))
    jA, jB = jse3.SE3(jnp.asarray(R1), jnp.asarray(t1)), jse3.SE3(jnp.asarray(R2), jnp.asarray(t2))
    inv, jinv = tse3.se3_inverse(A), jse3.se3_inverse(jA)
    _close(inv.R, jinv.R)
    _close(inv.t, jinv.t, 5)
    comp, jcomp = tse3.se3_compose(A, B), jse3.se3_compose(jA, jB)
    _close(comp.R, jcomp.R)
    _close(comp.t, jcomp.t, 5)
    _close(tse3.se3_matrix(A), jse3.se3_matrix(jA), 5)
    # (B,3,3) over (N,3): every transform to every point
    _close(tse3.se3_apply(A, torch.from_numpy(pts[0])), jse3.se3_apply(jA, jnp.asarray(pts[0])), 20)
    # (B,3,3) over (B,3): one point per transform
    _close(tse3.se3_apply(A, torch.from_numpy(pts[:, 0])), jse3.se3_apply(jA, jnp.asarray(pts[:, 0])), 20)
    # one transform over (B,N,3)
    A0, jA0 = tse3.SE3(A.R[0], A.t[0]), jse3.SE3(jA.R[0], jA.t[0])
    _close(tse3.se3_apply(A0, torch.from_numpy(pts)), jse3.se3_apply(jA0, jnp.asarray(pts)), 20)
    with pytest.raises(ValueError):
        tse3.se3_apply(A0, torch.zeros(4, 2))
    T = np.array(jse3.se3_matrix(jA))
    fm, jfm = tse3.SE3.from_matrix(torch.from_numpy(T)), jse3.SE3.from_matrix(jnp.asarray(T))
    _close(fm.R, jfm.R)
    _close(fm.t, jfm.t)


@pytest.mark.parametrize("seed", SEEDS)
def test_axis_angle(seed):
    rng = np.random.default_rng(seed)
    aa = np.concatenate([rng.normal(size=(32, 3)), rng.normal(size=(4, 3)) * 1e-9]).astype(np.float32)
    _close(tse3.axis_angle_to_matrix(torch.from_numpy(aa)), jse3.axis_angle_to_matrix(jnp.asarray(aa)))
    R = _rotations(rng, 32)
    # the log map loses precision as theta -> pi; compare well inside
    _close(tse3.matrix_to_axis_angle(torch.from_numpy(R)), jse3.matrix_to_axis_angle(jnp.asarray(R)), 3)


@pytest.mark.parametrize("seed", SEEDS)
def test_colmap_conventions(seed):
    rng = np.random.default_rng(seed)
    q = _quats(rng, 16)
    t = (rng.normal(size=(16, 3)) * 5).astype(np.float32)
    for fn in ("colmap_world_to_cam", "colmap_cam_to_world"):
        got = getattr(tse3, fn)(torch.from_numpy(q), torch.from_numpy(t))
        want = getattr(jse3, fn)(jnp.asarray(q), jnp.asarray(t))
        _close(got.R, want.R)
        _close(got.t, want.t, 5)


@pytest.mark.parametrize("seed", SEEDS)
def test_camera(seed):
    rng = np.random.default_rng(seed)
    tc = tcam.PinholeCamera.reference_default(device=CPU)
    jc = jcam.PinholeCamera.reference_default()
    _close(tc.K(), jc.K(), 600)
    pc = np.concatenate([rng.uniform(-5, 5, (100, 2)), rng.uniform(0.5, 50, (100, 1))], 1).astype(np.float32)
    _close(tc.project(torch.from_numpy(pc)), jc.project(jnp.asarray(pc)), 1e4)
    uv = rng.uniform(0, 640, (100, 2)).astype(np.float32)
    z = rng.uniform(0.5, 50, 100).astype(np.float32)
    _close(tc.unproject(torch.from_numpy(uv), torch.from_numpy(z)),
           jc.unproject(jnp.asarray(uv), jnp.asarray(z)), 50)
    sc, jsc = tc.scaled(0.5), jc.scaled(0.5)
    assert (sc.width, sc.height) == (jsc.width, jsc.height)
    _close(sc.K(), jsc.K(), 600)
    Kn = np.array([[0.58, 0, 0.5], [0, 1.92, 0.5], [0, 0, 1]], np.float32)
    _close(tcam.PinholeCamera.from_normalized(Kn, 640, 480, device=CPU).K(),
           jcam.PinholeCamera.from_normalized(Kn, 640, 480).K(), 1000)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1, 8, 12), (3, 24, 32), (4, 48, 64)])
def test_fuse_depth_maps(seed, shape):
    rng = np.random.default_rng(seed)
    F, H, W = shape
    depths = rng.uniform(0.5, 50, shape).astype(np.float32)
    depths[rng.random(shape) < 0.1] = 0.0
    Rs = _rotations(rng, F).astype(np.float32)
    ts = (rng.normal(size=(F, 3)) * 10).astype(np.float32)
    intr = (300.0, 310.0, W / 2, H / 2)
    pts, valid = tun.fuse_depth_maps(depths, Rs, ts, *intr, min_depth=1e-3, max_depth=40.0,
                                     device=CPU)
    jpts, jvalid = jun.fuse_depth_maps(jnp.asarray(depths), jnp.asarray(Rs), jnp.asarray(ts),
                                       *intr, min_depth=1e-3, max_depth=40.0)
    assert pts.shape == (F * H * W, 3) and pts.dtype == torch.float32
    _close(pts, jpts, float(np.abs(np.asarray(jpts)).max()))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


@pytest.mark.parametrize("seed", SEEDS)
def test_single_frame_unproject(seed):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.5, 50, (24, 32)).astype(np.float32)
    R, t = _rotations(rng, 1)[0], (rng.normal(size=3) * 3).astype(np.float32)
    tc = tcam.PinholeCamera.create(300.0, 310.0, 16.0, 12.0, 32, 24, device=CPU)
    jc = jcam.PinholeCamera.create(300.0, 310.0, 16.0, 12.0, 32, 24)
    d = torch.from_numpy(depth)
    _close(tun.depth_to_camera_points(d, tc), jun.depth_to_camera_points(jnp.asarray(depth), jc), 50)
    T, jT = tse3.SE3(torch.from_numpy(R), torch.from_numpy(t)), jse3.SE3(jnp.asarray(R), jnp.asarray(t))
    _close(tun.depth_to_world_points(d, tc, T), jun.depth_to_world_points(jnp.asarray(depth), jc, jT), 60)
    pc = tun.depth_to_camera_points(d, tc)
    _close(tun.camera_to_world_points(pc, T),
           jun.camera_to_world_points(jnp.asarray(pc.numpy()), jT), 60)


@pytest.mark.parametrize("seed", SEEDS)
def test_unfused_unproject_equals_eager_jax(seed):
    """The unfused unprojection against the JAX package's
    `depth_to_world_points` called eagerly, as its `occupancy` CLI calls
    it: one op at a time, no fma. Bit for bit."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.5, 50, (24, 32)).astype(np.float32)
    R, t = _rotations(rng, 1)[0], (rng.normal(size=3) * 3).astype(np.float32)
    tc = tcam.PinholeCamera.create(300.0, 310.0, 16.0, 12.0, 32, 24, device=CPU)
    jc = jcam.PinholeCamera.create(300.0, 310.0, 16.0, 12.0, 32, 24)
    got = tun.depth_to_world_points_unfused(
        torch.from_numpy(depth), tc, tse3.SE3(torch.from_numpy(R), torch.from_numpy(t)))
    want = jun.depth_to_world_points(jnp.asarray(depth), jc,
                                     jse3.SE3(jnp.asarray(R), jnp.asarray(t)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_entry_points_default_to_the_card():
    """device=None means CUDA; without a card that raises, never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tun.fuse_depth_maps(np.ones((1, 2, 2), np.float32), np.eye(3)[None], np.zeros((1, 3)),
                            1.0, 1.0, 1.0, 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcam.PinholeCamera.reference_default()

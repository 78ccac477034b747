"""Parity of the port's Kalman filter and PID controller
(`tpu3drec_torch/utils/estimation.py`) with the JAX package's, on
tests/test_aux.py's four cases.

Tolerances: the filter's states and covariances within 1e-5 relative to
their scale over 200 steps (float32 matmuls sum in another order on each
side); PID outputs within 1e-6 (a handful of float32 operations a step).
Parameters pass between the packages through numpy (`models/convert.py::
tuple_from_numpy`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3drec.utils import estimation as jest
from tpu3drec_torch.models.convert import tuple_from_numpy
from tpu3drec_torch.utils import estimation as test_

torch.set_num_threads(2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tracks_constant_velocity(seed):
    rng = np.random.default_rng(seed)
    params = test_.altitude_kalman(dt=0.1, q=0.01, r=0.5, device="cpu")
    jparams = jest.altitude_kalman(dt=0.1, q=0.01, r=0.5)
    for a, b in zip(params, jparams):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    T = 200
    true = 2.0 + 0.5 * 0.1 * np.arange(T)
    z = (true + rng.normal(0, 0.7, T))[:, None].astype(np.float32)
    x0, P0 = np.zeros(2, np.float32), (np.eye(2) * 10.0).astype(np.float32)
    xs, Ps = test_.kalman_filter(tuple_from_numpy(test_.KalmanParams, jparams, "cpu"),
                                 torch.as_tensor(x0), torch.as_tensor(P0), torch.as_tensor(z))
    jxs, jPs = jest.kalman_filter(jparams, jnp.asarray(x0), jnp.asarray(P0), jnp.asarray(z))
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), rtol=0, atol=1e-5 * np.abs(jxs).max())
    np.testing.assert_allclose(Ps.numpy(), np.asarray(jPs), rtol=0, atol=1e-5 * np.abs(jPs).max())
    est = xs.numpy()[:, 0]
    raw_err = np.abs(z[100:, 0] - true[100:]).mean()
    assert np.abs(est[100:] - true[100:]).mean() < raw_err * 0.7
    assert abs(float(xs[-1, 1]) - 0.5) < 0.2


def test_p_only_proportional():
    pid = test_.PIDController(kp=2.0, ki=0.0, kd=0.0)
    e = np.array([1.0, -0.5, 0.25], np.float32)
    outs = test_.pid_rollout(pid, torch.as_tensor(e), dt=0.1)
    jouts = jest.pid_rollout(jest.PIDController(kp=2.0, ki=0.0, kd=0.0), jnp.asarray(e), dt=0.1)
    np.testing.assert_allclose(outs.numpy(), np.asarray(jouts), atol=1e-6)
    np.testing.assert_allclose(outs.numpy(), [2.0, -1.0, 0.5], atol=1e-6)


@pytest.mark.parametrize("gains", [(0.0, 1.0, 0.0, 0.25, 1e9), (1.5, 0.7, 0.2, 0.3, 0.8)])
def test_integral_accumulates_and_clamps(gains):
    rng = np.random.default_rng(5)
    e = np.concatenate([np.ones(10), rng.normal(size=20)]).astype(np.float32)
    pid = tuple_from_numpy(test_.PIDController, jest.PIDController(*gains), "cpu")
    outs = test_.pid_rollout(pid, torch.as_tensor(e), dt=0.1)
    jouts = jest.pid_rollout(jest.PIDController(*gains), jnp.asarray(e), dt=0.1)
    np.testing.assert_allclose(outs.numpy(), np.asarray(jouts), atol=1e-6)
    if gains[0] == 0.0:
        np.testing.assert_allclose(float(outs[9]), 0.25, atol=1e-6)
    assert np.abs(outs.numpy()).max() <= gains[4] + 1e-6


def test_closed_loop_converges():
    """A first-order plant x' = u driven to 1, stepping each controller from
    the host: the trajectories agree at every step."""
    pid, jpid = test_.PIDController(3.0, 0.5, 0.1), jest.PIDController(3.0, 0.5, 0.1)
    s, js = pid.init(device="cpu"), jpid.init()
    x = jx = 0.0
    for _ in range(300):
        s, u = pid.step(s, 1.0 - x, 0.05)
        js, ju = jpid.step(js, 1.0 - jx, 0.05)
        x = x + float(u) * 0.05
        jx = jx + float(ju) * 0.05
        assert abs(x - jx) <= 1e-5
    assert abs(x - 1.0) < 0.05

"""State estimation and control primitives: Kalman filter and PID (port of
`tpu3drec/utils/estimation.py`).

The barometer + Kalman altitude fusion and the PID position, height and
yaw control of a flight client. The JAX package filters a whole telemetry
log in one `lax.scan`; here the scan is a loop over the time steps on the
tensors' device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu3drec_torch.core.fp import clip
from tpu3drec_torch.utils.device import resolve_device


class KalmanParams(NamedTuple):
    F: torch.Tensor  # (n, n) state transition
    H: torch.Tensor  # (m, n) observation
    Q: torch.Tensor  # (n, n) process noise
    R: torch.Tensor  # (m, m) observation noise


def kalman_filter(params: KalmanParams, x0: torch.Tensor, P0: torch.Tensor,
                  measurements: torch.Tensor):
    """Kalman filtering over a (T, m) measurement sequence from state x0 (n,)
    and covariance P0 (n, n). Returns (states (T, n), covariances (T, n, n))."""
    F, H, Q, R = params
    x, P = x0, P0
    eye = torch.eye(P0.shape[0], dtype=P0.dtype, device=P0.device)
    xs, Ps = [], []
    for z in measurements:
        # predict
        x = F @ x
        P = F @ P @ F.T + Q
        # update
        S = H @ P @ H.T + R
        K = P @ H.T @ torch.linalg.inv(S)
        x = x + K @ (z - H @ x)
        P = (eye - K @ H) @ P
        xs.append(x)
        Ps.append(P)
    return torch.stack(xs), torch.stack(Ps)


def altitude_kalman(dt: float = 0.02, q: float = 0.05, r: float = 1.0,
                    device=None) -> KalmanParams:
    """Constant-velocity altitude model (the barometer filter's
    configuration class), float32 on ``device``."""
    dev = resolve_device(device)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    F = f32([[1.0, dt], [0.0, 1.0]])
    H = f32([[1.0, 0.0]])
    Q = f32([[0.25 * dt ** 4, 0.5 * dt ** 3], [0.5 * dt ** 3, dt ** 2]]) * q
    R = f32([[r]])
    return KalmanParams(F, H, Q, R)


class PIDState(NamedTuple):
    integral: torch.Tensor
    prev_error: torch.Tensor


class PIDController(NamedTuple):
    """Gains; a stateless step, so one controller serves many states."""

    kp: float
    ki: float
    kd: float
    i_limit: float = 1e9
    out_limit: float = 1e9

    def init(self, shape=(), device=None) -> PIDState:
        dev = resolve_device(device)
        return PIDState(torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))

    def step(self, state: PIDState, error, dt: float):
        integral = clip(state.integral + error * dt, -self.i_limit, self.i_limit)
        deriv = (error - state.prev_error) / dt
        out = clip(self.kp * error + self.ki * integral + self.kd * deriv,
                   -self.out_limit, self.out_limit)
        return PIDState(integral, error), out


def pid_rollout(controller: PIDController, errors: torch.Tensor, dt: float = 0.02):
    """Apply the controller over an error sequence (T,) -> outputs (T,)."""
    s = controller.init(device=errors.device)
    outs = []
    for e in errors:
        s, out = controller.step(s, e, dt)
        outs.append(out)
    return torch.stack(outs)

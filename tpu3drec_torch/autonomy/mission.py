"""Mission controller: the autonomous-flight state machine over static-shape
state (port of `tpu3drec/autonomy/mission.py`).

Takeoff, a waypoint queue, ring-gate search and PID visual servoing to
centre the gate within +-10 px before dashing through it, an ArUco scan
sweep (right-to-left, forward, left-to-right), landing-pad search and
landing. `mission_step` is one control tick; `mission_rollout` closes the
loop with an observation function. The JAX package picks the phase's
branch with `lax.switch` inside one compiled scan; here the branch is
picked on the host from the phase, one device read a tick, and the rest of
the tick stays on the state's device.
"""

from __future__ import annotations

from enum import IntEnum
from typing import Callable, NamedTuple

import torch

from tpu3drec_torch.core.fp import clip, fma, sqrt, sum_squares
from tpu3drec_torch.utils.device import as_f32, resolve_device
from tpu3drec_torch.utils.estimation import PIDController, PIDState


class Phase(IntEnum):
    TAKEOFF = 0
    NAV_WAYPOINT = 1
    SEARCH_GATE = 2
    ALIGN_GATE = 3
    PASS_GATE = 4
    ARUCO_SCAN = 5
    PARK_SEARCH = 6
    ALIGN_PARK = 7
    DESCEND = 8
    LANDED = 9


class Observation(NamedTuple):
    """Per-tick sensing, from the detect/aruco functions (or a simulator)."""

    ring_px: torch.Tensor      # (2,) gate centre (x, y) in the front image
    ring_score: torch.Tensor   # scalar detection confidence
    blob_px: torch.Tensor      # (2,) pad centre (x, y) in the below image
    blob_found: torch.Tensor   # bool
    altitude: torch.Tensor     # scalar (world z)
    position: torch.Tensor     # (3,) estimated world position
    marker_ids: torch.Tensor   # (M,) decoded ids this tick (-1 = none)


class Command(NamedTuple):
    velocity: torch.Tensor  # (3,) world-frame commanded velocity
    yaw_rate: torch.Tensor  # scalar


class MissionConfig(NamedTuple):
    waypoints: torch.Tensor         # (N, 3) pillar/gate approach points
    gate_waypoint: torch.Tensor     # (N,) bool: search for a ring on arrival
    task_ids: torch.Tensor          # (K,) ArUco ids to collect
    image_center: torch.Tensor      # (2,) servo setpoint
    cruise_alt: float = 4.0
    land_alt: float = 0.3
    wp_tol: float = 0.5
    align_tol_px: float = 10.0      # the +-10 px gate window
    align_ticks: int = 3            # consecutive centred ticks before the dash
    pass_ticks: int = 20
    scan_ticks: int = 60            # one right2left/forward/left2right leg
    ring_score_min: float = 0.25
    speed: float = 1.5
    servo_gain: tuple = (0.01, 0.0, 0.004)  # PID on pixel error


class MissionState(NamedTuple):
    phase: torch.Tensor          # int32 Phase
    wp_index: torch.Tensor       # int32
    ticks_in_phase: torch.Tensor
    align_streak: torch.Tensor   # consecutive centred ticks
    scan_leg: torch.Tensor       # 0 right2left, 1 forward, 2 left2right
    found_mask: torch.Tensor     # (K,) task ids collected so far
    pid_y: PIDState
    pid_z: PIDState


def mission_init(cfg: MissionConfig) -> MissionState:
    """The start state, on the device of ``cfg.waypoints``."""
    dev = cfg.waypoints.device
    pid = PIDController(*cfg.servo_gain)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    return MissionState(
        phase=i32(int(Phase.TAKEOFF)), wp_index=i32(0), ticks_in_phase=i32(0),
        align_streak=i32(0), scan_leg=i32(0),
        found_mask=torch.zeros(cfg.task_ids.shape, dtype=torch.bool, device=dev),
        pid_y=pid.init(device=dev), pid_z=pid.init(device=dev),
    )


def _goto(cfg, target, pos):
    d = target - pos
    dist = sqrt(sum_squares(d))
    v = d / torch.clamp(dist, min=1e-6) * torch.clamp(dist * 2.0, max=cfg.speed)
    return v, dist


def _vec(*xs, device) -> torch.Tensor:
    return torch.tensor(xs, dtype=torch.float32, device=device)


def mission_step(cfg: MissionConfig, state: MissionState, obs: Observation,
                 dt: float = 0.1) -> tuple[MissionState, Command]:
    """One control tick: collect task markers, run the phase's branch (picked
    on the host), advance the phase counters."""
    dev = cfg.waypoints.device
    pid = PIDController(*cfg.servo_gain)
    n_wp = cfg.waypoints.shape[0]
    pos = obs.position
    zero3 = torch.zeros(3, device=dev)
    i32 = lambda v: torch.tensor(int(v), dtype=torch.int32, device=dev)  # noqa: E731

    # collect any task markers seen this tick, in every phase
    seen = (cfg.task_ids[:, None] == obs.marker_ids[None, :]).any(dim=1)
    found_mask = state.found_mask | seen

    def takeoff(s):
        v = _vec(0.0, 0.0, 1.0, device=dev) * cfg.speed
        done = obs.altitude >= cfg.cruise_alt
        return torch.where(done, i32(Phase.NAV_WAYPOINT), i32(Phase.TAKEOFF)), v, s

    def nav(s):
        k = clip(s.wp_index, 0, n_wp - 1).long()
        v, dist = _goto(cfg, cfg.waypoints[k], pos)
        arrived = dist < cfg.wp_tol
        is_gate = cfg.gate_waypoint[k]
        last = s.wp_index >= n_wp - 1
        nxt = torch.where(arrived & is_gate, i32(Phase.SEARCH_GATE),
                          torch.where(arrived & last, i32(Phase.ARUCO_SCAN),
                                      i32(Phase.NAV_WAYPOINT)))
        s = s._replace(wp_index=torch.where(arrived & ~is_gate & ~last, s.wp_index + 1,
                                            s.wp_index))
        return nxt, torch.where(arrived, zero3, v), s

    def search(s):
        # lateral sweep until the ring detector fires, holding cruise altitude
        period = 2 * cfg.scan_ticks
        sweep = torch.where((s.ticks_in_phase % period) < cfg.scan_ticks,
                            torch.tensor(1.0, device=dev), torch.tensor(-1.0, device=dev))
        vz = clip(cfg.cruise_alt - obs.altitude, -1.0, 1.0) * cfg.speed
        v = _vec(0.0, 1.0, 0.0, device=dev) * sweep * cfg.speed * 0.5 \
            + _vec(0.0, 0.0, 1.0, device=dev) * vz
        hit = obs.ring_score > cfg.ring_score_min
        return torch.where(hit, i32(Phase.ALIGN_GATE), i32(Phase.SEARCH_GATE)), v, s

    def align(s):
        err = cfg.image_center - obs.ring_px  # (x, y) pixel error
        pid_y, vy = pid.step(s.pid_y, err[0], dt)
        pid_z, vz = pid.step(s.pid_z, err[1], dt)
        centered = torch.all(torch.abs(err) < cfg.align_tol_px)
        streak = torch.where(centered, s.align_streak + 1, i32(0))
        lost = obs.ring_score < cfg.ring_score_min
        s = s._replace(pid_y=pid_y, pid_z=pid_z, align_streak=streak)
        nxt = torch.where(streak >= cfg.align_ticks, i32(Phase.PASS_GATE),
                          torch.where(lost, i32(Phase.SEARCH_GATE), i32(Phase.ALIGN_GATE)))
        # image y grows downward: a gate above centre has pixel y < setpoint,
        # so a positive err[1] means climb (+z); err[0] likewise maps to +y
        return nxt, _vec(0.0, 1.0, 0.0, device=dev) * vy \
            + _vec(0.0, 0.0, 1.0, device=dev) * vz, s

    def dash_fixed(s):
        v = _vec(1.0, 0.0, 0.0, device=dev) * cfg.speed
        done = s.ticks_in_phase >= cfg.pass_ticks
        s = s._replace(wp_index=torch.where(done, s.wp_index + 1, s.wp_index),
                       align_streak=i32(0))
        all_done = s.wp_index >= n_wp
        nxt = torch.where(done, torch.where(all_done, i32(Phase.ARUCO_SCAN),
                                            i32(Phase.NAV_WAYPOINT)), i32(Phase.PASS_GATE))
        return nxt, v, s

    def scan(s):
        # the right2left / forward / left2right sweep
        leg_v = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], device=dev)
        v = leg_v[clip(s.scan_leg, 0, 2).long()] * cfg.speed * 0.5
        leg_done = s.ticks_in_phase >= (s.scan_leg + 1) * cfg.scan_ticks
        s = s._replace(scan_leg=torch.where(leg_done, s.scan_leg + 1, s.scan_leg))
        finished = (s.scan_leg > 2) | found_mask.all()
        return torch.where(finished, i32(Phase.PARK_SEARCH), i32(Phase.ARUCO_SCAN)), v, s

    def park_search(s):
        period = 2 * cfg.scan_ticks
        sweep = torch.where((s.ticks_in_phase % period) < cfg.scan_ticks,
                            torch.tensor(1.0, device=dev), torch.tensor(-1.0, device=dev))
        v = torch.stack([torch.tensor(0.3, device=dev), 1.0 * sweep,
                         torch.tensor(0.0, device=dev)]) * cfg.speed * 0.5
        return torch.where(obs.blob_found, i32(Phase.ALIGN_PARK), i32(Phase.PARK_SEARCH)), v, s

    def align_park(s):
        # below camera: image x ~ world y, image y ~ world x
        err = cfg.image_center - obs.blob_px
        pid_y, vy = pid.step(s.pid_y, err[0], dt)
        pid_z, vx = pid.step(s.pid_z, err[1], dt)
        centered = torch.all(torch.abs(err) < cfg.align_tol_px)
        streak = torch.where(centered, s.align_streak + 1, i32(0))
        s = s._replace(pid_y=pid_y, pid_z=pid_z, align_streak=streak)
        nxt = torch.where(streak >= cfg.align_ticks, i32(Phase.DESCEND),
                          torch.where(obs.blob_found, i32(Phase.ALIGN_PARK),
                                      i32(Phase.PARK_SEARCH)))
        return nxt, torch.stack([vx, vy, torch.zeros((), device=dev)]), s

    def descend(s):
        v = _vec(0.0, 0.0, -0.6, device=dev) * cfg.speed
        done = obs.altitude <= cfg.land_alt
        return torch.where(done, i32(Phase.LANDED), i32(Phase.DESCEND)), v, s

    def landed(s):
        return i32(Phase.LANDED), zero3, s

    branches = [takeoff, nav, search, align, dash_fixed, scan, park_search, align_park,
                descend, landed]
    nxt, v, state = branches[int(state.phase)](state)
    state = state._replace(
        phase=nxt.to(torch.int32), found_mask=found_mask,
        ticks_in_phase=torch.where(nxt == state.phase, state.ticks_in_phase + 1, i32(0)))
    return state, Command(v.to(torch.float32), torch.zeros((), device=dev))


def mission_rollout(cfg: MissionConfig, observe: Callable[[torch.Tensor], Observation],
                    n_steps: int, start, dt: float = 0.1):
    """Close the loop: integrate single-integrator dynamics against the
    observation function ``observe(position) -> Observation``. Returns
    (final_state, positions (T, 3), phases (T,)), on the config's device."""
    dev = cfg.waypoints.device
    state = mission_init(cfg)
    pos = as_f32(start, dev)
    dt_t = torch.tensor(dt, dtype=torch.float32, device=dev)
    traj, phases = [], []
    for _ in range(n_steps):
        state, cmd = mission_step(cfg, state, observe(pos), dt=dt)
        # the scan's body fuses the integration into one multiply-add
        pos = fma(cmd.velocity, dt_t, pos)
        traj.append(pos)
        phases.append(state.phase)
    return state, torch.stack(traj), torch.stack(phases)


def mission_config(waypoints, gate_waypoint, task_ids, image_center, device=None,
                   **kw) -> MissionConfig:
    """A `MissionConfig` with its arrays on ``device`` (float32 waypoints and
    setpoint, bool gate flags, int32 task ids)."""
    dev = resolve_device(device)
    return MissionConfig(
        waypoints=as_f32(waypoints, dev),
        gate_waypoint=torch.as_tensor(gate_waypoint, dtype=torch.bool, device=dev),
        task_ids=torch.as_tensor(task_ids, dtype=torch.int32, device=dev),
        image_center=as_f32(image_center, dev), **kw)

"""Occupancy mapping with free-space raycasting (port of
`tpu3drec/mapping/occupancy.py`).

Each ray (sensor origin -> hit) is sampled at sub-voxel spacing with a
static sample count and voxelized on the device; one sort of tagged packed
keys gives the scan's unique occupied and free voxels (occupied wins).
The map keeps its sorted packed keys and log-odds on the device, so a scan
copies nothing to the host: the occupied and free keys are compacted on
the device and merged there. Log-odds follow octomap's default sensor
model (hit 0.7, miss 0.4, clamp [0.1192, 0.971]). Export: occupied and
free leaves to `.bt` (free leaves use the 0b10 child code).

The float32 arithmetic that picks a voxel rounds as XLA's CPU compiler
does in the JAX package, so the `.bt` is byte-identical to it there:
``origin + u * s`` is one fused multiply-add, the ray length a sum of
squares with fused multiply-adds and a correctly rounded square root, and
a division by the (compile-time constant) resolution a multiplication by
its float32 reciprocal.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpu3drec_torch.core import fp
from tpu3drec_torch.mapping.voxel import KEY_OFFSET, _pack_keys, unique_voxels, voxelize
from tpu3drec_torch.utils.device import as_f32, resolve_device

# octomap defaults: p_hit=0.7, p_miss=0.4, clamp [0.1192, 0.971]
L_HIT = float(np.log(0.7 / 0.3))
L_MISS = float(np.log(0.4 / 0.6))
L_MIN = float(np.log(0.1192 / (1 - 0.1192)))
L_MAX = float(np.log(0.971 / (1 - 0.971)))

_INVALID = torch.iinfo(torch.int64).max


def _voxelize_static(points: torch.Tensor, res: float) -> torch.Tensor:
    """floor(p / res) for a resolution fixed at trace time in the JAX
    package: XLA folds the division by a constant into a multiplication by
    the float32 reciprocal, which rounds differently near key boundaries."""
    inv = 1.0 / torch.tensor(res, dtype=torch.float32, device=points.device)
    return torch.floor(points * inv).to(torch.int32)


def ray_free_voxels(origin: torch.Tensor, points: torch.Tensor, valid: torch.Tensor,
                    res: float, max_samples: int = 128):
    """Free-space voxel keys along each ray, excluding the endpoint voxel.

    Returns (keys (N*S, 3) int32, valid mask (N*S,)). Sample spacing is
    0.7*res (sub-voxel, so thin diagonal rays still mark every cell they
    dominate); samples stop half a voxel short of the hit."""
    dev = points.device
    d = points - origin
    length = fp.sqrt(fp.sum_squares(d))[:, None]
    u = d / torch.clamp(length, min=1e-9)
    s = (torch.arange(max_samples, dtype=torch.float32, device=dev) + 0.5) * \
        torch.tensor(0.7 * res, dtype=torch.float32, device=dev)
    pos = fp.fma(u[:, None, :], s[None, :, None], origin)   # (N, S, 3)
    ok = (s[None, :] < (length - torch.tensor(0.5 * res, dtype=torch.float32, device=dev))) \
        & valid[:, None]
    return _voxelize_static(pos.reshape(-1, 3), res), ok.reshape(-1)


def _decode(packed: torch.Tensor) -> torch.Tensor:
    """`voxel._pack_keys` words -> (M, 3) int32 signed keys."""
    return torch.stack([(packed & 0xFFFF) - KEY_OFFSET,
                        ((packed >> 16) & 0xFFFF) - KEY_OFFSET,
                        (packed >> 32) - KEY_OFFSET], dim=-1).to(torch.int32)


def scan_update(origin, points, valid, res: float, max_samples: int = 128):
    """One sensor scan -> deduplicated occupied + free voxel sets.

    Returns (keys (M, 3), occ_mask (M,), free_mask (M,)) with M = N*(S+1):
    unique occupied keys and unique free keys with the scan's occupied
    cells removed from the free set (octomap's computeUpdate: occupied
    wins).

    Tag sort: the packed key shifted left by one carries the tag in its low
    bit (0 occupied, 1 free), so one int64 sort orders rows by (key, tag),
    as the JAX package's three-key sort does, and the first row of each key
    is occupied if any row of that key is. Invalid rows sort last and
    decode to the keys the JAX package's all-ones words decode to."""
    occ_keys = _voxelize_static(points, res)
    free_keys, free_ok = ray_free_voxels(origin, points, valid, res, max_samples)
    keys_all = torch.cat([occ_keys, free_keys])
    valid_all = torch.cat([valid, free_ok])
    tag = torch.cat([torch.zeros(occ_keys.shape[0], dtype=torch.int64, device=points.device),
                     torch.ones(free_keys.shape[0], dtype=torch.int64, device=points.device)])
    word = torch.where(valid_all, (_pack_keys(keys_all) << 1) | tag,
                       torch.full_like(tag, _INVALID))
    sword, order = torch.sort(word)
    svalid = valid_all[order]
    spacked = sword >> 1
    first = torch.ones_like(svalid)
    first[1:] = spacked[1:] != spacked[:-1]
    stag = sword & 1
    occ_mask = first & svalid & (stag == 0)
    free_mask = first & svalid & (stag == 1)
    skeys = torch.where(svalid[:, None], _decode(spacked),
                        torch.tensor([0x7FFF, 0x7FFF, -1 - KEY_OFFSET], dtype=torch.int32,
                                     device=points.device))
    return skeys, occ_mask, free_mask


class OccupancyMap:
    """Persistent log-odds voxel map, kept on ``device`` as sorted packed
    keys (`voxel._pack_keys`) and float32 log-odds."""

    def __init__(self, res: float = 0.1, max_samples: int = 128, device=None):
        self.res = res
        self.max_samples = max_samples
        self.device = resolve_device(device)
        self._packed = torch.zeros((0,), dtype=torch.int64, device=self.device)
        self._logodds = torch.zeros((0,), dtype=torch.float32, device=self.device)

    def _scan(self, origin, points, valid, with_freespace: bool):
        """One scan's compacted new keys (packed) and their log-odds deltas,
        on the device."""
        points = as_f32(points, self.device)
        n = points.shape[0]
        if valid is None:
            valid = torch.ones((n,), dtype=torch.bool, device=self.device)
        else:
            valid = torch.as_tensor(valid, dtype=torch.bool, device=self.device)
        if with_freespace:
            skeys, m_occ, m_free = scan_update(as_f32(origin, self.device), points, valid,
                                               self.res, self.max_samples)
            occ, free = _pack_keys(skeys[m_occ]), _pack_keys(skeys[m_free])
            new = torch.cat([occ, free])
            delta = torch.cat([torch.full(occ.shape, L_HIT, device=self.device),
                               torch.full(free.shape, L_MISS, device=self.device)])
        else:
            # outside the scan's trace in the JAX package: a true division
            skeys, m_occ, _ = unique_voxels(voxelize(points, self.res), valid)
            new = _pack_keys(skeys[m_occ])
            delta = torch.full(new.shape, L_HIT, device=self.device)
        return new, delta

    def _merge(self, new: torch.Tensor, delta: torch.Tensor):
        """Add ``delta`` at the packed keys ``new`` and clamp. Each key occurs
        at most twice (the map's keys are unique, and one scan's occupied
        and free keys are unique and disjoint), so each sum is one float32
        addition, which no order changes: the JAX package's host merge
        gives the same bits."""
        keys = torch.cat([self._packed, new])
        vals = torch.cat([self._logodds, delta])
        if keys.numel() == 0:
            return
        skeys, order = torch.sort(keys)
        svals = vals[order]
        first = torch.ones_like(skeys, dtype=torch.bool)
        first[1:] = skeys[1:] != skeys[:-1]
        partner = torch.zeros_like(svals)
        partner[:-1] = torch.where(skeys[1:] == skeys[:-1], svals[1:], partner[:-1])
        summed = svals + partner
        lo = float(np.float32(L_MIN))
        hi = float(np.float32(L_MAX))
        self._packed = skeys[first]
        self._logodds = torch.clamp(summed[first], min=lo, max=hi)

    def insert_scan(self, origin, points, valid=None, with_freespace: bool = True):
        """Integrate one scan: keys, compaction and merge on the device."""
        self._merge(*self._scan(origin, points, valid, with_freespace))

    @property
    def keys(self) -> np.ndarray:
        """(M, 3) int32 keys, sorted by (z, y, x)."""
        return _decode(self._packed).cpu().numpy()

    @property
    def logodds(self) -> np.ndarray:
        return self._logodds.cpu().numpy()

    def counts(self) -> tuple[int, int, int]:
        """(voxels, occupied, free), in one read from the device."""
        c = torch.stack([torch.tensor(self._packed.numel(), device=self.device),
                         (self._logodds > 0.0).sum(), (self._logodds < 0.0).sum()])
        return tuple(int(v) for v in c.cpu())

    def occupied_keys(self) -> np.ndarray:
        return _decode(self._packed[self._logodds > 0.0]).cpu().numpy()

    def free_keys(self) -> np.ndarray:
        return _decode(self._packed[self._logodds < 0.0]).cpu().numpy()

    def write_bt(self, path: str) -> int:
        """Occupied and free leaves -> `.bt` through the native library
        (bytes equal to the Python writer's). Returns the node count."""
        from tpu3drec_torch.utils import native

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        return native.bt_write_keys(path, self.occupied_keys(), self.res,
                                    free_keys=self.free_keys())

"""Device-side voxelization and dedup (port of `tpu3drec/mapping/voxel.py`).

Points -> integer voxel keys -> one sort of packed keys -> first-occurrence
mask, all on the device with static shapes. `dedup_voxels_host` compacts
the unique keys on the device too and copies only them to the host.

Key convention matches octomap depth-16 trees: ``k = floor(p / res)`` stored
signed; the `.bt` writer adds the 2^15 offset (see `mapping/btio.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3drec_torch.utils.device import as_f32, resolve_device

# octomap key offset for depth-16 trees: coordToKey adds tree_max_val = 2^15.
KEY_OFFSET = 1 << 15
_INVALID = torch.iinfo(torch.int64).max


def voxelize(points: torch.Tensor, res) -> torch.Tensor:
    """World points (N, 3) -> signed int32 voxel keys (N, 3): floor(p/res)."""
    res = torch.as_tensor(res, dtype=points.dtype, device=points.device)
    return torch.floor(points / res).to(torch.int32)


def _pack_keys(keys: torch.Tensor) -> torch.Tensor:
    """(N, 3) int32 keys in the 16-bit range (after the offset) -> one int64
    sort key z<<32 | y<<16 | x, the JAX package's (hi, lo) uint32 pair in one
    word: the same order."""
    k = keys.to(torch.int64) + KEY_OFFSET
    return (k[:, 2] << 32) | (k[:, 1] << 16) | k[:, 0]


def unique_voxels(keys: torch.Tensor, valid: torch.Tensor):
    """Sort voxel keys and flag first occurrences.

    Args:
      keys: (N, 3) int32 voxel keys, each within [-2^15, 2^15).
      valid: (N,) bool; invalid entries sort to the end and are masked out.

    Returns:
      sorted_keys: (N, 3) int32, the valid keys in sorted order first; the
        rows after them (invalid entries) hold no key.
      unique_mask: (N,) bool, True at the first occurrence of each valid key.
      count: () int32 number of unique valid voxels.
    """
    packed = _pack_keys(keys)
    packed = torch.where(valid, packed, torch.full_like(packed, _INVALID))
    spacked, order = torch.sort(packed)
    svalid = valid[order]
    skeys = torch.stack(
        [
            (spacked & 0xFFFF) - KEY_OFFSET,
            ((spacked >> 16) & 0xFFFF) - KEY_OFFSET,
            ((spacked >> 32) & 0xFFFF) - KEY_OFFSET,
        ],
        dim=-1,
    ).to(torch.int32)
    first = torch.ones_like(svalid)
    first[1:] = spacked[1:] != spacked[:-1]
    unique_mask = first & svalid
    return skeys, unique_mask, unique_mask.sum(dtype=torch.int32)


def voxel_centers(keys: torch.Tensor, res) -> torch.Tensor:
    """Voxel keys -> center coordinates: (k + 0.5) * res."""
    return (keys.to(torch.float32) + 0.5) * res


def dedup_voxels_host(points, res: float, valid=None, device=None) -> np.ndarray:
    """Points -> compact (M, 3) int32 unique voxel keys on the host. The
    device does voxelize + sort + mask and the boolean gather; only the M
    unique keys are copied to the host."""
    dev = resolve_device(device)
    points = as_f32(points, dev)
    if valid is None:
        valid = torch.ones((points.shape[0],), dtype=torch.bool, device=dev)
    else:
        valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    skeys, mask, _ = unique_voxels(voxelize(points, res), valid)
    return skeys[mask].cpu().numpy()

"""Ring collectives over sharded point buffers (port of
`tpu3drec/parallel/ring.py`).

Nearest-neighbour search for ICP runs as a ring over the mesh's ``space``
axis: each step every rank searches its resident reference shard, then
passes the shard to the next rank of the ring (`parallel/mesh.py::
ppermute`); after D steps every query has seen every reference point, and
a rank holds 1/D of the reference cloud at a time. The local search is
`sfm/icp.py::nearest_neighbors`: the ICP-NN kernel on the card, one launch
a step, and its plain version on the CPU.
"""

from __future__ import annotations

import torch

from tpu3drec_torch.mapping.voxel import _pack_keys
from tpu3drec_torch.parallel.mesh import Mesh, all_gather, all_reduce, ppermute
from tpu3drec_torch.sfm.icp import nearest_neighbors

_SENTINEL = torch.iinfo(torch.int64).max


def ring_nearest_neighbors(query: torch.Tensor, ref: torch.Tensor, mesh: Mesh,
                           axis: str = "space"):
    """Global NN search with both clouds sharded: ``query`` (nq, 3) and
    ``ref`` (nr, 3) are this rank's shards (every rank's ``ref`` shard of
    one size). Returns (idx (nq,) int32 into the global ref array, d2 (nq,))
    for this rank's queries.

    The merge keeps the earlier answer unless a later shard is strictly
    closer, in ring order (this rank's own shard first): on an exact tie
    across shards a rank keeps the shard it visited first, which on ranks
    > 0 is not the lowest global index, as in the reference."""
    D = mesh.axis_size(axis)
    my = mesh.axis_index(axis)
    nr = ref.shape[0]
    best_d = torch.full((query.shape[0],), float("inf"), dtype=query.dtype, device=query.device)
    best_i = torch.zeros(query.shape[0], dtype=torch.int32, device=query.device)
    r_cur = ref.contiguous()
    for k in range(D):
        src = (my - k) % D  # the rank r_cur came from
        idx, d = nearest_neighbors(query.contiguous(), r_cur)
        take = d < best_d
        best_d = torch.where(take, d, best_d)
        best_i = torch.where(take, idx.to(torch.int32) + src * nr, best_i)
        if k + 1 < D:
            r_cur = ppermute(mesh, r_cur, axis)
    return best_i, best_d


def sharded_voxel_count(keys: torch.Tensor, valid: torch.Tensor, mesh: Mesh,
                        axis: str = "space") -> torch.Tensor:
    """Global unique-voxel count with the point buffer sharded: ``keys``
    (n, 3) int32 and ``valid`` (n,) bool are this rank's shard (every
    rank's of one size). Each rank dedups its shard, the ranks exchange
    their unique key sets by one equal-shape all-gather, and a key shared
    across ranks counts only on the lowest rank that holds it. Returns the
    count (a 0-dim int64 tensor) on every rank."""
    packed = torch.where(valid, _pack_keys(keys), _SENTINEL)
    s, _ = torch.sort(packed)
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    mine = torch.where(first & (s != _SENTINEL), s, _SENTINEL)  # sorted unique keys
    all_keys = all_gather(mesh, mine, axis)                      # (D, n)
    my = mesh.axis_index(axis)
    stolen = torch.zeros_like(first)
    for j in range(my):  # lower ranks own what they share with this one
        other = torch.sort(all_keys[j]).values
        pos = torch.searchsorted(other, mine).clamp_max(other.shape[0] - 1)
        stolen |= other[pos] == mine
    count = torch.sum((mine != _SENTINEL) & ~stolen).to(torch.int64)
    return all_reduce(mesh, count.reshape(1), axis)[0]

"""Process mesh, sharding helpers and the one transfer helper (port of
`tpu3drec/parallel/mesh.py`).

Axes, as in the reference:

  data   frame/batch parallelism (depth-net batches, frame-parallel fusion)
  space  point-block / map-shard parallelism (ring NN search, BA shards)
  model  tensor parallelism (`parallel/tp.py`)

Where the JAX package lays devices out in a `jax.sharding.Mesh` and lets
XLA place its collectives, the port's ranks are processes of one
`torch.distributed` world, one per device: a rank's device is
``cuda:(local_rank % device_count)`` (every rank on ``cuda:0`` with one
card), or what ``device`` says (the CPU tests pass ``"cpu"``). `make_mesh`
lays the world's ranks out in a (data, space, model) grid as the
reference does and builds one process group per axis and per slice of
that axis. A rank holds only its own shard: there is no global array.
`shard_batch` returns this rank's contiguous block of an array every rank
has, `replicate` the whole array, on the mesh's device.

Every transfer between ranks goes through this module: `all_reduce`,
`all_gather` (equal shapes), `ppermute` (to the next rank of an axis) and
`barrier`, plus `all_reduce_grad`, an all-reduce that autograd goes
through. The staging is chosen by the group's backend, never by catching
an error: gloo takes host tensors, so a CUDA tensor is copied to host
memory, exchanged there and copied back, and the bytes so staged are
counted in `staged_bytes`. NCCL takes the device tensor as it is; it joins
ranks that each have a card of their own.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

MESH_AXES = ("data", "space", "model")

# Bytes of the CUDA tensors each collective handed to gloo through host
# memory (a rank's own input, copied out and its result copied back), since
# the last `reset_staged`.
staged_bytes: dict[str, int] = {}


def reset_staged() -> None:
    staged_bytes.clear()


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_device(device=None) -> torch.device:
    """This rank's device: ``device`` when given, else
    ``cuda:(local_rank % device_count)`` (``LOCAL_RANK`` from the
    environment, else the global rank); without a card it raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    local = int(os.environ.get("LOCAL_RANK", _world()[0]))
    return torch.device("cuda", local % torch.cuda.device_count())


@dataclass
class Mesh:
    """This rank's view of a (data, space, model) layout of the world's
    ranks: the axis sizes, its coordinates, and per axis the process group
    and the global ranks of its slice (None for an axis of size 1)."""

    shape: dict
    coords: dict
    device: torch.device
    groups: dict = field(default_factory=dict)
    ranks: dict = field(default_factory=dict)

    def axis_size(self, axis) -> int:
        return int(np.prod([self.shape[a] for a in _axes(axis)]))

    def axis_index(self, axis) -> int:
        """This rank's index along ``axis`` (a name or a tuple of names,
        major first)."""
        i = 0
        for a in _axes(axis):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axis):
        return self.groups[_key(axis)]

    def axis_ranks(self, axis) -> list[int]:
        return self.ranks[_key(axis)]


def _axes(axis) -> tuple:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _key(axis):
    a = _axes(axis)
    return a[0] if len(a) == 1 else a


def make_mesh(data: int = 0, space: int = 1, model: int = 1, device=None,
              axis_groups=()) -> Mesh:
    """Lay the world's ranks out as a (data, space, model) mesh. ``data=0``
    means "all remaining ranks on the data axis". One process group is made
    per axis and per slice of it; ``axis_groups`` names tuples of axes that
    also get groups (a tuple reduces over the ranks of all its axes, as a
    tuple axis does in the reference). Every rank must call this with the
    same arguments, as `torch.distributed.new_group` requires."""
    rank, n = _world()
    if data == 0:
        if n % (space * model):
            raise ValueError(f"{n} devices not divisible by space*model={space*model}")
        data = n // (space * model)
    use = data * space * model
    if use > n:
        raise ValueError(f"mesh {data}x{space}x{model} needs {use} devices, have {n}")
    if rank >= use:
        raise ValueError(f"rank {rank} lies outside the {data}x{space}x{model} mesh")
    grid = np.arange(use).reshape(data, space, model)
    shape = dict(zip(MESH_AXES, (data, space, model)))
    coords = dict(zip(MESH_AXES, (int(c) for c in np.argwhere(grid == rank)[0])))
    mesh = Mesh(shape=shape, coords=coords, device=local_device(device))
    for axis in list(MESH_AXES) + [tuple(g) for g in axis_groups]:
        dims = [MESH_AXES.index(a) for a in _axes(axis)]
        rest = [d for d in range(3) if d not in dims]
        # (slices, members): the grid with the axis's dims last, flattened
        slices = np.transpose(grid, rest + dims).reshape(
            -1, int(np.prod([grid.shape[d] for d in dims])))
        for members in slices:
            members = [int(r) for r in members]
            # every rank takes part in every new_group call, in one order
            g = dist.new_group(members) if len(members) > 1 else None
            if rank in members:
                mesh.groups[_key(axis)] = g
                mesh.ranks[_key(axis)] = members
    return mesh


def shard_batch(mesh: Mesh, x, axis: str = "data") -> torch.Tensor:
    """This rank's contiguous block of ``x`` (an array every rank holds) on
    the mesh's device: the leading dim split evenly over ``axis`` (padding
    is the caller's job, as in the reference)."""
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    n = mesh.axis_size(axis)
    if x.shape[0] % n:
        raise ValueError(f"leading dim {x.shape[0]} does not divide over {n} shards")
    m = x.shape[0] // n
    i = mesh.axis_index(axis)
    return x[i * m:(i + 1) * m].to(mesh.device)


def replicate(mesh: Mesh, x) -> torch.Tensor:
    """The whole of ``x`` on the mesh's device."""
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    return x.to(mesh.device)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0, fill=0):
    """Pad axis 0 length to a multiple (static-shape sharding requirement).
    Returns (padded, original_length)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, rem)
    return np.pad(x, widths, constant_values=fill), n


# ---------------------------------------------------------------------------
# the transfer helper
# ---------------------------------------------------------------------------


def _staged(op: str, group, x: torch.Tensor) -> torch.Tensor:
    """The tensor the collective is given: a host copy of a CUDA tensor
    under gloo (counted in `staged_bytes`), else ``x`` (a copy for the
    in-place all-reduce)."""
    if x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO:
        staged_bytes[op] = staged_bytes.get(op, 0) + x.numel() * x.element_size()
        return x.detach().to("cpu", copy=True)
    return x.detach().clone() if op == "all_reduce" else x.detach()


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def all_reduce(mesh: Mesh, x: torch.Tensor, axis, op: str = "sum") -> torch.Tensor:
    """The reduction of ``x`` over the ranks of ``axis``, on every one of
    them (a new tensor on ``x``'s device; ``x`` itself when the axis has
    one rank)."""
    group = mesh.group(axis)
    if group is None:
        return x
    buf = _staged("all_reduce", group, x.contiguous())
    dist.all_reduce(buf, op=_OPS[op], group=group)
    return buf.to(x.device)


def all_gather(mesh: Mesh, x: torch.Tensor, axis) -> torch.Tensor:
    """Every rank's ``x`` (all of one shape) stacked in axis order:
    (axis size, *x.shape) on ``x``'s device."""
    group = mesh.group(axis)
    if group is None:
        return x[None]
    buf = _staged("all_gather", group, x.contiguous())
    out = [torch.empty_like(buf) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(out, buf, group=group)
    return torch.stack(out).to(x.device)


def ppermute(mesh: Mesh, x: torch.Tensor, axis, shift: int = 1) -> torch.Tensor:
    """Send ``x`` to the rank ``shift`` places on along ``axis`` (cyclic)
    and return what the rank ``shift`` places back sent. The send and the
    receive are posted together, so a ring of them cannot deadlock."""
    group = mesh.group(axis)
    if group is None:
        return x
    members = mesh.axis_ranks(axis)
    i, d = mesh.axis_index(axis), len(members)
    buf = _staged("ppermute", group, x.contiguous())
    out = torch.empty_like(buf)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, buf, members[(i + shift) % d], group),
        dist.P2POp(dist.irecv, out, members[(i - shift) % d], group),
    ])
    for r in reqs:
        r.wait()
    return out.to(x.device)


def barrier(mesh: Mesh | None = None, axis=None) -> None:
    """Wait until every rank of ``axis`` is here (default: the world)."""
    if _world()[1] <= 1:
        return
    group = dist.group.WORLD if axis is None else mesh.group(axis)
    if group is not None:
        dist.barrier(group=group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over an axis whose backward is the sum of the ranks' incoming
    gradients: every rank's output depends on every rank's input."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce(mesh, x, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(ctx.mesh, g.contiguous(), ctx.axis), None, None


def all_reduce_grad(mesh: Mesh, x: torch.Tensor, axis) -> torch.Tensor:
    """`all_reduce` (sum) that autograd differentiates."""
    if mesh.group(axis) is None:
        return x
    return _AllReduceSum.apply(x, mesh, axis)

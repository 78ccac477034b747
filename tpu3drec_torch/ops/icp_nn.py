"""ICP nearest-neighbour search: the CUDA kernel `csrc/icp_nn.cu` and its
plain PyTorch version (port of `tpu3drec/ops/icp_nn.py`).

For each query point, the index and squared distance of the nearest
reference point, by direct differences, ties to the first index. On a CUDA
tensor `nearest_neighbors_cuda` launches the kernel or raises. The kernel
cuts the references into the splits of `split_plan` (planned here, so the
CPU tests reach it) and merges the splits' answers by the minimum of
`pack_key` (bits(d2) << 32 | idx), which gives the unsplit answer. On a CPU
tensor `sfm/icp.py::nearest_neighbors` runs `nearest_neighbors_plain`,
which is also what the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes

import torch

# Kernel launches since the last reset: chip_smoke.py reads it to show that
# the main path went through the kernel.
launches = 0

_BEST_INIT = 1e30  # the running minimum's start, as in the TPU kernel


def reset_launches() -> None:
    global launches
    launches = 0


def _check(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"{name} must be a float32 (N, 3) tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# The kernel's layout (csrc/icp_nn.cu): queries per block, references per
# min-then-scan group, and the most reference splits the plan considers.
Q_PER_BLOCK = 512
GROUP = 8
MAX_SPLITS = 64
# A block's fixed cost (loading its queries, its atomics), counted in
# references scanned, for the split plan's cost model.
BLOCK_OVERHEAD = 64


def pack_key(d2: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel's merge key, bits(d2) << 32 | idx, as int64: for d2 >= 0
    (and <= 1e30) it orders as (d2, idx) does, and it is never negative."""
    bits = d2.to(torch.float32).view(torch.int32).to(torch.int64)
    return (bits << 32) | idx.to(torch.int64)


def unpack_key(key: torch.Tensor):
    """(idx int32, d2 float32) from `pack_key`'s keys."""
    idx = (key & 0xFFFFFFFF).to(torch.int32)
    d2 = (key >> 32).to(torch.int32).view(torch.float32)
    return idx, d2


KEY_INIT = int(pack_key(torch.tensor([_BEST_INIT]), torch.tensor([0]))[0])


def split_plan(nq: int, nr: int, sms: int, blocks_per_sm: int) -> tuple[int, int]:
    """(splits, chunk): the references are cut into `splits` contiguous runs
    of `chunk` (a multiple of GROUP; the last run may be shorter), one per
    grid row. The count is the one that makes the slowest SM's work least
    when (query blocks x splits) blocks fill `sms * blocks_per_sm` slots a
    wave at a time, each block costing `chunk + BLOCK_OVERHEAD`; among
    equals, the fewest splits."""
    if nq <= 0 or nr <= 0 or sms <= 0 or blocks_per_sm <= 0:
        raise ValueError(f"no plan for nq={nq} nr={nr} sms={sms} blocks_per_sm={blocks_per_sm}")
    qblocks = -(-nq // Q_PER_BLOCK)
    slots = sms * blocks_per_sm
    best = None
    for s in range(1, min(MAX_SPLITS, -(-nr // GROUP)) + 1):
        chunk = -(-nr // s)
        chunk = -(-chunk // GROUP) * GROUP  # whole groups
        splits = -(-nr // chunk)
        cost = -(-qblocks * splits // slots) * (chunk + BLOCK_OVERHEAD)
        if best is None or cost < best[0]:
            best = (cost, splits, chunk)
    return best[1], best[2]


def launch_plan(nq: int, nr: int, device: torch.device) -> tuple[int, int]:
    """`split_plan` for the card `device`: its SM count and the blocks of
    the kernel that one SM holds there."""
    from tpu3drec_torch.ops.build import blocks_per_sm

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return split_plan(nq, nr, sms, blocks_per_sm("icp_nn", device))


def nearest_neighbors_cuda(query: torch.Tensor, ref: torch.Tensor):
    """Launch the kernel: (idx (Nq,) int32, d2 (Nq,) float32)."""
    global launches
    _check("query", query)
    _check("ref", ref)
    if query.device.type != "cuda" or ref.device != query.device:
        raise ValueError("nearest_neighbors_cuda takes two CUDA tensors on one device, "
                         f"got {query.device} and {ref.device}")
    nq, nr = query.shape[0], ref.shape[0]
    if nr == 0:
        raise ValueError("reference set is empty")
    if max(nq, 3 * nr) >= 2**31:
        raise ValueError(f"too many points for int32 indexing: {nq} x {nr}")
    from tpu3drec_torch.ops.build import load

    fn = load("icp_nn").tpu3drec_icp_nn
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(query.device):
        splits, chunk = launch_plan(max(nq, 1), nr, query.device)
        rt = ref.t().contiguous()  # (3, Nr): one plane per coordinate
        keys = torch.full((nq,), KEY_INIT, dtype=torch.int64, device=query.device)
        idx = torch.empty((nq,), dtype=torch.int32, device=query.device)
        d2 = torch.empty((nq,), dtype=torch.float32, device=query.device)
        stream = torch.cuda.current_stream(query.device).cuda_stream
        rc = fn(query.data_ptr(), rt.data_ptr(), nq, nr, splits, chunk, keys.data_ptr(),
                idx.data_ptr(), d2.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"icp_nn kernel launch failed: cudaError {rc}")
    launches += 1
    return idx, d2


def nearest_neighbors_plain(query: torch.Tensor, ref: torch.Tensor, block: int = 1024):
    """Plain PyTorch version of the kernel: a running min/argmin over
    reference blocks, with the kernel's arithmetic (each product and sum
    rounded on its own) and first-index ties."""
    nq, nr = query.shape[0], ref.shape[0]
    if nr == 0:
        raise ValueError("reference set is empty")
    best_d = torch.full((nq,), _BEST_INIT, dtype=torch.float32, device=query.device)
    best_i = torch.zeros((nq,), dtype=torch.int32, device=query.device)
    qx, qy, qz = (query[:, k:k + 1] for k in range(3))
    for s in range(0, nr, block):
        r = ref[s:s + block]
        dx = qx - r[:, 0]
        dy = qy - r[:, 1]
        dz = qz - r[:, 2]
        d = dx * dx + dy * dy + dz * dz  # (Nq, block)
        dmin = d.min(dim=1).values
        iota = torch.arange(s, s + r.shape[0], dtype=torch.int32, device=query.device)
        amin = torch.where(d == dmin[:, None], iota, torch.iinfo(torch.int32).max).min(dim=1).values
        take = dmin < best_d
        best_d = torch.where(take, dmin, best_d)
        best_i = torch.where(take, amin, best_i)
    return best_i, best_d


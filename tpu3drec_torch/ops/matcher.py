"""Descriptor matcher: the CUDA kernel `csrc/matcher.cu` and its plain
PyTorch version (port of `tpu3drec/ops/matcher.py`).

For each query descriptor, the index of the best valid reference and the
top-1 and top-2 dot-product similarities, without a stored Ka x Kb score
matrix. Invalid references score -3.0; the running state starts at
(index 0, -3, -3); ties go to the first index; a duplicated maximum lifts
s2 to s1. `topk2_scores` and `topk2_scores_batched` launch the kernel on
CUDA tensors (or raise) and run the plain version on CPU tensors. The
plain version sums each score over d in the kernel's order, each product
and sum rounded on its own, so the two agree bit for bit. The kernel cuts
the references into the splits of `split_plan` (planned here, so the CPU
tests reach it) and merges the splits' states by `merge_top2`'s rule.
"""

from __future__ import annotations

import ctypes

import torch

# Kernel launches since the last reset: chip_smoke.py reads it to show that
# the main path went through the kernel.
launches = 0

TILE_B = 2048  # the reference tile of the TPU kernel's running merge
INVALID = -3.0  # the score of an invalid reference (similarities lie in [-1, 1])


def reset_launches() -> None:
    global launches
    launches = 0


def _check(desc_a, desc_b, valid_b):
    if desc_a.dtype != torch.float32 or desc_b.dtype != torch.float32:
        raise ValueError(f"descriptors must be float32, got {desc_a.dtype}, {desc_b.dtype}")
    if desc_a.ndim != 3 or desc_b.ndim != 3 or valid_b.ndim != 2:
        raise ValueError("expected desc_a (P, Ka, D), desc_b (P, Kb, D), valid_b (P, Kb), got "
                         f"{tuple(desc_a.shape)}, {tuple(desc_b.shape)}, {tuple(valid_b.shape)}")
    P, _, D = desc_a.shape
    if desc_b.shape[0] != P or desc_b.shape[2] != D or tuple(valid_b.shape) != desc_b.shape[:2]:
        raise ValueError(f"shapes disagree: {tuple(desc_a.shape)}, {tuple(desc_b.shape)}, "
                         f"{tuple(valid_b.shape)}")
    if not (desc_a.device == desc_b.device == valid_b.device):
        raise ValueError(f"tensors on different devices: {desc_a.device}, {desc_b.device}, "
                         f"{valid_b.device}")


# The kernel's tiles (csrc/matcher.cu): queries per block, references per
# tile; a split of the references is a whole number of tiles.
TILE_Q = 128
TILE_R = 128


def split_plan(P: int, Ka: int, Kb: int, sms: int, blocks_per_sm: int) -> tuple[int, int]:
    """(splits, split_refs): the references of each pair are cut into
    `splits` contiguous runs of `split_refs` (a multiple of TILE_R; the last
    run may be shorter), one per grid row. The count is the one that makes
    the slowest SM's work least when the P x (query tiles) x splits blocks
    fill `sms * blocks_per_sm` slots a wave at a time; among equals, the
    fewest splits."""
    if P <= 0 or Ka <= 0 or Kb < 0 or sms <= 0 or blocks_per_sm <= 0:
        raise ValueError(f"no plan for P={P} Ka={Ka} Kb={Kb} sms={sms} "
                         f"blocks_per_sm={blocks_per_sm}")
    qtiles = -(-Ka // TILE_Q)
    rtiles = -(-Kb // TILE_R)
    slots = sms * blocks_per_sm
    best = (None, 1, TILE_R)  # Kb == 0: one empty split
    for s in range(1, rtiles + 1):
        per = -(-rtiles // s)
        splits = -(-rtiles // per)
        cost = -(-P * qtiles * splits // slots) * per
        if best[0] is None or cost < best[0]:
            best = (cost, splits, per * TILE_R)
    return best[1], best[2]


def launch_plan(P: int, Ka: int, Kb: int, device: torch.device) -> tuple[int, int]:
    """`split_plan` for the card `device`: its SM count and the blocks of
    the kernel that one SM holds there."""
    from tpu3drec_torch.ops.build import blocks_per_sm

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return split_plan(P, Ka, Kb, sms, blocks_per_sm("matcher", device))


def topk2_scores_batched_cuda(desc_a, desc_b, valid_b):
    """Launch the kernel: (best (P, Ka) int32, top2 (P, Ka, 2) float32)."""
    global launches
    _check(desc_a, desc_b, valid_b)
    if desc_a.device.type != "cuda":
        raise ValueError(f"topk2_scores_batched_cuda takes CUDA tensors, got {desc_a.device}")
    P, Ka, D = desc_a.shape
    Kb = desc_b.shape[1]
    if P > 65535 or max(Ka, Kb) * D >= 2**31 or P * Ka >= 2**31:
        raise ValueError(f"too large for the kernel's indexing: P={P} Ka={Ka} Kb={Kb} D={D}")
    from tpu3drec_torch.ops.build import load

    fn = load("matcher").tpu3drec_matcher
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = desc_a.device
    with torch.cuda.device(dev):
        splits, split_refs = launch_plan(P, max(Ka, 1), Kb, dev)
        a = desc_a.contiguous()
        b = desc_b.contiguous()
        v = valid_b.to(torch.uint8).contiguous()
        best = torch.empty((P, Ka), dtype=torch.int32, device=dev)
        top2 = torch.empty((P, Ka, 2), dtype=torch.float32, device=dev)
        part_i = part_s = None
        if splits > 1:  # the splits' states, for the kernel's merge pass
            part_i = torch.empty((splits, P, Ka), dtype=torch.int32, device=dev)
            part_s = torch.empty((splits, P, Ka, 2), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), v.data_ptr(), P, Ka, Kb, D, splits, split_refs,
                None if part_i is None else part_i.data_ptr(),
                None if part_s is None else part_s.data_ptr(),
                best.data_ptr(), top2.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"matcher kernel launch failed: cudaError {rc}")
    launches += 1
    return best, top2


def merge_top2(prev_i1, prev_s1, prev_s2, i1, s1, s2):
    """Union of two disjoint candidate sets, the kernel's merge: the larger
    s1 wins, the lower index on equal scores (in any order of merging, the
    answer of one pass over both sets)."""
    better = (s1 > prev_s1) | ((s1 == prev_s1) & (i1 < prev_i1))
    m_i1 = torch.where(better, i1, prev_i1)
    m_s1 = torch.maximum(s1, prev_s1)
    m_s2 = torch.maximum(torch.minimum(s1, prev_s1), torch.maximum(s2, prev_s2))
    return m_i1, m_s1, m_s2


def topk2_scores_batched_plain(desc_a, desc_b, valid_b, tile_b: int = TILE_B):
    """Plain PyTorch version of the kernel, with its arithmetic: scores
    summed over d in order from 0, each product and sum rounded on its own;
    a running top-2 merge over reference tiles from the state (0, -3, -3)."""
    _check(desc_a, desc_b, valid_b)
    P, Ka, D = desc_a.shape
    Kb = desc_b.shape[1]
    dev = desc_a.device
    best = torch.zeros((P, Ka), dtype=torch.int64, device=dev)
    s1 = torch.full((P, Ka), INVALID, dtype=torch.float32, device=dev)
    s2 = torch.full((P, Ka), INVALID, dtype=torch.float32, device=dev)
    for r0 in range(0, Kb, tile_b):
        b = desc_b[:, r0:r0 + tile_b]
        s = torch.zeros((P, Ka, b.shape[1]), dtype=torch.float32, device=dev)
        for d in range(D):
            s = s + desc_a[:, :, d:d + 1] * b[:, None, :, d]
        s = torch.where(valid_b[:, None, r0:r0 + tile_b].bool(), s, INVALID)
        # the tile's (first argmax, max, runner-up), with the state's start
        # value -3 standing in front of the tile as a candidate at index 0
        t1 = s.max(dim=2).values
        cols = torch.arange(b.shape[1], device=dev)
        ti = torch.where(s == t1[..., None], cols, b.shape[1]).min(dim=2).values
        t2 = torch.where(cols == ti[..., None], INVALID, s).max(dim=2).values
        best, s1, s2 = merge_top2(best, s1, s2, ti + r0, t1, t2)
    return best.to(torch.int32), torch.stack([s1, s2], dim=-1)


def topk2_scores_batched(desc_a, desc_b, valid_b):
    """Many-pair matcher: desc_a (P, Ka, D), desc_b (P, Kb, D), valid_b
    (P, Kb) -> best (P, Ka) int32, top2 (P, Ka, 2). The kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if desc_a.device.type == "cuda":
        return topk2_scores_batched_cuda(desc_a, desc_b, valid_b)
    return topk2_scores_batched_plain(desc_a, desc_b, valid_b)


def topk2_scores(desc_a, desc_b, valid_b):
    """One pair: desc_a (Ka, D), desc_b (Kb, D), valid_b (Kb,) -> best
    (Ka,) int32, top2 (Ka, 2). The same kernel with P = 1."""
    best, top2 = topk2_scores_batched(desc_a[None], desc_b[None], valid_b[None])
    return best[0], top2[0]


def topk2_scores_plain(desc_a, desc_b, valid_b):
    """Plain version of `topk2_scores` (one pair)."""
    best, top2 = topk2_scores_batched_plain(desc_a[None], desc_b[None], valid_b[None])
    return best[0], top2[0]

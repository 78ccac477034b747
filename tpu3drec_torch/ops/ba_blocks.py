"""Bundle-adjustment block assembly: the CUDA kernel `csrc/ba_blocks.cu`
and its plain PyTorch version (port of `tpu3drec/ops/ba_blocks.py`).

Per observation: the reprojection residual (z clamped at 1e-9), the
closed-form Jacobians in the local (left-multiplicative) se(3)
parameterisation, J_cam = dproj/dXc [-[Xc]_x | I] and J_pt = dproj/dXc R,
and the weighted blocks

    U = w Jc^T Jc (6x6)   V = w Jp^T Jp (3x3)   W = w Jc^T Jp (6x3)
    bc = -w Jc^T r        bp = -w Jp^T r

plus the raw Jacobian rows. `ba_blocks` launches the kernel on CUDA tensors
(or raises) and runs `ba_blocks_plain` on CPU tensors; the plain version
evaluates every expression in the kernel's order, each operation rounded on
its own, so the two agree bit for bit. `local_jacobians_reference` is the
autodiff oracle for the closed forms.
"""

from __future__ import annotations

import ctypes

import torch

from tpu3drec_torch.utils.device import FORWARD_AD_LOCK

# Runs of the kernel since the last reset: chip_smoke.py reads it to show that
# the main path went through the kernel. A launch recorded into a CUDA graph
# runs nothing then and counts in ``captured`` instead; whoever replays the
# graph adds its launches here once a replay (`add_launches`); chip_smoke.py
# holds the count against the kernel's runs in a profiler trace.
launches = 0
captured = 0

_KEYS = ("res", "U", "V", "W", "bc", "bp", "Jc", "Jp")
_WIDTHS = (2, 36, 9, 18, 6, 3, 12, 6)
_SHAPES = ((2,), (6, 6), (3, 3), (6, 3), (6,), (3,), (2, 6), (2, 3))


def reset_launches() -> None:
    global launches
    launches = 0


def add_launches(n: int) -> None:
    """Counts ``n`` runs of the kernel made by replaying a CUDA graph."""
    global launches
    launches += n


def intrinsics_of(K) -> tuple[float, float, float, float]:
    """(fx, fy, cx, cy) as Python floats from a 3x3 intrinsics matrix (a
    host read when K lies on the card: callers do it once, outside loops)."""
    K = torch.as_tensor(K).detach().cpu()
    return float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])


def _check(Xc, Rmat, uv, w):
    O = Xc.shape[0]
    want = {"Xc": (Xc, (O, 3)), "Rmat": (Rmat, (O, 3, 3)), "uv": (uv, (O, 2)), "w": (w, (O,))}
    for name, (x, shape) in want.items():
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}, got {x.dtype} {tuple(x.shape)}")
        if x.device != Xc.device:
            raise ValueError(f"{name} lies on {x.device}, Xc on {Xc.device}")


# The kernel's layout (csrc/ba_blocks.cu): a warp takes a tile of TILE
# observations, WARPS warps a block, at most WAVES times the blocks the card
# holds at once, and each output region of the one buffer starts on a
# 16-byte boundary (ALIGN floats), which its 16-byte stores need.
TILE = 32
WARPS = 4
WAVES = 2
ALIGN = 4
# The kernel takes the count as a C int and forms 64-bit offsets from it.
MAX_OBS = 2**31 - 1


def check_count(O: int) -> None:
    """Refuse a count the kernel cannot index: its C int argument."""
    if O > MAX_OBS:
        raise ValueError(f"too many observations for the kernel's int count: {O} > {MAX_OBS}")


def output_layout(O: int):
    """Where the eight outputs lie in the kernel's one buffer of float32:
    ([(key, offset, width, shape)], total floats). Regions follow in the
    order res, U, V, W, bc, bp, Jc, Jp, each of O x width floats, each
    starting at a multiple of ALIGN floats, without overlap."""
    regions, end = [], 0
    for key, k, shape in zip(_KEYS, _WIDTHS, _SHAPES):
        off = -(-end // ALIGN) * ALIGN
        regions.append((key, off, k, (O,) + shape))
        end = off + k * O
    return regions, end


def grid_blocks(O: int, sms: int, blocks_per_sm: int) -> int:
    """The kernel's grid: a block for every WARPS tiles of TILE observations,
    at most WAVES times the blocks the card holds at once (the kernel loops
    over the rest)."""
    tiles = -(-O // TILE)
    return max(1, min(-(-tiles // WARPS), WAVES * sms * blocks_per_sm))


_fn = None
_cards: dict[int, tuple[int, int]] = {}  # (SMs, blocks an SM holds) by device index


def _kernel():
    """The library's launch function, its C signature set once at load."""
    global _fn
    if _fn is None:
        from tpu3drec_torch.ops.build import load

        fn = load("ba_blocks").tpu3drec_ba_blocks
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_float] * 4
                       + [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _card(device: torch.device) -> tuple[int, int]:
    """The SM count of the card and the kernel's blocks an SM holds, asked once."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _cards:
        from tpu3drec_torch.ops.build import blocks_per_sm

        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _cards[index] = (sms, blocks_per_sm("ba_blocks", device))
    return _cards[index]


def ba_blocks_cuda(Xc, Rmat, uv, w, intrinsics):
    """Launch the kernel; returns the dict of per-observation blocks, views
    of one buffer laid out by `output_layout`."""
    global launches, captured
    _check(Xc, Rmat, uv, w)
    if Xc.device.type != "cuda":
        raise ValueError(f"ba_blocks_cuda takes CUDA tensors, got {Xc.device}")
    O = Xc.shape[0]
    check_count(O)
    fx, fy, cx, cy = (float(v) for v in intrinsics)
    fn = _kernel()
    regions, total = output_layout(O)
    with torch.cuda.device(Xc.device):
        blocks = grid_blocks(O, *_card(Xc.device))
        ins = [x.contiguous() for x in (Xc, Rmat, uv, w)]
        buf = torch.empty((total,), dtype=torch.float32, device=Xc.device)
        base = buf.data_ptr()
        stream = torch.cuda.current_stream(Xc.device).cuda_stream
        rc = fn(*[x.data_ptr() for x in ins], O, fx, fy, cx, cy,
                *[base + 4 * off for _, off, _, _ in regions], blocks, stream)
    if rc != 0:
        raise RuntimeError(f"ba_blocks kernel launch failed: cudaError {rc}")
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1
    return {key: buf[off:off + k * O].view(shape) for key, off, k, shape in regions}


def ba_blocks_plain(Xc, Rmat, uv, w, intrinsics):
    """Plain PyTorch version of the kernel, in its operation order."""
    _check(Xc, Rmat, uv, w)
    fx, fy, cx, cy = (float(v) for v in intrinsics)
    O = Xc.shape[0]
    x, y, zr = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    z = torch.where(torch.abs(zr) < 1e-9, torch.full_like(zr, 1e-9), zr)
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    ru = fx * x * inv_z + cx - uv[:, 0]
    rv = fy * y * inv_z + cy - uv[:, 1]
    a0 = fx * inv_z
    a2 = -fx * x * inv_z2
    b1 = fy * inv_z
    b2 = -fy * y * inv_z2
    zero = torch.zeros_like(a0)
    Ju = torch.stack([a2 * y, a0 * z - a2 * x, -a0 * y, a0, zero, a2], -1)   # (O, 6)
    Jv = torch.stack([-b1 * z + b2 * y, -b2 * x, b1 * x, zero, b1, b2], -1)
    R = Rmat.reshape(O, 9)
    Pu = torch.stack([a0 * R[:, k] + a2 * R[:, 6 + k] for k in range(3)], -1)  # (O, 3)
    Pv = torch.stack([b1 * R[:, 3 + k] + b2 * R[:, 6 + k] for k in range(3)], -1)
    wc = w[:, None, None]

    def outer(pa, pb, qa, qb):
        return wc * (pa[:, :, None] * pb[:, None, :] + qa[:, :, None] * qb[:, None, :])

    nw = (-w)[:, None]
    return {
        "res": torch.stack([ru, rv], -1),
        "U": outer(Ju, Ju, Jv, Jv),
        "V": outer(Pu, Pu, Pv, Pv),
        "W": outer(Ju, Pu, Jv, Pv),
        "bc": nw * (Ju * ru[:, None] + Jv * rv[:, None]),
        "bp": nw * (Pu * ru[:, None] + Pv * rv[:, None]),
        "Jc": torch.stack([Ju, Jv], 1),
        "Jp": torch.stack([Pu, Pv], 1),
    }


def ba_blocks(Xc, Rmat, uv, w, intrinsics):
    """Per-observation blocks for Xc (O, 3) camera-frame points, Rmat
    (O, 3, 3) world->camera rotations, uv (O, 2) measurements, w (O,)
    weights and intrinsics (fx, fy, cx, cy): a dict with res (O, 2), U
    (O, 6, 6), V (O, 3, 3), W (O, 6, 3), bc (O, 6), bp (O, 3), Jc (O, 2, 6)
    and Jp (O, 2, 3). The kernel on CUDA tensors, the plain version on CPU."""
    if Xc.device.type == "cuda":
        return ba_blocks_cuda(Xc, Rmat, uv, w, intrinsics)
    return ba_blocks_plain(Xc, Rmat, uv, w, intrinsics)


def local_jacobians_reference(Xc, Rmat, uv, K):
    """Autodiff reference for the closed forms: forward-mode Jacobians of the
    projection under the left-multiplicative perturbation
    Xc' = Xc + omega x Xc + nu, and X' = X + eps seen through R."""
    K = torch.as_tensor(K, dtype=Xc.dtype, device=Xc.device)

    def proj(xc):
        z = torch.where(torch.abs(xc[2]) < 1e-9, torch.full_like(xc[2], 1e-9), xc[2])
        return torch.stack([xc[0] / z * K[0, 0] + K[0, 2], xc[1] / z * K[1, 1] + K[1, 2]])

    def res_of_delta(delta, xc, uvi):
        return proj(xc + torch.linalg.cross(delta[:3], xc) + delta[3:]) - uvi

    def res_of_eps(eps, xc, Ri, uvi):
        return proj(xc + Ri @ eps) - uvi

    from torch.func import jacfwd, vmap

    z6 = torch.zeros(6, dtype=Xc.dtype, device=Xc.device)
    z3 = torch.zeros(3, dtype=Xc.dtype, device=Xc.device)
    with FORWARD_AD_LOCK:
        Jc = vmap(lambda xc, uvi: jacfwd(res_of_delta)(z6, xc, uvi))(Xc, uv)
        Jp = vmap(lambda xc, Ri, uvi: jacfwd(res_of_eps)(z3, xc, Ri, uvi))(Xc, Rmat, uv)
    return Jc, Jp

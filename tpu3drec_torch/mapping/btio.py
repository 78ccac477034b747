"""octomap ``.bt`` binary octree writer/reader (port of
`tpu3drec/mapping/btio.py`). `write_bt` builds the tree in the native
library (`utils/native.py`) or, with ``backend="python"``, here; both give
the same bytes.

Every insert of the reference's octomap converters was ``occupied=True``
with no ray-casting, so the resulting tree is exactly "the set of touched
voxels, pruned": it is built directly from deduplicated voxel keys (see
`mapping/voxel.py`) by Morton-sorted partitioning.

File format (octomap AbstractOcTree::writeBinary):
  header:  ``# Octomap OcTree binary file`` first line, then ``id OcTree``,
           ``size <node count>``, ``res <meters>``, ``data``.
  payload: preorder node stream; each node is 2 bytes = 8 children x 2 bits
           (child i of 0-3 -> bits (2i, 2i+1) of byte 0, children 4-7 in
           byte 1): 00 none, 01 occupied leaf, 10 free leaf, 11 inner
           (recursed). Keys are ``floor(coord/res) + 2^15`` (depth-16 tree).
"""

from __future__ import annotations

import os

import numpy as np

OCTOMAP_TREE_DEPTH = 16
_KEY_OFFSET = 1 << 15
_HEADER_FIRST_LINE = "# Octomap OcTree binary file"


def _part1by2(v: np.ndarray) -> np.ndarray:
    """Spread each of the low 21 bits of v to every 3rd bit (uint64)."""
    v = v.astype(np.uint64) & np.uint64(0x1FFFFF)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    return v


def morton_encode(keys_u16: np.ndarray) -> np.ndarray:
    """(N, 3) unsigned 16-bit keys -> uint64 morton codes, x least significant
    (octomap computeChildIdx: pos = x_bit + 2*y_bit + 4*z_bit)."""
    return (
        _part1by2(keys_u16[:, 0])
        | (_part1by2(keys_u16[:, 1]) << np.uint64(1))
        | (_part1by2(keys_u16[:, 2]) << np.uint64(2))
    )


def morton_decode(m: np.ndarray) -> np.ndarray:
    """uint64 morton codes -> (N, 3) uint32 keys."""
    out = np.zeros((m.shape[0], 3), dtype=np.uint32)
    mm = m.astype(np.uint64)
    for axis in range(3):
        v = (mm >> np.uint64(axis)) & np.uint64(0x1249249249249249)
        v = (v | (v >> np.uint64(2))) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v >> np.uint64(4))) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v >> np.uint64(8))) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v >> np.uint64(16))) & np.uint64(0x1F00000000FFFF)
        v = (v | (v >> np.uint64(32))) & np.uint64(0x1FFFFF)
        out[:, axis] = v.astype(np.uint32)
    return out


def _build_nodes(morton_sorted: np.ndarray, morton_free: np.ndarray | None = None):
    """Preorder node byte stream + node count from sorted unique mortons.

    A child subtree holding its full 8^b voxel complement of one label is
    pruned to a single leaf of that label (octomap prune() semantics);
    occupied leaves encode 0b01, free leaves 0b10."""
    out = bytearray()
    n_nodes = 1  # root
    mf = morton_free if morton_free is not None else np.zeros(0, np.uint64)
    m = morton_sorted
    if m.size == 0 and mf.size == 0:
        return bytes(out), 0
    # Stack of (lo_o, hi_o, lo_f, hi_f, child_bit_level); emit at pop.
    stack = [(0, len(m), 0, len(mf), OCTOMAP_TREE_DEPTH - 1)]
    while stack:
        lo_o, hi_o, lo_f, hi_f, b = stack.pop()
        node_size = np.uint64(1) << np.uint64(3 * (b + 1))
        child_size = np.uint64(1) << np.uint64(3 * b)
        any_code = m[lo_o] if hi_o > lo_o else mf[lo_f]
        start = any_code & ~(node_size - np.uint64(1))
        edges = start + child_size * np.arange(9, dtype=np.uint64)
        bo = np.searchsorted(m[lo_o:hi_o], edges) + lo_o
        bf = np.searchsorted(mf[lo_f:hi_f], edges) + lo_f
        byte0 = 0
        byte1 = 0
        inner_children = []
        for i in range(8):
            co = int(bo[i + 1]) - int(bo[i])
            cf = int(bf[i + 1]) - int(bf[i])
            if co == 0 and cf == 0:
                continue
            n_nodes += 1
            if cf == 0 and co == int(child_size):
                bits = 0b01  # full occupied subtree -> occupied leaf
            elif co == 0 and cf == int(child_size):
                bits = 0b10  # full free subtree -> free leaf
            else:
                bits = 0b11
                inner_children.append(
                    (int(bo[i]), int(bo[i + 1]), int(bf[i]), int(bf[i + 1]), b - 1)
                )
            if i < 4:
                byte0 |= bits << (2 * i)
            else:
                byte1 |= bits << (2 * (i - 4))
        out.append(byte0)
        out.append(byte1)
        # Push reversed so children pop (and emit) in 0..7 order.
        for child in reversed(inner_children):
            stack.append(child)
    return bytes(out), n_nodes


def write_bt(path: str, voxel_keys: np.ndarray, res: float,
             backend: str = "auto", free_keys: np.ndarray | None = None) -> int:
    """Write occupied voxel keys ((M, 3) int, signed floor(p/res) convention)
    as an octovis-compatible ``.bt``. Returns the node count.

    ``backend``: "auto" builds the tree in the native library
    (`utils/native.py`, the same bytes; it raises if the library cannot be
    built) unless ``free_keys`` is given, as the JAX package does; "python"
    uses this module. ``free_keys`` adds carved free-space leaves (0b10
    child codes)."""
    if backend not in ("auto", "python"):
        raise ValueError(f"backend must be 'auto' or 'python', not {backend!r}")
    if backend == "auto" and free_keys is None:
        from tpu3drec_torch.utils import native

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        return native.bt_write_keys(path, np.asarray(voxel_keys, np.int32).reshape(-1, 3), res)
    keys = np.asarray(voxel_keys, dtype=np.int64) + _KEY_OFFSET
    if keys.size and (keys.min() < 0 or keys.max() >= (1 << 16)):
        raise ValueError("voxel keys exceed octomap depth-16 key range")
    m = np.unique(morton_encode(keys.astype(np.uint64)))
    mf = None
    if free_keys is not None and len(free_keys):
        fk = np.asarray(free_keys, dtype=np.int64) + _KEY_OFFSET
        if fk.min() < 0 or fk.max() >= (1 << 16):
            raise ValueError("free voxel keys exceed octomap key range")
        mf = np.unique(morton_encode(fk.astype(np.uint64)))
    payload, n_nodes = _build_nodes(m, mf)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(
            (
                f"{_HEADER_FIRST_LINE}\n"
                "# (feel free to add / change comments, but leave the first line as it is!)\n"
                "#\n"
                "id OcTree\n"
                f"size {n_nodes}\n"
                f"res {res}\n"
                "data\n"
            ).encode("ascii")
        )
        f.write(payload)
    return n_nodes


def read_bt(path: str, with_free: bool = False):
    """Read a ``.bt``. Returns (occupied voxel keys (M, 3) int32 signed
    convention, res), or (occupied, free, res) when ``with_free``. Pruned
    leaves are expanded to their constituent depth-16 voxels."""
    with open(path, "rb") as f:
        first = f.readline().decode("ascii").strip()
        if first != _HEADER_FIRST_LINE:
            raise ValueError(f"not a .bt file: {first!r}")
        res = None
        size = None
        while True:
            line = f.readline().decode("ascii").strip()
            if line == "data":
                break
            if line.startswith("res "):
                res = float(line.split()[1])
            elif line.startswith("size "):
                size = int(line.split()[1])
            elif line.startswith("id "):
                if line.split()[1] not in ("OcTree", "ColorOcTree"):
                    raise ValueError(f"unsupported tree id {line!r}")
        payload = f.read()

    occupied: list[np.ndarray] = []
    free: list[np.ndarray] = []
    empty = np.zeros((0, 3), dtype=np.int32)
    if size == 0 or not payload:
        return (empty, empty, res) if with_free else (empty, res)
    pos = 0
    # (prefix morton, child_bit_level) preorder stack, mirroring the writer.
    stack = [(np.uint64(0), OCTOMAP_TREE_DEPTH - 1)]
    while stack:
        prefix, b = stack.pop()
        byte0, byte1 = payload[pos], payload[pos + 1]
        pos += 2
        inner = []
        for i in range(8):
            bits = (byte0 >> (2 * i)) & 0b11 if i < 4 else (byte1 >> (2 * (i - 4))) & 0b11
            if bits == 0:
                continue
            child_prefix = prefix | (np.uint64(i) << np.uint64(3 * b))
            if bits == 0b11:
                inner.append((child_prefix, b - 1))
            elif bits == 0b01:  # occupied leaf, possibly pruned
                occupied.append(child_prefix + np.arange(1 << (3 * b), dtype=np.uint64))
            elif bits == 0b10:  # free leaf
                free.append(child_prefix + np.arange(1 << (3 * b), dtype=np.uint64))
        for child in reversed(inner):
            stack.append(child)

    def expand(parts):
        if not parts:
            return empty
        mortons = np.concatenate(parts)
        return (morton_decode(np.sort(mortons)).astype(np.int64) - _KEY_OFFSET).astype(np.int32)

    if with_free:
        return expand(occupied), expand(free), res
    return expand(occupied), res

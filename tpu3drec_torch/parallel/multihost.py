"""Multi-process runtime: initialisation, barriers, and per-process
sharded artifact writers (port of `tpu3drec/parallel/multihost.py`).

* `init_distributed` joins this process to a `torch.distributed` world:
  from a coordinator ``host:port`` (or an ``init_method`` URL such as
  ``file://...``) with the process count and id passed explicitly, or from
  torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``). The
  backend is NCCL only when every rank has a card of its own, else gloo
  (two ranks sharing one card run on gloo; `parallel/mesh.py` stages their
  CUDA tensors through host memory).
* `barrier(tag)` orders filesystem rendezvous points.
* `spawn_local` starts the ranks of a world as processes on this host and
  waits for them (the tests' worlds, the tools' ``--nproc``/``--ranks``,
  `chip_smoke.py`'s two ranks).
* Per-process sharded writers: every process writes only its shard of an
  artifact (PLY point cloud, `.bt` octree), then process 0 merges the parts
  into the single deliverable after a barrier. Artifacts land on a shared
  filesystem.
"""

from __future__ import annotations

import atexit
import glob
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

_INITIALIZED = False
_log = logging.getLogger(__name__)


def _backend(world: int) -> str:
    """NCCL only when each of the ``world`` ranks can hold a card of its
    own; gloo otherwise."""
    if torch.cuda.is_available() and dist.is_nccl_available() \
            and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> bool:
    """Initialise the multi-process runtime. No-op (returns False) when
    called twice, or with no coordinator and no torchrun environment.

    ``coordinator``: ``"host:port"`` of process 0 (``tcp://``), or an
    ``init_method`` URL; ``local_device_ids``: the card of this process (the
    first id is made the current CUDA device; default
    ``local_rank % device_count``). The backend is `_backend`'s.
    """
    global _INITIALIZED
    if _INITIALIZED or dist.is_initialized():
        return False
    # leave the group before the interpreter's teardown: a process group
    # still alive then can abort the process ("terminate called without an
    # active exception") as its threads are destroyed
    atexit.register(_leave)
    if coordinator is None and num_processes is None:
        env = os.environ
        if not (env.get("RANK") and env.get("WORLD_SIZE") and env.get("MASTER_ADDR")):
            return False
        world = int(env["WORLD_SIZE"])
        _set_device(local_device_ids, int(env.get("LOCAL_RANK", env["RANK"])))
        dist.init_process_group(_backend(world), init_method="env://")
        _INITIALIZED = True
        return True
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("pass coordinator, num_processes and process_id together")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    _set_device(local_device_ids, process_id)
    dist.init_process_group(_backend(num_processes), init_method=url,
                            world_size=num_processes, rank=process_id)
    _INITIALIZED = True
    return True


def _leave() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn_local(argv, n: int, timeout: float, **popen) -> list[str]:
    """Run the ``n`` ranks of one world as processes on this host and wait
    for all of them: ``argv(rank)`` is rank ``rank``'s command line, and
    ``popen`` goes to every `subprocess.Popen`. Each rank's output (stdout
    and stderr) goes to a file of its own, so that no rank blocks on a full
    pipe while another waits for it in a collective. A rank that exits
    non-zero, or a world that outlasts ``timeout`` seconds, kills every
    rank still running and raises RuntimeError with every rank's output.
    Returns each rank's output."""
    import subprocess
    import tempfile
    import time

    logs = [tempfile.TemporaryFile("w+") for _ in range(n)]
    procs = []
    try:
        for r in range(n):
            procs.append(subprocess.Popen(argv(r), stdout=logs[r], stderr=subprocess.STDOUT,
                                          text=True, **popen))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline \
                and not any(p.poll() for p in procs):
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        late = " (the world outlasted %s s)" % timeout if time.monotonic() >= deadline else ""
        raise RuntimeError(f"ranks exited {rcs}{late}:\n" + "\n".join(
            f"--- rank {r} (exit {rc})\n{o}" for r, (rc, o) in enumerate(zip(rcs, outs))))
    return outs


def _set_device(local_device_ids, local_rank: int) -> None:
    if not torch.cuda.is_available():
        return
    if local_device_ids is not None:
        ids = list(local_device_ids) if hasattr(local_device_ids, "__iter__") \
            else [local_device_ids]
        torch.cuda.set_device(int(ids[0]))
    else:
        torch.cuda.set_device(local_rank % torch.cuda.device_count())


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_distributed() -> bool:
    return process_count() > 1


def barrier(tag: str) -> None:
    """Block until every process reaches this point (ordering for
    filesystem rendezvous: all shards written before the merge reads).
    gloo has no tagged barrier: the tag names the point in the log and in
    the error of a barrier that fails."""
    if process_count() <= 1:
        return
    from tpu3drec_torch.parallel.mesh import barrier as world_barrier

    _log.debug("barrier %s (rank %d)", tag, process_index())
    try:
        world_barrier()
    except RuntimeError as e:
        raise RuntimeError(f"barrier {tag!r} failed on rank {process_index()}: {e}") from e


def process_slice(n: int) -> slice:
    """This process's contiguous shard of n work items (balanced: first
    n % p processes take one extra)."""
    p, i = process_count(), process_index()
    base, extra = divmod(n, p)
    start = i * base + min(i, extra)
    return slice(start, start + base + (1 if i < extra else 0))


_WORLD_MESH = None


def world_mesh():
    """The world's ranks on one mesh axis (``data``), on the device the
    backend exchanges host data through: the CPU under gloo, this rank's
    card under NCCL. Made once; every process must first call it at the
    same point (it makes process groups)."""
    global _WORLD_MESH
    if _WORLD_MESH is None:
        from tpu3drec_torch.parallel.mesh import local_device, make_mesh

        dev = "cpu" if dist.get_backend() == dist.Backend.GLOO else local_device()
        _WORLD_MESH = make_mesh(data=0, device=dev)
    return _WORLD_MESH


def process_allgather(x: np.ndarray) -> np.ndarray:
    """Every process's ``x`` (one shape and dtype on all) stacked in rank
    order, through `parallel/mesh.py::all_gather`."""
    from tpu3drec_torch.parallel.mesh import all_gather

    if process_count() <= 1:
        return np.asarray(x)[None]
    mesh = world_mesh()
    return all_gather(mesh, torch.as_tensor(np.ascontiguousarray(x), device=mesh.device),
                      "data").cpu().numpy()


def _part_path(path: str, pid: int, nproc: int) -> str:
    root, ext = os.path.splitext(path)
    return f"{root}.part{pid:04d}-of-{nproc:04d}{ext}"


def write_ply_sharded(
    path: str,
    points: np.ndarray,
    colors: np.ndarray | None = None,
    binary: bool = False,
    merge: bool = True,
) -> str:
    """Each process writes its OWN points as a part file; after a barrier,
    process 0 merges the parts into the single `path` deliverable (and
    removes the parts). With merge=False the parts are the artifact set
    (huge clouds: no single-host concatenation) and process 0 writes a
    `path.manifest` listing them.

    Returns the final artifact path (the manifest path when merge=False).
    """
    from tpu3drec_torch.utils.plyio import read_ply, write_ply

    pid, nproc = process_index(), process_count()
    if nproc <= 1:
        write_ply(path, points, colors=colors, binary=binary)
        return path

    part = _part_path(path, pid, nproc)
    write_ply(part, points, colors=colors, binary=binary)
    barrier("ply_parts:" + path)

    if not merge:
        manifest = path + ".manifest"
        if pid == 0:
            parts = sorted(glob.glob(_part_path(path, 0, nproc).replace("part0000", "part*")))
            with open(manifest, "w") as f:
                f.write("\n".join(os.path.basename(p) for p in parts) + "\n")
        barrier("ply_manifest:" + path)
        return manifest

    if pid == 0:
        pts, cols = [], []
        parts = [_part_path(path, i, nproc) for i in range(nproc)]
        has_color = colors is not None
        for pp in parts:
            p_i, c_i = read_ply(pp)
            pts.append(np.asarray(p_i))
            if has_color:
                cols.append(np.asarray(c_i))
        write_ply(
            path,
            np.concatenate(pts) if pts else np.zeros((0, 3), np.float32),
            colors=np.concatenate(cols) if has_color else None,
            binary=binary,
        )
        for pp in parts:
            os.remove(pp)
    barrier("ply_merged:" + path)
    return path


def write_bt_sharded(
    path: str,
    voxel_keys: np.ndarray,
    res: float,
    free_keys: np.ndarray | None = None,
) -> int:
    """Octree artifact from per-process voxel shards: each process dumps
    its (M, 3) int keys as an .npy part; process 0 unions them (octrees
    merge by voxel-set union: occupied wins over free, like log-odds fusion
    saturated at the clamp) and writes the single .bt.

    Returns the node count on process 0, -1 elsewhere.
    """
    from tpu3drec_torch.mapping.btio import write_bt

    pid, nproc = process_index(), process_count()
    if nproc <= 1:
        return write_bt(path, voxel_keys, res, free_keys=free_keys)

    part = _part_path(path, pid, nproc) + ".npy"
    np.save(part, np.asarray(voxel_keys, np.int32))
    if free_keys is not None:
        np.save(part + ".free.npy", np.asarray(free_keys, np.int32))
    barrier("bt_parts:" + path)

    n_nodes = -1
    if pid == 0:
        occ, free = [], []
        for i in range(nproc):
            pp = _part_path(path, i, nproc) + ".npy"
            occ.append(np.load(pp))
            fp = pp + ".free.npy"
            if os.path.exists(fp):
                free.append(np.load(fp))
        occ_all = np.unique(np.concatenate(occ), axis=0) if occ else np.zeros((0, 3), np.int32)
        fk = None
        if free:
            fk = np.unique(np.concatenate(free), axis=0)
            # occupied wins: drop free voxels any process observed occupied
            occ_set = {tuple(k) for k in occ_all}
            fk = np.asarray([k for k in fk if tuple(k) not in occ_set], np.int32).reshape(-1, 3)
            if not fk.size:
                fk = None
        n_nodes = write_bt(path, occ_all, res, free_keys=fk)
        for i in range(nproc):
            pp = _part_path(path, i, nproc) + ".npy"
            os.remove(pp)
            if os.path.exists(pp + ".free.npy"):
                os.remove(pp + ".free.npy")
    barrier("bt_merged:" + path)
    return n_nodes

"""A world of gloo ranks on the CPU for the port's multi-process tests
(`tests/test_torch_parallel.py`, `tests/test_torch_multihost.py`).

The parent writes the inputs to a directory, starts ``world`` processes of
a test file run as a script (each one rank: ``python <file> <rank> <world>
<dir>``) through `parallel/multihost.py::spawn_local`, and waits for all of
them, within a timeout of the world's own. The ranks join one process group
through a file store in the directory (``file://``, no TCP port to race
for), use one thread each, import no JAX, and write their results as
``rank<r>.npz``. A rank that fails, or a world that outlasts its timeout,
fails the fixture with every rank's output.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_world(script: str, workdir, world: int = 4, timeout: float = 120.0,
              extra_args=()) -> list[dict]:
    """Run ``script`` as ``world`` ranks in ``workdir``; returns each rank's
    ``rank<r>.npz`` as a dict."""
    from tpu3drec_torch.parallel.multihost import spawn_local

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    spawn_local(lambda r: [sys.executable, script, str(r), str(world), str(workdir),
                           *extra_args], world, timeout, cwd=ROOT, env=env)
    return [dict(np.load(os.path.join(str(workdir), f"rank{r}.npz"))) for r in range(world)]


def join(argv):
    """In a rank: parse ``<rank> <world> <dir>``, use one thread, join the
    world through the directory's file store. Returns (rank, world, dir)."""
    import torch

    from tpu3drec_torch.parallel.multihost import init_distributed

    rank, world, workdir = int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    assert init_distributed("file://" + os.path.join(workdir, "store"), world, rank)
    return rank, world, workdir

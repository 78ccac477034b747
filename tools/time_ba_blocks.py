"""Device time of the BA-blocks kernel by grid size, on one card.

    python3 tools/time_ba_blocks.py [--sizes 65536 262144] [--rounds 3]

For each observation count, launches `ba_blocks_cuda` with the wrapper's
grid (`grid_blocks`: at most two waves of the blocks the card holds at
once, the kernel looping over the rest) and with other block counts, from
one block an SM up to one tile a warp (no loop), in interleaved rounds, and prints each grid's device time
(torch.profiler's CUDA activity, mean of 50 launches, as `chip_smoke.py`
measures it) beside the byte bound. Every launch is checked bit-equal to
`ba_blocks_plain` once per grid. As a yardstick of what the card's memory
reaches on a stream of writes, it also times `fill_` of a buffer of the
kernel's bytes (107 floats an observation), by the same profiler route.
Prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (BA_FLOATS_IN, BA_FLOATS_OUT, HBM_BYTES_S, _ba_inputs,  # noqa: E402
                        kernel_times)
from tpu3drec_torch.ops import ba_blocks  # noqa: E402

INTR = (500.0, 510.0, 320.0, 240.0)


@contextlib.contextmanager
def grid_of(blocks: int):
    """Launches with `blocks` blocks in place of the wrapper's grid."""
    plan = ba_blocks.grid_blocks
    ba_blocks.grid_blocks = lambda O, sms, per_sm: blocks
    try:
        yield
    finally:
        ba_blocks.grid_blocks = plan


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[65_536, 262_144])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_ba_blocks: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    from tpu3drec_torch.ops.build import blocks_per_sm

    per_sm = blocks_per_sm("ba_blocks", dev)
    print(f"SMs {sms}, blocks an SM holds {per_sm}", flush=True)
    for O in args.sizes:
        ins = _ba_inputs(np.random.default_rng(O), O, dev)
        one_tile_a_warp = -(-O // (ba_blocks.TILE * ba_blocks.WARPS))
        grids = sorted({min(g, one_tile_a_warp) for g in
                        (sms, 2 * sms, sms * per_sm, 2 * sms * per_sm, 4 * sms * per_sm,
                         one_tile_a_warp)})
        plain = ba_blocks.ba_blocks_plain(*ins, INTR)
        times = {g: [] for g in grids}
        for g in grids:
            with grid_of(g):
                out = ba_blocks.ba_blocks_cuda(*ins, INTR)
            torch.cuda.synchronize()
            assert all(torch.equal(out[k], plain[k]) for k in plain), f"grid {g} differs"
        for _ in range(args.rounds):
            for g in grids:
                with grid_of(g):
                    ms, _ = kernel_times(lambda: ba_blocks.ba_blocks_cuda(*ins, INTR),
                                         ("ba_blocks_kernel",), dev, reps=50, warmup=3)
                times[g].append(ms)
        fill = torch.empty((BA_FLOATS_IN + BA_FLOATS_OUT) * O, dtype=torch.float32, device=dev)
        fill_ms = [kernel_times(lambda: fill.fill_(1.0), ("elementwise_kernel",), dev, reps=50,
                                warmup=3)[0] for _ in range(args.rounds)]
        del fill
        bound = (BA_FLOATS_IN + BA_FLOATS_OUT) * 4 * O / HBM_BYTES_S * 1e3
        plan = ba_blocks.grid_blocks(O, sms, per_sm)
        for g in grids:
            print(json.dumps({"O": O, "blocks": g, "wrapper_grid": g == plan,
                              "ms": times[g], "bound_ms": bound}), flush=True)
        print(json.dumps({"O": O, "fill_same_bytes_ms": fill_ms, "bound_ms": bound}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

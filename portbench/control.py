#!/usr/bin/env python3
"""Readings behind the limits of a cell's check, at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--jobs 2] [--mode program]

For each seed: the entry's set-up, ``--jobs`` jobs (the SfM cell judges
the matcher launches of its jobs), then the program's readings (what a
run's check compares) and the control's (the plain reference in the
nearest precision below the configuration's, in the program's place).
``--mode`` plants one of the entry's faults in the program instead. One
JSON line a seed. The benchmark's own runs never run this.
"""

import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import argparse  # noqa: E402
import json  # noqa: E402
import tempfile  # noqa: E402

import torch  # noqa: E402

from portbench.core.harness import RunContext, load_module, load_cell  # noqa: E402


def readings(cell_name: str, seed: int, jobs: int, mode: str, device, overrides=None) -> dict:
    cell = load_cell(cell_name, overrides)
    entry_mod = load_module("entries", cell.traffic["entry"])
    with tempfile.TemporaryDirectory(prefix="portbench_") as out_dir:
        entry = entry_mod.Entry(RunContext(cell.config, cell.traffic, seed, device, out_dir,
                                           mode))
        jobs = max(jobs, getattr(entry, "min_jobs", 1))  # the held training step included
        records = [{"i": i, "traced": False, **entry.job(i)} for i in range(jobs)]
        entry.release()
        program = entry.check(records)
        control = entry.control() if mode == "program" else []
    return {"seed": seed, "mode": mode,
            "program": {c["name"]: c["value"] for c in program},
            "control": {c["name"]: c["value"] for c in control},
            "program_correct": all(c["ok"] for c in program),
            "control_correct": all(c["ok"] for c in control)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--mode", default="program")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    for seed in map(int, args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.jobs, args.mode,
                                  torch.device("cuda", 0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card this process is on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the checks on standard error as its last lines, then one JSON line
on standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics), ``device``, with ``--trace 1`` ``breakdown``, and ``checks``.
Exits 3, printing no result, when the card or cards the cell needs are
missing.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here, before torch loads

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed place inside the checkout; the
# port's own kernels build into build/tpu3drec_torch/ (ops/build.py)
_CACHE = os.path.join(ROOT, "build", "portbench")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "cuda_compute_cache")
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "4"
sys.path[0] = ROOT  # import the harness as `portbench`, never its folders by bare name

if __name__ == "__main__":
    from portbench.core.harness import main

    sys.exit(main(sys.argv[1:], T_START))

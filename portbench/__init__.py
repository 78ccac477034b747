"""The benchmark of the PyTorch and CUDA port (`tpu3drec_torch`).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` at the root of the checkout names the cells, their
configurations and traffic, and the metrics. Everything that belongs to
one configuration, traffic mix, entry or metric sits in a file of its own
here, found by name:

- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the traffic mix, which names its entry;
- ``entries/<entry>.py``: set-up, one job, and the check of the outputs;
- ``references/<entry>.py``: the plain reference and the work counts;
- ``metrics/<metric>.py``: one reader per metric.

Nothing here imports JAX or the JAX package; the references import
nothing of the port either.
"""

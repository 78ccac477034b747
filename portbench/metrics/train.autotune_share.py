"""Share of training steps run under cuDNN's autotuner: the untraced
steps' program counter ``train.autotuned_steps`` (1 for a step on a CUDA
device under `core/fp.py::cudnn_autotune`,
`models/training.py::train_step_skeleton`) over their ``train.step``
spans, in %. None against a program that does not count tuned steps."""

from portbench.core import program_spans as ps


def read(win):
    jobs = ps.jobs(win, "train.step")
    spans = [s for _, job in jobs or () for s in job]
    if not any("train.autotuned_steps" in (s.counters or {}) for s in spans):
        return None
    return 100.0 * ps.counter(spans, "train.autotuned_steps") / len(jobs)

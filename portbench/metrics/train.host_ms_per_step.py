"""Host milliseconds a training step (the program span ``train.step`` of
`models/training.py::make_train_step`), mean over the untraced steps. The
step does not wait for the device, so this is its dispatch: near
`train_step_ms` the step is bound by launching."""

from portbench.core import program_spans as ps


def read(win):
    jobs = ps.jobs(win, "train.step")
    return 1e3 * ps.mean(ps.seconds(spans, "train.step") for _, spans in jobs) if jobs else None

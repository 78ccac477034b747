"""The matching stage against its roofline: the least time the pairs' shapes
need (the fp32 products of the scores once, 2 P K K D at 67 TFLOP/s, or
the descriptors, masks and top-2 bytes at 3.35 TB/s, whichever is larger),
over the device time of every kernel launched under the span around
`match_pairs`, in the profiled slice, in %."""

from portbench.core.roofline import bound_seconds, matcher_work

SPANS = ["tpu3drec_torch.sfm.incremental:match_pairs"]


def read(win):
    if win.trace is None:
        return None
    spent = win.trace.kernel_seconds_under(["match_pairs"])
    calls = win.spans.traced_calls["match_pairs"]
    if not spent or not calls:
        return None
    need = 0.0
    for descs, _, pairs in (c[:3] for c in calls):
        _, K, D = descs
        need += bound_seconds(*matcher_work(pairs[0], K, K, D))[0]
    return 100.0 * need / spent

"""One H100 SXM's published peaks and the roofline bound.

Frozen copies: the peaks and `roofline`'s arithmetic of
`tpu3drec_torch/utils/profiling.py` (``H100``, ``roofline``), and
`chip_smoke.py`'s ``bound`` and ``_matcher_bound``. The benchmark keeps its
own so that a change to the program cannot move its yardstick.
"""

from __future__ import annotations

# NVIDIA's H100 SXM data sheet, dense rates, at the 700 W power limit
FLOPS_F32 = 67e12      # float32 on the CUDA cores (no tensor cores)
FLOPS_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_seconds(flops: float, bytes_moved: float, flops_per_s: float = FLOPS_F32):
    """(seconds, what bounds it): the least time of the work on the card, the
    larger of its operations over the peak rate and its bytes over HBM's."""
    t_ops, t_bytes = flops / flops_per_s, bytes_moved / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def matcher_work(P: int, Ka: int, Kb: int, D: int):
    """(flops, bytes) of a top-2 match of P pairs: the fp32 products of the
    scores once, and the descriptors and B's mask in, an index and two
    scores out, each byte once."""
    return 2 * P * Ka * Kb * D, ((P * Ka + P * Kb) * D + P * Kb) * 4 + P * Ka * 12

"""Parity of the port's `utils/profiling.py` with the JAX package's
`tpu3drec/utils/profiling.py`: `roofline` on the same numbers and chip
equal field for field (exact: the same float arithmetic), the H100's
published peaks, and the timers and trace on the CPU.
"""

import dataclasses
import json
import os

import pytest
import torch

from tpu3drec.utils import profiling as jprof
from tpu3drec_torch.utils import profiling as tprof

CASES = [  # (seconds, flops, bytes, dtype)
    (2.0332e-3, 9 * 76_800 * 76_800, (2 * 76_800) * 12 + 76_800 * 8, "f32"),
    (0.04086e-3, 0.0, 107 * 4 * 262_144, "f32"),
    (1.5827e-3, 2 * 8 * 4096 * 4096 * 128, ((8 * 4096 * 2) * 128 + 8 * 4096) * 4, "bf16"),
    (0.0, 1.0, 1.0, "f32"),
]


@pytest.mark.parametrize("case", CASES)
def test_roofline_equals_jax_on_the_same_chip(case):
    """The JAX package's v5e spec through both functions, and the port's
    H100 spec through both."""
    s, f, b, dt = case
    v5e = tprof.ChipSpec(**dataclasses.asdict(jprof.V5E))
    for jchip, tchip in ((jprof.V5E, v5e),
                         (jprof.ChipSpec(**dataclasses.asdict(tprof.H100)), tprof.H100)):
        ref = jprof.roofline(s, f, b, chip=jchip, dtype=dt)
        got = tprof.roofline(s, f, b, chip=tchip, dtype=dt)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert str(got) == str(ref)


def test_h100_is_the_published_sheet_and_the_default():
    h = tprof.H100
    assert (h.flops_f32, h.flops_bf16, h.hbm_bytes_per_s) == (67e12, 989e12, 3.35e12)
    # the ICP-NN kernel's bound at 76,800 x 76,800 (PERF.md section 6): 0.792 ms
    r = tprof.roofline(1.0, *CASES[0][1:3])
    assert r.compute_bound and abs(r.fraction_of_peak * 1e3 - 0.7923) < 1e-4


def test_timers_and_chain_scalar_on_the_cpu():
    x0 = torch.ones(64)
    s = tprof.time_chained(lambda x: x * 1.0001, x0, iters=5, warmup=1)
    assert 0 < s < 1
    slope = tprof.time_device_loop(lambda i, c: c + i, lambda salt: torch.full((8,), salt),
                                   iters=(2, 6), reps=2)
    assert 0 < slope < 1
    z = tprof.chain_scalar({"a": torch.ones(3), "b": [torch.zeros(2), (torch.ones(1),)]})
    assert z.shape == () and float(z) == 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "t")):
        torch.ones(128).sum()
    with open(tmp_path / "t" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    assert os.path.getsize(tmp_path / "t" / "trace.json") > 0


def test_recording_and_held_against():
    """`recording` passes calls through and keeps clones of what went in
    and out; `held_against` counts the calls equal to another function's,
    bit for bit, and names the first output that is not."""
    import types

    fn = lambda x: (x * 2, x + 1)  # noqa: E731
    mod = types.SimpleNamespace(f=fn)
    x = torch.arange(3.0)
    with tprof.recording(mod, "f") as calls:
        out = mod.f(x)
        mod.f(torch.ones(2))
    x += 10  # the recorded arguments are clones
    assert mod.f is fn and len(calls) == 2 and torch.equal(out[0], calls[0][1][0])
    assert tprof.held_against(calls, fn) == (2, 0.0, None)
    assert tprof.held_against(calls, lambda x: (x * 2, x + 1.5)) == (0, 0.5, (0, 1))

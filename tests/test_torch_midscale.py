"""Mid-scale long-sequence regression of the port (the `slow` analogue of
`tests/test_midscale.py`): the whole windowed pipeline (detection,
windowed SfM, stitching, loop closure, relocalization, the switchable pose
graph, global BA) on the 150-frame m00 loop of `tools/ate_torch.py`, whose
frames equal `tools/ate_benchmark.py`'s, on the CPU, held to the
reference test's bars.
"""

import os
import sys

import numpy as np
import pytest

_TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
if _TOOLS not in sys.path:
    sys.path.insert(0, _TOOLS)


@pytest.mark.slow
def test_midscale_city_loop_regression():
    import ate_torch

    m = ate_torch.run_sequence("m00", 150, device="cpu")
    # the reference test's three failure modes: coverage collapse, a NaN
    # pose in the evaluated trajectory, unremoved drift past the 2% bound
    assert m["coverage"] > 0.9, m
    assert np.isfinite(m["ate_rms"]), m
    assert m["ate_pct_traj"] < 2.0, m
    assert np.isfinite(m["rpe_trans"]) and np.isfinite(m["rpe_rot"]), m

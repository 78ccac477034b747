"""Flight-autonomy stack (port of `tpu3drec/autonomy/`): batched target
detection (`detect.py`), fiducial decode (`aruco.py`) and the mission state
machine (`mission.py`) that closes the perception -> control loop.
"""

from tpu3drec_torch.autonomy.aruco import aruco_original_dictionary, decode_marker
from tpu3drec_torch.autonomy.detect import (
    detect_rings,
    label_components,
    largest_blob,
    match_templates,
)
from tpu3drec_torch.autonomy.mission import (
    MissionConfig,
    MissionState,
    Phase,
    mission_rollout,
    mission_step,
)

__all__ = [
    "aruco_original_dictionary",
    "decode_marker",
    "detect_rings",
    "label_components",
    "largest_blob",
    "match_templates",
    "MissionConfig",
    "MissionState",
    "Phase",
    "mission_rollout",
    "mission_step",
]

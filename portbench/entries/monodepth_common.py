"""What the two Monodepth2 entries share (not an entry itself): the
configuration read into the port's `TrainConfig`, the port's model built on
the device with the benchmark's seeded weights, and the reference's loss
settings."""

from __future__ import annotations

import torch

from portbench.references import monodepth2 as ref


def camera(config: dict) -> dict:
    """KITTI's normalised intrinsics at the configuration's size."""
    w, h = config["width"], config["height"]
    (fx, _, cx), (_, fy, cy) = config["K"]
    return {"width": w, "height": h, "fx": fx * w, "fy": fy * h, "cx": cx * w, "cy": cy * h}


def loss_settings(config: dict) -> dict:
    cam = camera(config)
    return {"fx": cam["fx"], "fy": cam["fy"], "cx": cam["cx"], "cy": cam["cy"],
            "min_depth": config["min_depth"], "max_depth": config["max_depth"],
            "smoothness": config["disparity_smoothness"]}


def train_config(config: dict):
    from tpu3drec_torch.models.monodepth import MonodepthLossConfig
    from tpu3drec_torch.models.training import TrainConfig

    cam = camera(config)
    return TrainConfig(
        learning_rate=config["learning_rate"], batch_size=config["batch_size"],
        height=config["height"], width=config["width"], use_gt_pose=False,
        depth_layers=config["num_layers"], compute_dtype="float32",
        loss=MonodepthLossConfig(scales=tuple(config["scales"]), min_depth=config["min_depth"],
                                 max_depth=config["max_depth"],
                                 smoothness_weight=config["disparity_smoothness"],
                                 automask=True, fx=cam["fx"], fy=cam["fy"],
                                 cx=cam["cx"], cy=cam["cy"]))


def seeded_weights(seed: int, device) -> dict:
    with torch.device("meta"):
        shapes = ref.Monodepth2()
    return ref.make_weights(shapes, seed, device)


def port_model(weights: dict, config: dict, device):
    """The port's MonodepthModel on ``device`` holding ``weights``."""
    from tpu3drec_torch.models.monodepth import MonodepthModel

    with torch.device(device):
        model = MonodepthModel(depth_layers=config["num_layers"],
                               scales=tuple(config["scales"]))
    model.load_state_dict(weights)
    return model


def reference_model(weights: dict, dtype, device):
    with torch.device(device):
        model = ref.Monodepth2()
    model.load_state_dict(weights)
    return model.to(dtype)

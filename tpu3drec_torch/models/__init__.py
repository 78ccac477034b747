"""Neural depth models (port of `tpu3drec/models/`): the Monodepth2-class
self-supervised monocular depth nets, losses and training step, as
``torch.nn`` modules in NCHW behind the JAX package's NHWC functions."""

from tpu3drec_torch.models.depth_decoder import DepthDecoder
from tpu3drec_torch.models.monodepth import (
    MonodepthLossConfig,
    MonodepthModel,
    disp_to_depth,
    monodepth_loss,
)
from tpu3drec_torch.models.pose_net import PoseNet
from tpu3drec_torch.models.resnet import ResNetEncoder

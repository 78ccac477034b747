"""Weights from the JAX package's flax variables into the port's modules.

The JAX package keeps a model's weights as nested dicts of arrays under
flax's auto-names (``encoder/BasicBlock_3/Conv_1/kernel``,
``FeatureExtractor_0/ConvBnRelu_7/BatchNorm_0/scale``); the port's modules
store each module's convolutions in ``convs`` and batch norms in ``norms``
in flax's creation order, so one rule per name maps every key.
Convolution kernels go from HWIO to OIHW (2D) and from DHWIO to OIDHW
(3D); a batch norm's ``scale``/``bias`` become ``weight``/``bias`` and its
``mean``/``var`` ``running_mean``/``running_var``. Works on any subtree the
port has a module for (a ResNetEncoder's, a DepthDecoder's, a PoseNet's, a
whole MonodepthModel's or PSMNet's), given numpy arrays or anything
``np.asarray`` reads.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_MODULE_RULES = [
    (re.compile(r"^(BasicBlock|Bottleneck)_(\d+)$"), "blocks.{1}"),
    (re.compile(r"^ConvBlock_(\d+)$"), "convblocks.{0}"),
    (re.compile(r"^Conv_(\d+)$"), "convs.{0}"),
    (re.compile(r"^BatchNorm_(\d+)$"), "norms.{0}"),
    (re.compile(r"^dispconv_(\d+)$"), "dispconvs.{0}"),
    (re.compile(r"^(encoder|decoder|pose_net)$"), "{0}"),
    (re.compile(r"^FeatureExtractor_0$"), "features"),
    (re.compile(r"^ConvBnRelu_(\d+)$"), "blocks.{0}"),
    (re.compile(r"^Hourglass3D_(\d+)$"), "hourglasses.{0}"),
]
# kernel layouts by rank: flax's (spatial..., in, out) -> torch's (out, in, spatial...)
_KERNEL_AXES = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_LEAF_NAMES = {"kernel": "weight", "bias": "bias", "scale": "weight",
               "mean": "running_mean", "var": "running_var"}


def flatten(tree, prefix=()) -> dict:
    """Nested dicts -> {path tuple: leaf}."""
    if hasattr(tree, "items"):  # dict, FrozenDict
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, prefix + (k,)))
        return out
    return {prefix: tree}


def torch_key(path: tuple) -> str:
    """A flax variable path -> the port's state_dict key."""
    parts = []
    for name in path[:-1]:
        for pattern, fmt in _MODULE_RULES:
            m = pattern.match(name)
            if m:
                parts.append(fmt.format(*m.groups()))
                break
        else:
            raise KeyError(f"no rule for flax module {name!r} in {'/'.join(path)}")
    parts.append(_LEAF_NAMES[path[-1]])
    return ".".join(parts)


def _to_torch(path: tuple, value) -> torch.Tensor:
    """float64 stays float64 (a float64 run's state), the rest becomes float32."""
    a = np.asarray(value)
    a = np.array(a, dtype=np.float64 if a.dtype == np.float64 else np.float32)  # a copy
    if path[-1] == "kernel":
        a = a.transpose(_KERNEL_AXES[a.ndim])  # HWIO -> OIHW, DHWIO -> OIDHW
    return torch.from_numpy(np.ascontiguousarray(a))


def state_dict_from_flax(params, batch_stats=None) -> dict:
    """flax ``params`` (and ``batch_stats``) -> a state_dict for the
    port's module of the same structure."""
    out = {}
    for tree in (params, batch_stats or {}):
        for path, v in flatten(tree).items():
            out[torch_key(path)] = _to_torch(path, v)
    return out


def load_flax(module: torch.nn.Module, params, batch_stats=None) -> torch.nn.Module:
    """Copy flax variables into ``module`` (on its device); every key of
    the module must be covered, and every flax variable used."""
    sd = state_dict_from_flax(params, batch_stats)
    missing, unexpected = module.load_state_dict(sd, strict=False)
    if missing or unexpected:
        raise KeyError(f"flax variables do not fit the module: missing {missing}, "
                       f"unexpected {unexpected}")
    return module


def load_adam_state(optimizer: torch.optim.Adam, module: torch.nn.Module, mu, nu,
                    count: int) -> None:
    """optax ``scale_by_adam`` moments (``mu``, ``nu``: trees like the
    params) and its ``count`` -> ``optimizer``'s state for ``module``'s
    parameters, so that a restored run takes its next step as optax
    would."""
    named = dict(module.named_parameters())
    moments = {name: {} for name in named}
    for key, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
        for path, v in flatten(tree).items():
            moments[torch_key(path)][key] = _to_torch(path, v)
    for name, p in named.items():
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": moments[name]["exp_avg"].to(p.device),
            "exp_avg_sq": moments[name]["exp_avg_sq"].to(p.device),
        }


def tuple_from_numpy(cls, values, device):
    """The port's NamedTuple ``cls`` (`MissionConfig`, `KalmanParams`,
    `PIDController`, ...) from the JAX package's tuple of the same fields, or
    any sequence of them: each array, read with ``np.array``, becomes a
    tensor of its dtype on ``device``; Python numbers and tuples of numbers
    (gains) carry over."""
    def conv(v):
        if v is None or isinstance(v, (bool, int, float, str, tuple)):
            return v
        return torch.as_tensor(np.array(v), device=device)

    return cls(*(conv(v) for v in values))

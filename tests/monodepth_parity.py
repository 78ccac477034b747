"""Shared fixtures of the monocular parity tests (`tests/test_torch_models.py`,
`test_torch_training.py`, `test_torch_training_run.py`,
`test_torch_monocular.py`): random flax variables made from numpy, the
port's modules loaded with them, and the JAX package's training loss in
float64.

Flax's own initialisers are slow on the CPU (~11 s for a MonodepthModel,
jitted) and give trivial batch statistics (mean 0, variance 1), so the
variables here are drawn from numpy instead, on the shapes
``jax.eval_shape`` reports: every kernel, bias, scale and statistic random,
which exercises every field of the weight converter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpu3drec.models import monodepth as jm
from tpu3drec_torch.models.convert import load_flax


def random_variables(module, *args, seed: int = 0, method=None, **kwargs):
    """flax ``{"params", "batch_stats"}`` (numpy float32) for ``module``
    applied to ``args``: kernels normal with variance 1 / fan_in, biases
    and batch-norm shifts and means normal at 0.1, scales in [0.5, 1.5],
    variances in [0.5, 2]."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, method=method, **kwargs))

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.normal(size=shape) / np.sqrt(fan_in)
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, size=shape)
        elif name == "var":
            v = rng.uniform(0.5, 2.0, size=shape)
        else:  # bias, mean
            v = rng.normal(size=shape) * 0.1
        return np.asarray(v, np.float32)

    out = jax.tree_util.tree_map_with_path(fill, shapes)
    return {k: v for k, v in out.items()}


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def loaded(torch_module, variables):
    """``torch_module`` with ``variables`` copied in."""
    return load_flax(torch_module, variables["params"], variables.get("batch_stats"))


def t(x, dtype=torch.float32):
    """numpy/JAX array -> CPU tensor (a copy: JAX's arrays are read-only)."""
    return torch.as_tensor(np.array(x), dtype=dtype)


def nchw(x):
    return t(x).permute(0, 3, 1, 2)



def jax_loss64(params, batch_stats, batch, cfg, noise):
    """The JAX package's `_forward_loss` in float64: its modules, pose
    transforms and loss, as `_forward_loss` puts them together, without its
    float32 cast of the disparities. ``noise``: standard normal draws
    (sources, N, H, W) for the automask tiebreak. Returns (loss, the
    updated batch statistics)."""
    model = jm.MonodepthModel(dtype=jnp.float64)
    (disps, pose_prev, pose_next), new_state = model.apply(
        {"params": params, "batch_stats": batch_stats}, batch["target"], batch["prev"],
        batch["next"], with_pose=not cfg.use_gt_pose, method=jm.MonodepthModel.forward_train,
        mutable=["batch_stats"])
    if cfg.use_gt_pose:
        Ts = [jm.transformation_from_parameters(batch["gt_axisangle"][:, i],
                                                batch["gt_translation"][:, i]) for i in (0, 1)]
    else:
        Ts = [jm.transformation_from_parameters(*pose_prev, invert=True),
              jm.transformation_from_parameters(*pose_next)]
    sources = [batch["prev"], batch["next"]]
    if cfg.use_stereo:
        n = batch["target"].shape[0]
        T_s = jnp.tile(jnp.eye(4)[None], (n, 1, 1))
        Ts.append(T_s.at[:, 0, 3].set(batch["stereo_sign"] * cfg.stereo_baseline))
        sources.append(batch["stereo"])
    loss, _ = jm.monodepth_loss(disps, Ts, batch["target"], sources, cfg.loss,
                                identity_noise=noise * 1e-5)
    return loss, new_state["batch_stats"]

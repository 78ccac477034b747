"""Tensor-parallel parameter sharding over the mesh `model` axis (port of
`tpu3drec/parallel/tp.py`).

The reference shards the last dimension of a flax kernel, its output
channels, and lets GSPMD place the collectives. In PyTorch the output
channels are dim 0 of a `Conv2d`/`Conv3d`/`Linear` weight and dim 1 of a
`ConvTranspose` weight; `tp_param_shardings` applies the reference's tests
(at least 2 dims, the output channels divisible by the axis size, at least
``min_elems`` elements) to that dim.

`shard_params_tp` makes each such layer compute its slice of the output
channels on every rank of the axis and gathers the channels back, so the
activations after it are whole and replicated:

* the gather's backward is the rank's slice of the incoming gradient (the
  gradient after a replicated activation is the same on every rank, so a
  reduce-scatter, or `torch.distributed.nn`'s all-gather, whose backward
  sums, would multiply it by the axis size);
* the layer's input passes through an identity whose backward all-reduces
  the input gradient: each rank's slice of the weights contributes its part
  of it.

Replicated parameters then get the same gradient on every rank, and each
sharded weight the gradient of its slice.
"""

from __future__ import annotations

import torch
from torch import nn

from tpu3drec_torch.parallel.mesh import Mesh, all_gather, all_reduce

_OUT_DIM = {nn.Conv1d: 0, nn.Conv2d: 0, nn.Conv3d: 0, nn.Linear: 0,
            nn.ConvTranspose1d: 1, nn.ConvTranspose2d: 1, nn.ConvTranspose3d: 1}


def _out_dim(module: nn.Module):
    for cls, dim in _OUT_DIM.items():
        if type(module) is cls:
            return dim
    return None


def tp_param_shardings(model: nn.Module, mesh: Mesh, axis: str = "model",
                       min_elems: int = 1 << 14) -> dict:
    """{parameter name: the dim sharded over ``axis``, or None (replicated)}
    for every parameter of ``model``: weights of at least 2 dims whose
    output-channel dim divides by the axis size and that hold at least
    ``min_elems`` elements are sharded over that dim."""
    n = mesh.axis_size(axis)
    out = {}
    for mname, m in model.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            dim = _out_dim(m) if pname == "weight" else None
            if (dim is not None and p.ndim >= 2 and p.shape[dim] % n == 0
                    and p.numel() >= min_elems):
                out[name] = dim
            else:
                out[name] = None
    return out


class _CopyIn(torch.autograd.Function):
    """Identity whose backward sums the input gradient over the axis."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(ctx.mesh, g.contiguous(), ctx.axis), None, None


class _GatherOut(torch.autograd.Function):
    """All-gather of the ranks' channel slices along ``dim``; the backward
    is this rank's slice of the incoming gradient."""

    @staticmethod
    def forward(ctx, y, mesh, axis, dim):
        ctx.dim, ctx.index, ctx.width = dim, mesh.axis_index(axis), y.shape[dim]
        parts = all_gather(mesh, y.contiguous(), axis)  # (n, ...)
        return torch.cat(list(parts.unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.width, ctx.width).contiguous(), None, None, None


def shard_params_tp(model: nn.Module, mesh: Mesh, axis: str = "model", **kw) -> nn.Module:
    """Shard ``model``'s layers by `tp_param_shardings` in place: each
    sharded layer keeps its rank's slice of the weight (and bias) and
    gathers its output channels after the call. Build the optimizer after
    this call: the sharded weights are new parameters. Returns the model."""
    shardings = tp_param_shardings(model, mesh, axis=axis, **kw)
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    for mname, m in model.named_modules():
        dim = shardings.get(f"{mname}.weight" if mname else "weight")
        if dim is None or _out_dim(m) is None:
            continue
        w = m.weight
        c = w.shape[dim] // n
        m.weight = nn.Parameter(w.detach().narrow(dim, i * c, c).clone())
        if m.bias is not None:
            m.bias = nn.Parameter(m.bias.detach()[i * c:(i + 1) * c].clone())
        out_dim = -1 if isinstance(m, nn.Linear) else 1  # channels of the activation
        m.register_forward_pre_hook(
            lambda _m, args: (_CopyIn.apply(args[0], mesh, axis),) + tuple(args[1:]))
        m.register_forward_hook(
            lambda _m, _args, y, d=out_dim: _GatherOut.apply(y, mesh, axis, d))
        m.tp_dim = dim
    return model


def tp_state_dict(model: nn.Module, mesh: Mesh, axis: str = "model") -> dict:
    """The whole state dict of a model sharded by `shard_params_tp`, its
    sharded weights and biases gathered back, on every rank."""
    sd = {}
    for mname, m in model.named_modules():
        dim = getattr(m, "tp_dim", None)
        for pname, t in list(m.named_parameters(recurse=False)) + list(
                m.named_buffers(recurse=False)):
            name = f"{mname}.{pname}" if mname else pname
            if dim is not None and pname in ("weight", "bias"):
                d = dim if pname == "weight" else 0
                t = torch.cat(list(all_gather(mesh, t.detach().contiguous(), axis).unbind(0)),
                              dim=d)
            sd[name] = t.detach()
    return sd

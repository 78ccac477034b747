"""Parity of the port's data- and tensor-parallel training steps
(`models/training.py::make_train_step(mesh=)`,
`models/psmnet_training.py::make_stereo_train_step(mesh=)`, the global-batch
batch norm of `models/resnet.py`, `parallel/tp.py`) with the JAX package's:
the steps of `tests/test_parallel.py::TestTensorParallel` and of the
data-parallel training that `tests/test_multihost.py` runs across hosts.

One world of 4 gloo ranks on the CPU (`tests/torch_world.py`) runs every
rank-side check once for the module; each test holds the ranks' results
against the JAX function, run here on conftest's 8 CPU devices. The ranks
import no JAX.

Tolerances:
- data-parallel monocular step, one sample a rank, float64: loss within
  1e-12 relative and gradients within 1e-6 of each tensor's largest of the
  JAX package's batch-4 gradients; the same step with a rank-local batch
  norm is more than 1e-6 off in the loss and more than 10% in some
  gradient (it is a different model);
- data-parallel stereo step, one sample a rank, float64: loss within
  1e-9 relative and gradients within 1e-6 of each tensor's largest of the
  JAX package's batch-4 step (`tests/test_torch_stereo.py`'s bounds; the
  last convolution's bias, whose gradient the softmax cancels to 0 up to
  rounding, against 1e-9 of the model's largest); and, as an extra check,
  within 1e-9 of the port's single-process batch-4 step (of each tensor's
  largest, or of 1e-6 for the biases before a batch norm, 0 up to
  rounding);
- tensor-parallel step (model=2), against the JAX package's step on the
  same flax parameters, in float64: loss within 1e-12 relative and
  gradients within 1e-6 of each tensor's largest (the monocular step's
  bounds); the float32 step's loss within 1e-4 relative of it (the JAX
  test's); and, as extra checks, the float32 step against the port's
  replicated step: loss within 1e-4 relative, gradients within 1e-4 of
  each tensor's largest, a sharded
  weight's update equal to torch's Adam on the step's own gathered
  gradient within 1e-3 of lr plus 4 float32 ulps (a first Adam step is lr
  times the sign of the gradient, so the two steps' updates part wherever
  a gradient is within rounding of 0); the sharded parameter set equal by
  name to the JAX package's.
"""

import functools
import os
import sys

import numpy as np
import pytest

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_world import run_world  # noqa: E402

WORLD = 4
MONO_HW = (32, 64)
STEREO = dict(height=32, width=64, max_disp=16, feat_ch=8)


# --------------------------------------------------------------- rank side


def _unflatten(inp, prefix):
    tree = {}
    for k, v in inp.items():
        if k.startswith(prefix + "/"):
            node = tree
            parts = k[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    return tree


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _rank_mono_dp(mesh, inp):
    """One sample a rank, float64, with the batch norms over the global
    batch and, as the control, over each rank's own sample."""
    import contextlib

    import torch

    from tpu3drec_torch.models import training as tt
    from tpu3drec_torch.models.convert import load_flax
    from tpu3drec_torch.parallel.mesh import shard_batch

    H, W = MONO_HW
    cfg = tt.TrainConfig(height=H, width=W, batch_size=1)
    out = {}
    for tag in ("dp", "local_bn"):
        model, state = tt.init_state(0, cfg, 10, device="cpu")
        load_flax(model, _unflatten(inp, "mono/params"), _unflatten(inp, "mono/batch_stats"))
        model.double()
        state.optimizer = tt.make_optimizer(cfg, model.parameters())
        batch = {k: shard_batch(mesh, inp[f"mono_{k}"], "space").double()
                 for k in ("target", "prev", "next")}
        step = tt.make_train_step(cfg, mesh=mesh, axis="space")
        saved = tt.global_batch
        if tag == "local_bn":  # the control: batch norms over each rank's sample only
            tt.global_batch = lambda m, a: contextlib.nullcontext()
        try:
            _, loss, _ = step(state, batch, noise=torch.as_tensor(inp["mono_noise"]))
        finally:
            tt.global_batch = saved
        out[f"mono_{tag}_loss"] = loss.numpy()
        for n, g in _grads(model).items():
            out[f"mono_{tag}_grad/{n}"] = g.numpy()
        out[f"mono_{tag}_stat"] = model.encoder.norms[0].running_var.numpy()
    return out


def _rank_stereo_dp(mesh, inp, rank):
    import torch

    from tpu3drec_torch.models import psmnet_training as pt
    from tpu3drec_torch.models.convert import load_flax
    from tpu3drec_torch.parallel.mesh import shard_batch

    cfg = pt.StereoTrainConfig(batch_size=WORLD, **STEREO)
    out = {}
    batch = {k: inp[f"st_{k}"] for k in ("left", "right", "disp", "mask")}
    runs = [("dp", mesh, {k: shard_batch(mesh, v, "space") for k, v in batch.items()})]
    if rank == 0:
        runs.append(("single", None, batch))
    for tag, m, b in runs:
        model, state = pt.init_stereo_state(3, cfg, device="cpu")
        load_flax(model, _unflatten(inp, "st/params"), _unflatten(inp, "st/batch_stats"))
        model.double()
        state.optimizer = pt.make_optimizer(cfg, model.parameters())
        _, loss = pt.make_stereo_train_step(cfg, mesh=m, axis="space")(state, b)
        out[f"st_{tag}_loss"] = torch.as_tensor(loss).numpy()
        for n, g in _grads(model).items():
            out[f"st_{tag}_grad/{n}"] = g.numpy()
    return out


def _rank_tp(inp):
    """model=2 tensor parallelism on a (data=2, model=2) mesh: the sharded
    parameter set, and one step of the sharded model against the same step
    replicated."""
    import torch

    from tpu3drec_torch.models import training as tt
    from tpu3drec_torch.models.convert import load_flax
    from tpu3drec_torch.parallel.mesh import all_gather, make_mesh
    from tpu3drec_torch.parallel.tp import shard_params_tp, tp_param_shardings, tp_state_dict

    mesh = make_mesh(data=0, model=2, device="cpu")
    H, W = MONO_HW
    cfg = tt.TrainConfig(height=H, width=W, batch_size=4)
    batch = {k: inp[f"tp_{k}"] for k in ("target", "prev", "next")}
    noise = torch.as_tensor(inp["tp_noise"])
    out = {}
    for tag in ("repl", "tp", "tp64"):
        model, state = tt.init_state(0, cfg, 10, device="cpu")
        load_flax(model, _unflatten(inp, "mono/params"), _unflatten(inp, "mono/batch_stats"))
        names = sorted(n for n, dim in tp_param_shardings(model, mesh).items() if dim is not None)
        out["tp_w0"] = model.state_dict()[names[0]].numpy().copy()
        b, nz = batch, noise
        if tag == "tp64":
            model.double()
            b = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in batch.items()}
            nz = noise.double()
        if tag != "repl":
            out["tp_names"] = np.array(names)
            shard_params_tp(model, mesh)
        state.optimizer = tt.make_optimizer(cfg, model.parameters())
        _, loss, _ = tt.make_train_step(cfg)(state, b, noise=nz)
        out[f"tp_{tag}_loss"] = loss.numpy()
        for mname, m in model.named_modules():
            for pname, p in m.named_parameters(recurse=False):
                g = p.grad
                dim = getattr(m, "tp_dim", None)
                if dim is not None and pname in ("weight", "bias"):
                    g = torch.cat(list(all_gather(mesh, g.contiguous(), "model").unbind(0)),
                                  dim=dim if pname == "weight" else 0)
                out[f"tp_{tag}_grad/{mname}.{pname}"] = g.numpy()
        # a sharded weight after the Adam update, gathered
        sd = tp_state_dict(model, mesh) if tag != "repl" else model.state_dict()
        out[f"tp_{tag}_w"] = sd[names[0]].numpy()
    return out


def _rank_main(argv):
    from torch_world import join

    from tpu3drec_torch.parallel.mesh import make_mesh

    rank, world, d = join(argv)
    inp = dict(np.load(os.path.join(d, "inputs.npz")))
    mesh = make_mesh(data=1, space=world, device="cpu")
    out = {}
    out.update(_rank_mono_dp(mesh, inp))
    out.update(_rank_stereo_dp(mesh, inp, rank))
    out.update(_rank_tp(inp))
    np.savez(os.path.join(d, f"rank{rank}.npz"), **out)


# -------------------------------------------------------------- parent side


def _flat(prefix, tree, out):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            _flat(f"{prefix}/{k}", v, out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)


def _inputs():
    import jax.numpy as jnp

    from monodepth_parity import random_variables
    from tpu3drec.models import monodepth as jm
    from tpu3drec.models import psmnet as jp

    rng = np.random.default_rng(1)
    inp = {}
    H, W = MONO_HW
    d0 = jnp.zeros((1, H, W, 3))
    v = random_variables(jm.MonodepthModel(), d0, [d0, d0], seed=5)
    _flat("mono/params", v["params"], inp)
    _flat("mono/batch_stats", v["batch_stats"], inp)
    for k in ("target", "prev", "next"):
        inp[f"mono_{k}"] = rng.uniform(size=(WORLD, H, W, 3))
        inp[f"tp_{k}"] = rng.uniform(size=(4, H, W, 3)).astype(np.float32)
    inp["mono_noise"] = rng.normal(size=(2, WORLD, H, W))
    inp["tp_noise"] = rng.normal(size=(2, 4, H, W)).astype(np.float32)

    sh, sw = STEREO["height"], STEREO["width"]
    inp["st_left"] = rng.uniform(size=(WORLD, sh, sw, 3))
    inp["st_right"] = np.roll(inp["st_left"], -3, axis=2)
    inp["st_disp"] = rng.uniform(0, STEREO["max_disp"] - 1, size=(WORLD, sh, sw))
    inp["st_mask"] = (rng.uniform(size=(WORLD, sh, sw)) > 0.2).astype(np.float64)
    left = jnp.zeros((1, sh, sw, 3))
    v_st = random_variables(jp.PSMNet(max_disp=STEREO["max_disp"], feat_ch=STEREO["feat_ch"]),
                            left, left, train=False, seed=6)
    _flat("st/params", v_st["params"], inp)
    _flat("st/batch_stats", v_st["batch_stats"], inp)
    return inp, v, v_st


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_parallel_training")
    inp, variables, stereo_variables = _inputs()
    np.savez(d / "inputs.npz", **inp)
    ranks = run_world(os.path.abspath(__file__), d, world=WORLD, timeout=420)
    return inp, variables, ranks, stereo_variables


@functools.lru_cache(maxsize=None)
def _jax_mono_value_and_grad(batch_size: int):
    """The JAX package's float64 monocular loss and its gradients at
    MONO_HW, jitted once for the file's tests (`monodepth_parity.jax_loss64`;
    arguments: params, batch_stats, batch, noise)."""
    import jax

    from monodepth_parity import jax_loss64
    from tpu3drec.models import training as jt

    H, W = MONO_HW
    cfg = jt.TrainConfig(height=H, width=W, batch_size=batch_size)
    return jax.jit(jax.value_and_grad(lambda p, s, b, n: jax_loss64(p, s, b, cfg, n)[0]))


def _f64(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), tree)


def _torch_layout(g):
    """A flax kernel's gradient in torch's (out, in, *spatial) layout."""
    if g.ndim == 4:
        return g.transpose(3, 2, 0, 1)
    if g.ndim == 5:
        return g.transpose(4, 3, 0, 1, 2)
    return g


def _jax_grads(grads):
    from tpu3drec_torch.models.convert import flatten, torch_key

    return {torch_key(p): _torch_layout(np.asarray(g)) for p, g in flatten(grads).items()}


def test_data_parallel_monodepth_step_matches_jax(world):
    """One sample a rank: the global-batch batch norm makes 4 ranks the
    JAX package's batch-4 step (float64 loss and gradients); a rank-local
    batch norm does not."""
    import jax
    import jax.numpy as jnp

    inp, v, ranks, _ = world
    batch = {k: inp[f"mono_{k}"] for k in ("target", "prev", "next")}

    with jax.enable_x64(True):
        jloss, jgrads = _jax_mono_value_and_grad(WORLD)(
            _f64(v["params"]), _f64(v["batch_stats"]), _f64(batch),
            jnp.asarray(inp["mono_noise"], jnp.float64))
        jgrads = _jax_grads(jgrads)
    jloss = float(jloss)
    for r in ranks:
        assert abs(float(r["mono_dp_loss"]) - jloss) <= 1e-12 * abs(jloss)
        n_grads = 0
        for name, g in jgrads.items():
            got = r.get(f"mono_dp_grad/{name}")
            if got is None:
                assert not np.any(g), name
                continue
            assert np.abs(got - g).max() <= 1e-6 * np.abs(g).max(), name
            n_grads += 1
        assert n_grads > 100
        # the control: a rank-local batch norm is another model, its loss a
        # million times the tolerance away and some gradients far off
        assert abs(float(r["mono_local_bn_loss"]) - jloss) > 1e-6 * abs(jloss)
        worst = max(np.abs(r[f"mono_local_bn_grad/{n}"] - g).max() / np.abs(g).max()
                    for n, g in jgrads.items() if np.any(g))
        assert worst > 0.1, worst
    # the running statistics were updated from the global batch on every rank
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["mono_dp_stat"], ranks[0]["mono_dp_stat"])


def test_data_parallel_stereo_step_matches_jax(world):
    """One sample a rank: the global-batch batch norm and the global
    masked mean make 4 ranks the JAX package's batch-4 PSMNet step
    (float64 loss and gradients)."""
    import jax
    import jax.numpy as jnp

    from tpu3drec.models import psmnet as jp

    inp, _, ranks, v = world
    with jax.enable_x64(True):
        jmodel = jp.PSMNet(max_disp=STEREO["max_disp"], feat_ch=STEREO["feat_ch"],
                           dtype=jnp.float64)
        stats = _f64(v["batch_stats"])

        def loss_fn(p, left, right, gt, mask):
            disp, _ = jmodel.apply({"params": p, "batch_stats": stats}, left, right, train=True,
                                   mutable=["batch_stats"])
            return jp.smooth_l1_loss(disp, gt, mask)

        jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
            _f64(v["params"]), *(jnp.asarray(inp[f"st_{k}"], jnp.float64)
                                 for k in ("left", "right", "disp", "mask")))
        jgrads = _jax_grads(jgrads)
    jloss = float(jloss)
    g_max = max(np.abs(g).max() for g in jgrads.values())
    for r in ranks:
        assert abs(float(r["st_dp_loss"]) - jloss) <= 1e-9 * abs(jloss)
        for name, g in jgrads.items():
            # the last convolution's bias shifts every disparity's logit
            # alike, which the softmax cancels: 0 up to rounding
            scale = np.abs(g).max() if name != "convs.1.bias" else 1e-9 * g_max
            assert np.abs(r[f"st_dp_grad/{name}"] - g).max() <= 1e-6 * scale, name


def test_data_parallel_stereo_step_matches_single(world):
    _, _, ranks, _ = world
    ref = ranks[0]
    for r in ranks:
        assert abs(float(r["st_dp_loss"]) - float(ref["st_single_loss"])) <= \
            1e-9 * abs(float(ref["st_single_loss"]))
        keys = [k for k in ref if k.startswith("st_single_grad/")]
        assert len(keys) > 10
        for k in keys:
            # biases before a batch norm have a gradient of 0 up to rounding:
            # a floor of 1e-15 on the bound
            g, got = ref[k], r[k.replace("st_single", "st_dp")]
            assert np.abs(got - g).max() <= 1e-9 * max(np.abs(g).max(), 1e-6), k


def test_tp_parameter_set_equals_jax(world):
    """The parameters the port shards are, by name, those whose flax
    kernels the JAX package shards (output channels over model=2)."""
    from tpu3drec.parallel.tp import tp_param_shardings
    from tpu3drec_torch.models.convert import flatten, torch_key

    _, v, ranks, _ = world
    from tpu3drec.parallel.mesh import make_mesh

    mesh = make_mesh(data=4, space=1, model=2)
    sh = tp_param_shardings(v["params"], mesh)
    ref = sorted(torch_key(p) for p, s in flatten(sh).items() if s.spec != ())
    assert len(ref) > 5
    for r in ranks:
        assert list(r["tp_names"]) == ref


def test_tp_step_matches_jax(world):
    """The port's model=2 step against the JAX package's step on the same
    flax parameters, batch and automask noise: the replicated step, which
    `tests/test_parallel.py::TestTensorParallel` holds the JAX package's
    model=2 placement to (within 1e-4); one jitted loss serves this test
    and the monocular one, so the file stays near a minute and a half."""
    import jax
    import jax.numpy as jnp

    inp, v, ranks, _ = world
    batch = {k: inp[f"tp_{k}"] for k in ("target", "prev", "next")}
    with jax.enable_x64(True):
        jloss, jgrads = _jax_mono_value_and_grad(4)(
            _f64(v["params"]), _f64(v["batch_stats"]), _f64(batch),
            jnp.asarray(inp["tp_noise"], jnp.float64))
        jgrads = _jax_grads(jgrads)
    jloss = float(jloss)
    for r in ranks:
        assert abs(float(r["tp_tp64_loss"]) - jloss) <= 1e-12 * abs(jloss)
        assert abs(float(r["tp_tp_loss"]) - jloss) <= 1e-4 * abs(jloss)
        n_grads = 0
        for name, g in jgrads.items():
            got = r.get(f"tp_tp64_grad/{name}")
            if got is None:
                assert not np.any(g), name
                continue
            assert got.shape == g.shape, name
            assert np.abs(got - g).max() <= 1e-6 * np.abs(g).max(), name
            n_grads += 1
        assert n_grads > 100


def test_tp_step_matches_replicated(world):
    import torch

    _, _, ranks, _ = world
    for r in ranks:
        lr, lt = float(r["tp_repl_loss"]), float(r["tp_tp_loss"])
        assert abs(lt - lr) <= 1e-4 * abs(lr)
        keys = [k for k in r if k.startswith("tp_repl_grad/")]
        for k in keys:
            g, got = r[k], r[k.replace("tp_repl", "tp_tp")]
            assert got.shape == g.shape, k
            assert np.abs(got - g).max() <= 1e-4 * max(np.abs(g).max(), 1e-12), k
        # the Adam update of a sharded weight, gathered: torch's Adam fed
        # the step's own (gathered) gradient, within 1e-3 of lr plus 4
        # float32 ulps (chip_smoke.py phase 10's bound), for both steps
        name = str(r["tp_names"][0])
        for tag in ("repl", "tp"):
            w = torch.tensor(r["tp_w0"], requires_grad=True)
            w.grad = torch.tensor(r[f"tp_{tag}_grad/{name}"])
            torch.optim.Adam([w], lr=1e-5, betas=(0.9, 0.999), eps=1e-8).step()
            want = w.detach().numpy()
            excess = np.abs(r[f"tp_{tag}_w"] - want) - (1e-3 * 1e-5 + 4 * np.finfo(
                np.float32).eps * np.abs(want))
            assert excess.max() <= 0, (tag, excess.max())


if __name__ == "__main__":
    _rank_main(sys.argv)

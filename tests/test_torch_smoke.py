"""The port's smoke script and import rules, checked on the CPU.

* `chip_smoke.py --rehearse-cpu` runs phases 3-16 at a tiny size with the
  plain versions and exits 0.
* Without a card, and in a directory that holds `chip_smoke.py` and
  nothing else of the repo, it exits non-zero and prints no result.
* Neither the port (its Python, CUDA and C++ sources), the script nor the
  port's tools (`tools/ate_torch.py`, `train_convergence_torch.py`,
  `trace_monocular.py`, `twin_runs_torch.py`, `grad_accuracy_torch.py`,
  `stereo_convergence_torch.py`, `trace_stereo_mvs.py`,
  `dryrun_multichip_torch.py`) imports JAX, flax, optax, orbax, the
  JAX package, PIL or cv2 at module level, or `torch.utils.cpp_extension`.
* On a card (marker `gpu`), the ICP-NN, matcher and BA-blocks kernels
  equal their plain versions bit for bit, and a monodepth train step, a
  PSMNet train step, a plane sweep and an occupancy scan on the card agree
  with the same on the CPU; point-to-plane ICP launches the ICP-NN kernel
  once an iteration; as 2 gloo ranks sharing the card, the ring search
  launches the ICP-NN kernel once a step and equals the single-process
  kernel, and the transfer helper stages each CUDA tensor through host
  memory and counts its bytes. This file imports no JAX, so on a machine without it the test
  runs as `PYTHONPATH=. python -m pytest --noconftest -m gpu
  tests/test_torch_smoke.py` (tests/conftest.py imports JAX).
"""

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu3drec_torch.ops import ba_blocks, icp_nn, matcher

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "chip_smoke.py")
PORT = os.path.join(ROOT, "tpu3drec_torch")


def _run(args, cwd):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_rehearsal_on_cpu():
    p = _run([SMOKE, "--rehearse-cpu"], ROOT)
    assert p.returncode == 0, p.stdout + p.stderr
    lines = p.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "rehearsal": "cpu"}
    kernels = json.loads(lines[-2])["kernels"]
    assert [k["name"] for k in kernels] == ["icp_nn", "matcher", "ba_blocks"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for k in kernels:
        assert keys <= set(k), (k["name"], keys - set(k))
    for phase in ("kernel_vs_plain", "fusion", "icp", "matcher_vs_plain",
                  "ba_blocks_vs_plain", "ba_solve", "sfm", "long_sequence", "monocular",
                  "stereo", "mvs", "occupancy", "point_to_plane", "serve", "autonomy"):
        assert any(line.startswith(f"[phase {phase}] ok") for line in lines), phase
    fusion = next(line for line in lines if line.startswith("[phase fusion] ok"))
    for key in ("run_arrays_s=", "run_arrays_s_python=", "ascii_ply_s_native="):
        assert key in fusion, key
    names = ["monocular", "stereo", "mvs", "occupancy", "point_to_plane", "serve", "autonomy"]
    assert [line.split(" ", 1)[0] for line in lines[-9:-2]] == names
    mono, stereo, mvs, occ, p2p, serve, auto = (json.loads(line.split(" ", 1)[1])
                                                for line in lines[-9:-2])
    assert kernels[0]["launches_by_path"]["point_to_plane"] == p2p["launches"]
    assert occ["bt_card_equals_cpu"] and occ["free"] > occ["occupied"] > 0
    for key in ("scan_s_mean", "merge_s_mean", "s_per_frame", "peak_gib"):
        assert key in occ, key
    for key in ("normals_s", "core_s", "T_err", "sub_T_card_vs_cpu", "normals_within_1e4"):
        assert key in p2p, key
    assert serve["points"] > 0 and serve["frames_per_s"] > 0
    assert auto["final_phase"] == 9 and auto["perception"]["decode_marker"]["marker_id"] == [451, 451]
    for key in ("loss_rel_diff", "train_ms_f32", "train_ms_bf16", "infer_fps_64x96",
                "depth_rel_diff", "fused_points"):
        assert key in mono, key
    assert mono["fused_points"] > 0 and mono["steps"] == 3
    for key in ("loss_rel_diff", "grad_err_card", "train_ms_f32", "train_ms_bf16", "infer_fps",
                "disp_rel_diff", "fused_points"):
        assert key in stereo, key
    assert stereo["cli_steps"] == 3 and stereo["fused_points"] > 0
    for key in ("sweep_s", "consist_s", "fuse_s", "mesh_s", "sweep_ms_per_view", "grid",
                "grid_bytes", "verts", "faces", "within_3_voxels", "sweep_winners_agree"):
        assert key in mvs, key
    assert mvs["within_3_voxels"] >= 0.9
    for line in (mono, stereo, mvs, occ, serve, auto):
        assert not any(line["kernel_launches"].values())


def test_no_card_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = _run([SMOKE], ROOT)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


def test_script_alone_fails(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    p = _run(["chip_smoke.py"], str(tmp_path))
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


_FORBIDDEN = [
    (re.compile(r"^\s*(import|from)\s+jax\b", re.M), "imports jax"),
    (re.compile(r"^\s*(import|from)\s+(flax|optax|orbax)\b", re.M), "imports flax/optax/orbax"),
    (re.compile(r"^\s*(import|from)\s+tpu3drec(?!_torch)\b", re.M), "imports the JAX package"),
    (re.compile(r"\btpu3drec\."), "names a tpu3drec. module"),
    (re.compile(r"^(import|from)\s+(PIL|cv2)\b", re.M), "imports PIL/cv2 at module level"),
    (re.compile(r"cpp_extension"), "uses torch.utils.cpp_extension"),
]


def _sources():
    out = [SMOKE, os.path.join(ROOT, "tools", "ate_torch.py"),
           os.path.join(ROOT, "tools", "train_convergence_torch.py"),
           os.path.join(ROOT, "tools", "trace_monocular.py"),
           os.path.join(ROOT, "tools", "twin_runs_torch.py"),
           os.path.join(ROOT, "tools", "grad_accuracy_torch.py"),
           os.path.join(ROOT, "tools", "stereo_convergence_torch.py"),
           os.path.join(ROOT, "tools", "trace_stereo_mvs.py"),
           os.path.join(ROOT, "tools", "dryrun_multichip_torch.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith((".py", ".cu", ".cuh", ".cpp"))]
    return out


@pytest.mark.parametrize("rule", range(len(_FORBIDDEN)))
def test_port_import_rules(rule):
    pattern, what = _FORBIDDEN[rule]
    hits = []
    for path in _sources():
        with open(path) as f:
            text = f.read()
        if path.endswith(".py"):
            # code only: the docstrings and comments name the JAX files they port
            text = "\n".join(line for line in text.splitlines()
                             if not line.lstrip().startswith("#"))
            text = re.sub(r'"""[\s\S]*?"""', "", text)
        else:
            text = re.sub(r"//.*", "", text)
        hits += [os.path.relpath(path, ROOT) for _ in pattern.finditer(text)]
    assert not hits, f"{what}: {sorted(set(hits))}"


@pytest.mark.gpu
@pytest.mark.parametrize("nq,nr", [(1, 1), (1000, 3001), (777, 500), (76_800, 76_800),
                                   (5_000, 5), (76_800, 20), (513, 76_801)])
def test_kernel_matches_plain_on_the_card(nq, nr):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.normal(size=(nq, 3)), dtype=torch.float32, device="cuda")
    r = torch.as_tensor(rng.normal(size=(nr, 3)), dtype=torch.float32, device="cuda")
    before = icp_nn.launches
    idx, d2 = icp_nn.nearest_neighbors_cuda(q, r)
    pidx, pd2 = icp_nn.nearest_neighbors_plain(q, r)
    torch.cuda.synchronize()
    assert icp_nn.launches == before + 1
    # the kernel rounds each product and sum on its own, like the plain version
    assert torch.equal(d2, pd2)
    assert torch.equal(idx, pidx)


@pytest.mark.gpu
@pytest.mark.parametrize("nq", [1, 1000, 76_800])
def test_kernel_ties_across_splits_on_the_card(nq):
    """Exact duplicates of every reference one split apart, and queries on
    them: each tie goes to the lower index, across the atomic merge."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(3)
    nr = 76_800
    splits, chunk = icp_nn.launch_plan(nq, nr, torch.device("cuda"))
    assert splits > 1
    base = rng.integers(-20, 20, size=(chunk, 3)).astype(np.float32)
    r = np.concatenate([base] * (-(-nr // chunk)))[:nr][::-1].copy()
    q = np.concatenate([r[chunk - 3:chunk + 3], rng.integers(-20, 20, size=(nq, 3))])[:nq]
    q = torch.as_tensor(q + np.float32(0.5) * (np.arange(nq) % 2)[:, None], dtype=torch.float32,
                        device="cuda")
    r = torch.as_tensor(r, device="cuda")
    before = icp_nn.launches
    idx, d2 = icp_nn.nearest_neighbors_cuda(q, r)
    pidx, pd2 = icp_nn.nearest_neighbors_plain(q, r)
    torch.cuda.synchronize()
    assert icp_nn.launches == before + 1
    assert torch.equal(d2, pd2)
    assert torch.equal(idx, pidx)


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.gpu
@pytest.mark.parametrize("p,ka,kb,d", [(1, 1, 1, 128), (1, 300, 2049, 128), (3, 129, 64, 32),
                                       (30, 512, 512, 128), (8, 4096, 4096, 128)])
def test_matcher_kernel_matches_plain_on_the_card(p, ka, kb, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(1)
    a = torch.as_tensor(_unit(rng, p, ka, d), device="cuda")
    b = torch.as_tensor(_unit(rng, p, kb, d), device="cuda")
    v = torch.as_tensor(rng.random((p, kb)) >= 0.1, device="cuda")
    v[0, :] = p == 1  # with several pairs, the first has no valid reference
    before = matcher.launches
    best, top2 = matcher.topk2_scores_batched(a, b, v)
    pbest, ptop2 = matcher.topk2_scores_batched_plain(a, b, v)
    torch.cuda.synchronize()
    assert matcher.launches == before + 1
    # the same summation order over d, each product and sum rounded alone
    assert torch.equal(best, pbest)
    assert torch.equal(top2, ptop2)


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 17, 64, 128])
def test_matcher_long_sequence_shapes_on_the_card(p):
    """The long-sequence path's shapes: a bridging pair (P = 1), loop-closure
    candidates (P <= 64) and the global BA's chunks (P = 128), 512
    keypoints, each frame's valid rows a ragged prefix as the detector pads
    them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(5)
    a = torch.as_tensor(_unit(rng, p, 512, 128), device="cuda")
    b = torch.as_tensor(_unit(rng, p, 512, 128), device="cuda")
    v = torch.as_tensor(np.arange(512)[None] < rng.integers(200, 513, (p, 1)), device="cuda")
    before = matcher.launches
    best, top2 = matcher.topk2_scores_batched(a, b, v)
    pbest, ptop2 = matcher.topk2_scores_batched_plain(a, b, v)
    torch.cuda.synchronize()
    assert matcher.launches == before + 1
    assert torch.equal(best, pbest)
    assert torch.equal(top2, ptop2)


@pytest.mark.gpu
def test_matcher_repeated_pairs_on_the_card():
    """P = 128 with every pair the same, as `sfm/global_refine.py` pads a
    short chunk with its first pair: every row equals the plain version's
    and each other."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(6)
    a = torch.as_tensor(_unit(rng, 1, 512, 128), device="cuda").expand(128, -1, -1).contiguous()
    b = torch.as_tensor(_unit(rng, 1, 512, 128), device="cuda").expand(128, -1, -1).contiguous()
    v = torch.as_tensor(np.arange(512) < 431, device="cuda")[None].expand(128, -1).contiguous()
    best, top2 = matcher.topk2_scores_batched(a, b, v)
    pbest, ptop2 = matcher.topk2_scores_batched_plain(a, b, v)
    torch.cuda.synchronize()
    assert torch.equal(best, pbest) and torch.equal(top2, ptop2)
    assert bool((best == best[:1]).all()) and bool((top2 == top2[:1]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("p,ka,kb,d", [(1, 300, 1000, 128), (2, 200, 777, 128), (4, 512, 512, 128),
                                       (1, 65, 300, 20)])
def test_matcher_splits_on_the_card(p, ka, kb, d):
    """Kb off the tile, exact ties one split apart, and a split with no
    valid reference: the kernel's split-and-merge against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(4)
    splits, cut = matcher.launch_plan(p, ka, kb, torch.device("cuda"))
    assert splits > 1
    b = _unit(rng, p, kb, d)
    b[:, cut:cut + 40] = b[:, cut - 40:cut]  # exact ties across the first boundary
    a = np.concatenate([b[:, cut - 40:cut], _unit(rng, p, ka, d)], 1)[:, :ka]
    v = rng.random((p, kb)) >= 0.1
    v[:, cut - 40:cut + 40] = True
    if splits >= 3:
        v[:, 2 * cut:3 * cut] = False  # a split with no valid reference
    else:
        v[-1, cut:] = False
    a, b, v = (torch.as_tensor(x, device="cuda") for x in (a, b, v))
    before = matcher.launches
    best, top2 = matcher.topk2_scores_batched(a, b, v)
    pbest, ptop2 = matcher.topk2_scores_batched_plain(a, b, v)
    torch.cuda.synchronize()
    assert matcher.launches == before + 1
    assert torch.equal(best, pbest)
    assert torch.equal(top2, ptop2)
    # the tied queries take the lower index, the one before the boundary
    assert bool((best[:, :40] == cut - 40 + torch.arange(40, device="cuda")).all())


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("n", [1, 31, 33, 511, 513, 65_536, 262_144])
def test_ba_blocks_kernel_matches_plain_on_the_card(n, shift):
    """With shift 1 every input starts 4 bytes past a 16-byte boundary,
    which the kernel copies 4 bytes at a time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(2)

    def t(x):  # on the card, `shift` floats into a fresh buffer
        x = np.asarray(x, np.float32)
        flat = torch.empty(x.size + shift, dtype=torch.float32, device="cuda")
        flat[shift:] = torch.as_tensor(x.ravel())
        return flat[shift:].view(x.shape)

    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w_, x_, y_, z_ = q.T
    R = np.stack([1 - 2 * (y_ * y_ + z_ * z_), 2 * (x_ * y_ - w_ * z_), 2 * (x_ * z_ + w_ * y_),
                  2 * (x_ * y_ + w_ * z_), 1 - 2 * (x_ * x_ + z_ * z_), 2 * (y_ * z_ - w_ * x_),
                  2 * (x_ * z_ - w_ * y_), 2 * (y_ * z_ + w_ * x_), 1 - 2 * (x_ * x_ + y_ * y_)],
                 -1).reshape(n, 3, 3)
    Xc = rng.uniform([-2, -2, 3], [2, 2, 12], size=(n, 3))
    Xc[0] = [1e-12, -1e-12, 0.0]  # the z clamp, with finite blocks
    ins = (t(Xc), t(R), t(rng.uniform([0, 0], [640, 480], size=(n, 2))),
           t(rng.uniform(0.1, 1.0, size=n)))
    assert all(x.data_ptr() % 16 == 4 * shift for x in ins)
    intr = (500.0, 510.0, 320.0, 240.0)
    before = ba_blocks.launches
    out = ba_blocks.ba_blocks(*ins, intr)
    ref = ba_blocks.ba_blocks_plain(*ins, intr)
    torch.cuda.synchronize()
    assert ba_blocks.launches == before + 1
    for key in ref:
        assert torch.equal(out[key], ref[key]), key


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 513])
def test_ba_blocks_outputs_share_one_aligned_buffer_on_the_card(n):
    """The eight outputs are views of one buffer: each starts on a 16-byte
    boundary, none overlaps another, and together they lie inside it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    t = lambda *s: torch.rand(*s, dtype=torch.float32, device="cuda") + 1  # noqa: E731
    out = ba_blocks.ba_blocks_cuda(t(n, 3), t(n, 3, 3), t(n, 2), t(n), (500.0, 510.0, 320.0, 240.0))
    torch.cuda.synchronize()
    storage = {x.untyped_storage().data_ptr() for x in out.values()}
    assert len(storage) == 1
    base = storage.pop()
    nbytes = out["res"].untyped_storage().nbytes()
    spans = sorted((x.data_ptr(), x.data_ptr() + 4 * x.numel()) for x in out.values())
    for (start, end), (nxt, _) in zip(spans, spans[1:] + [(base + nbytes, None)]):
        assert start % 16 == 0
        assert base <= start < end <= nxt
    for key, x in out.items():
        assert x.is_contiguous(), key


@pytest.mark.gpu
@pytest.mark.parametrize("gt_pose", [True, False])
def test_monodepth_step_card_matches_cpu(gt_pose):
    """One train step of the full MonodepthModel (float32, IEEE on the
    card) from the same seeded weights, batch and automask noise on the
    card and on the CPU: loss within 1e-5 relative, batch statistics within
    1e-5, the same tensors updated, and the card's update that of torch's
    single-tensor Adam on the CPU fed the card's gradients (within 1e-3 of
    lr plus 4 float32 ulps of the weight)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpu3drec_torch.models.training import (
        TrainConfig, init_state, make_optimizer, make_train_step)

    h, w, n = 64, 96, 2
    rng = np.random.default_rng(0)
    batch = {k: rng.uniform(size=(n, h, w, 3)).astype(np.float32)
             for k in ("target", "prev", "next")}
    batch["gt_axisangle"] = (rng.normal(size=(n, 2, 3)) * 0.05).astype(np.float32)
    batch["gt_translation"] = (rng.normal(size=(n, 2, 3)) * 0.3).astype(np.float32)
    noise = rng.normal(size=(2, n, h, w)).astype(np.float32)
    cfg = TrainConfig(height=h, width=w, batch_size=n, use_gt_pose=gt_pose)
    step = make_train_step(cfg)
    results = []
    for dev in ("cuda", "cpu"):
        model, state = init_state(0, cfg, 10, device=dev)
        before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        state, loss, _ = step(state, batch, noise=noise)
        after = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        results.append((float(loss), before, after))
        if dev == "cuda":
            grads = {k: p.grad.cpu() for k, p in model.named_parameters() if p.grad is not None}
    (lc, bc, ac), (lp, bp, ap) = results
    for k in bc:
        assert torch.equal(bc[k], bp[k]), k  # one seed, the same weights everywhere
    assert abs(lc - lp) <= 1e-5 * abs(lp)
    for k in ac:
        if "running_" in k:
            assert float((ac[k] - ap[k]).abs().max()) <= 1e-5, k
        else:
            assert bool((ac[k] != bc[k]).any()) == bool((ap[k] != bp[k]).any()), k
    replay = {k: bc[k].clone().requires_grad_(True) for k in grads}
    for k, r in replay.items():
        r.grad = grads[k]
    make_optimizer(cfg, list(replay.values())).step()
    ulp = torch.finfo(torch.float32).eps
    for k, r in replay.items():
        r = r.detach()
        assert bool(((ac[k] - r).abs() <= 1e-3 * cfg.learning_rate + 4 * ulp * r.abs()).all()), k


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(64, 128), (36, 68)])
def test_psmnet_step_card_matches_cpu(hw):
    """One float32 (IEEE) PSMNet train step from the same seeded weights and
    batch on the card and on the CPU: loss within 1e-4 relative, batch
    statistics within 1e-4, and the card's update that of torch's
    single-tensor Adam on the CPU fed the card's gradients; eval-mode
    disparity within 1e-4 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpu3drec_torch.models.psmnet import stereo_infer
    from tpu3drec_torch.models.psmnet_training import (
        StereoTrainConfig, init_stereo_state, make_stereo_train_step, to_model)
    from tpu3drec_torch.models.training import make_optimizer

    h, w = hw
    rng = np.random.default_rng(0)
    batch = {"left": rng.uniform(size=(2, h, w, 3)), "right": rng.uniform(size=(2, h, w, 3)),
             "disp": rng.uniform(0, 15, size=(2, 4 * (h // 4), 4 * (w // 4))),
             "mask": (rng.uniform(size=(2, 4 * (h // 4), 4 * (w // 4))) > 0.2) * 1.0}
    cfg = StereoTrainConfig(height=h, width=w, batch_size=2, max_disp=16, feat_ch=16)
    step = make_stereo_train_step(cfg)
    results = []
    for dev in ("cuda", "cpu"):
        model, state = init_stereo_state(0, cfg, device=dev)
        before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        disp = stereo_infer(model, to_model(model, batch["left"], image=True),
                            to_model(model, batch["right"], image=True)).cpu()
        state, loss = step(state, batch)
        after = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        results.append((float(loss), before, after, disp))
        if dev == "cuda":
            grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
    (lc, bc, ac, dc), (lp, bp, ap, dp) = results
    assert float((dc - dp).abs().max()) <= 1e-4 * float(dp.abs().max())
    assert abs(lc - lp) <= 1e-4 * abs(lp)
    for k in ac:
        if "running_" in k:
            assert float((ac[k] - ap[k]).abs().max()) <= 1e-4, k
    replay = {k: bc[k].clone().requires_grad_(True) for k in grads}
    for k, r in replay.items():
        r.grad = grads[k]
    make_optimizer(cfg, list(replay.values())).step()
    ulp = torch.finfo(torch.float32).eps
    for k, r in replay.items():
        r = r.detach()
        assert bool(((ac[k] - r).abs() <= 1e-3 * cfg.learning_rate + 4 * ulp * r.abs()).all()), k


@pytest.mark.gpu
def test_plane_sweep_card_matches_cpu():
    """A plane sweep of a textured random scene on the card and on the CPU,
    held as tests/test_torch_mvs.py holds the port against the JAX package:
    winning planes and n_valid on >= 99.5% of pixels, the winning ZNCC
    within 1e-4 at p99, depth within 1e-5 relative on >= 95% of the pixels
    whose winners agree and within 1e-4 at p99."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpu3drec_torch.mvs.plane_sweep import plane_sweep_depth

    rng = np.random.default_rng(3)
    h, w, f = 120, 160, 200.0  # a 0.3 m baseline at 10 m: 6 pixels exactly
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    # a textured fronto-parallel wall at 10 m seen from 5 cameras on a line
    tex = rng.uniform(size=(h * 2, w * 2)).astype(np.float32)
    Rs = np.tile(np.eye(3, dtype=np.float32), (5, 1, 1))
    ts = np.array([[-0.3 * i, 0, 0] for i in range(5)], np.float32)
    imgs = []
    for t in ts:
        shift = int(round(-t[0] * f / 10.0))
        imgs.append(tex[h // 2: h // 2 + h, w // 2 + shift: w // 2 + shift + w])
    imgs = np.stack(imgs)
    args = (imgs[2], imgs[[0, 1, 3, 4]], K, Rs[2], ts[2], Rs[[0, 1, 3, 4]], ts[[0, 1, 3, 4]],
            2.0, 40.0)
    out = [tuple(x.cpu().numpy() for x in plane_sweep_depth(*args, n_planes=64, device=dev))
           for dev in ("cuda", "cpu")]
    (gd, gz, gn), (cd, cz, cn) = out
    step = (1 / 2.0 - 1 / 40.0) / 63

    def plane(d):
        d = d.astype(np.float64)
        return np.where(d > 0, (1 / np.maximum(d, 1e-12) - 1 / 40.0) / step, -1.0)

    agree = np.abs(plane(gd) - plane(cd)) < 0.5
    assert agree.mean() >= 0.995 and (gn == cn).mean() >= 0.995
    assert np.quantile(np.abs(gz - cz)[agree], 0.99) <= 1e-4
    rel = (np.abs(gd.astype(np.float64) - cd) / np.maximum(cd, 1e-6))[agree]
    assert (rel <= 1e-5).mean() >= 0.95 and np.quantile(rel, 0.99) <= 1e-4
    inner = (slice(10, -10), slice(10, -10))
    assert np.median(np.abs(gd[inner] - 10.0)) < 0.5  # the wall


@pytest.mark.gpu
@pytest.mark.parametrize("res,samples", [(0.1, 128), (0.05, 32)])
def test_scan_update_card_matches_cpu(res, samples):
    """One occupancy scan (a 120x160 depth frame's rays from a moving origin,
    some invalid) on the card and on the CPU: keys and both masks equal, and
    the maps' keys and log-odds after two scans too. The sampling's fused
    multiply-adds and correctly rounded norm go through float64 on both."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpu3drec_torch.mapping.occupancy import OccupancyMap, scan_update

    rng = np.random.default_rng(1)
    maps = {dev: OccupancyMap(res=res, max_samples=samples, device=dev) for dev in ("cuda", "cpu")}
    for f in range(2):
        origin = rng.uniform(-1, 1, 3).astype(np.float32)
        pts = (origin + rng.normal(size=(120 * 160, 3)) * rng.uniform(0.5, 12.0, (120 * 160, 1)))
        pts = pts.astype(np.float32)
        valid = rng.random(120 * 160) > 0.1
        out = {}
        for dev in ("cuda", "cpu"):
            args = (torch.as_tensor(origin, device=dev), torch.as_tensor(pts, device=dev),
                    torch.as_tensor(valid, device=dev))
            out[dev] = [x.cpu() for x in scan_update(*args, res, samples)]
            maps[dev].insert_scan(origin, pts, valid)
        for a, b in zip(out["cuda"], out["cpu"]):
            assert torch.equal(a, b)
    assert np.array_equal(maps["cuda"].keys, maps["cpu"].keys)
    assert np.array_equal(maps["cuda"].logodds, maps["cpu"].logodds)


@pytest.mark.gpu
def test_point_to_plane_launches_the_icp_nn_kernel():
    """Point-to-plane ICP on the card: one ICP-NN kernel launch per
    iteration, each launch equal to the plain version on the inputs the
    path gave it, and the transform within 1e-4 of the CPU run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpu3drec_torch.sfm import icp

    rng = np.random.default_rng(2)
    a = np.concatenate([rng.uniform(0, 2, size=(1500, 2)), np.zeros((1500, 1))], 1)
    b = np.concatenate([rng.uniform(0, 2, size=(1500, 1)), np.zeros((1500, 1)),
                        rng.uniform(0, 1, size=(1500, 1))], 1)
    c = np.concatenate([np.zeros((1500, 1)), rng.uniform(0, 2, size=(1500, 1)),
                        rng.uniform(0, 1, size=(1500, 1))], 1)
    g = np.concatenate([a, b, c]).astype(np.float32)
    th = 0.1
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    dst = (g @ R.T + [0.3, -0.2, 0.1]).astype(np.float32)
    calls = []
    kernel = icp_nn.nearest_neighbors_cuda

    def recording(q, r):
        out = kernel(q, r)
        calls.append((q.clone(), r.clone(), out[0].clone(), out[1].clone()))
        return out

    before = icp_nn.launches
    icp.nearest_neighbors_cuda = recording
    try:
        res = icp.icp_point_to_plane(g, dst, iters=12, device="cuda")
    finally:
        icp.nearest_neighbors_cuda = kernel
    assert icp_nn.launches - before == 12 and len(calls) == 12
    for q, r, idx, d2 in calls:
        pidx, pd2 = icp_nn.nearest_neighbors_plain(q, r)
        assert torch.equal(idx, pidx) and torch.equal(d2, pd2)
    cpu = icp.icp_point_to_plane(g, dst, iters=12, device="cpu")
    assert float((res.T.cpu() - cpu.T).abs().max()) <= 1e-4


@pytest.mark.gpu
def test_estimate_normals_past_the_eigh_batch_limit_on_the_card():
    """40,000 points on a plane: more 3x3 covariances than cuSOLVER's
    batched eigh takes at once (it refuses 32,768); every normal is the
    plane's, up to sign."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpu3drec_torch.sfm import icp

    rng = np.random.default_rng(4)
    p = np.concatenate([rng.uniform(0, 20, size=(40_000, 2)), np.zeros((40_000, 1))], 1)
    nrm = icp.estimate_normals(torch.as_tensor(p, dtype=torch.float32, device="cuda"))
    assert nrm.shape == (40_000, 3)
    assert float((nrm[:, 2].abs() - 1).abs().max()) < 1e-4


# ------------------------------------------------- 2 ranks sharing the card


def _two_ranks_on_the_card(tmp_path, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_world import run_world

    return run_world(os.path.abspath(__file__), tmp_path, world=2, timeout=300,
                     extra_args=(mode,))


@pytest.mark.gpu
def test_two_rank_ring_search_on_the_card(tmp_path):
    """20,000 x 20,000 points over 2 ranks on cuda:0: one ICP-NN launch a
    ring step, d2 bit-equal to the single-process kernel's, indices equal
    (random points: no exact ties), the shard passed through host memory."""
    for r in _two_ranks_on_the_card(tmp_path, "ring"):
        assert int(r["launches"]) == 2
        assert bool(r["d2_equal"]) and bool(r["idx_equal"])
        assert int(r["ppermute_bytes"]) == 10_000 * 3 * 4


@pytest.mark.gpu
def test_transfer_helper_stages_cuda_tensors_under_gloo(tmp_path):
    """all_reduce, all_gather and ppermute of CUDA tensors under gloo:
    results on the card, right, and every byte staged counted."""
    for r in _two_ranks_on_the_card(tmp_path, "staging"):
        assert bool(r["ok"])
        assert list(r["staged"]) == [4000, 4000, 4000]


def _rank(argv):
    from torch_world import join

    from tpu3drec_torch.parallel import mesh as pm

    rank, world, d = join(argv)
    mesh = pm.make_mesh(data=1, space=world, device="cuda")
    out = {}
    if argv[4] == "ring":
        from tpu3drec_torch.parallel.ring import ring_nearest_neighbors
        from tpu3drec_torch.sfm.icp import nearest_neighbors

        rng = np.random.default_rng(0)
        q = rng.normal(size=(20_000, 3)).astype(np.float32)
        r = rng.normal(size=(20_000, 3)).astype(np.float32)
        qs, rs = pm.shard_batch(mesh, q, "space"), pm.shard_batch(mesh, r, "space")
        pm.reset_staged()
        icp_nn.reset_launches()
        idx, d2 = ring_nearest_neighbors(qs, rs, mesh)
        out["launches"] = icp_nn.launches
        out["ppermute_bytes"] = pm.staged_bytes.get("ppermute", 0)
        i1, d1 = nearest_neighbors(qs, torch.as_tensor(r, device="cuda"))
        out["d2_equal"], out["idx_equal"] = torch.equal(d2, d1), torch.equal(idx, i1)
    else:
        x = torch.full((1000,), float(rank + 1), device="cuda")
        pm.reset_staged()
        s = pm.all_reduce(mesh, x, "space")
        g = pm.all_gather(mesh, x, "space")
        p = pm.ppermute(mesh, x, "space")
        out["ok"] = (s.is_cuda and g.is_cuda and p.is_cuda and bool((s == 3).all())
                     and g.shape == (2, 1000) and bool((g[1] == 2).all())
                     and bool((p == 2 - rank).all()))
        out["staged"] = [pm.staged_bytes[k] for k in ("all_reduce", "all_gather", "ppermute")]
    np.savez(os.path.join(d, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    _rank(sys.argv)

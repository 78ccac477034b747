"""Parity of the port's live frame stream (`tpu3drec_torch/data/stream.py`, the
`serve` subcommand and the port's C++ sender) with the JAX package, on
tests/test_stream.py's cases, plus the wire format across packages.

Tolerance: none. The streamed cloud equals `run_arrays`'s on the same frames
(the port's and the JAX package's), and the `.bt` and PLY files are
byte-equal: the stream fuses each frame with the same arithmetic, however
the frames are batched.
"""

import os
import socket
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest

from tpu3drec.data import stream as jstream
from tpu3drec.pipelines import rgbd as jrgbd
from tpu3drec.utils.config import CameraConfig as JCam
from tpu3drec.utils.config import RGBDPipelineConfig as JCfg
from tpu3drec_torch.data import stream as tstream
from tpu3drec_torch.ops import build
from tpu3drec_torch.pipelines import rgbd as trgbd
from tpu3drec_torch.utils.config import CameraConfig, RGBDPipelineConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _make_frames(rng, F=6, H=48, W=64):
    depths = rng.uniform(1.0, 30.0, size=(F, H, W)).astype(np.float32)
    q = rng.normal(size=(F, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = rng.normal(size=(F, 3)).astype(np.float32)
    rgb = rng.integers(0, 255, size=(F, H, W, 3), dtype=np.uint8)
    return depths, q, t, rgb


def _cfg(tmp_path, tag, H=48, W=64, config=RGBDPipelineConfig, camera=CameraConfig):
    cfg = config()
    cfg.camera = camera(fx=60.0, fy=60.0, cx=W / 2, cy=H / 2, width=W, height=H)
    cfg.out_ply = str(tmp_path / f"{tag}.ply")
    cfg.out_bt = str(tmp_path / f"{tag}.bt")
    return cfg


def _produce(port, depths, q=None, t=None, rgb=None, client=tstream.FrameStreamClient,
             frame=tstream.StreamFrame):
    def run():
        c = client("127.0.0.1", port)
        for i in range(len(depths)):
            c.send(frame(frame_id=i, depth=depths[i], rgb=None if rgb is None else rgb[i],
                         t=None if t is None else t[i], q_xyzw=None if q is None else q[i]))
        c.close()

    th = threading.Thread(target=run)
    th.start()
    return th


def _offline(tmp_path, depths, q, t, rgb):
    """The port's and the JAX package's `run_arrays` on the same frames."""
    cfg = _cfg(tmp_path, "off")
    ref = trgbd.run_arrays(depths, q, t, cfg, keep_points=True, colors=rgb, device="cpu")
    jcfg = _cfg(tmp_path, "joff", config=JCfg, camera=JCam)
    jref = jrgbd.run_arrays(depths, q, t, jcfg, keep_points=True, colors=rgb)
    np.testing.assert_array_equal(ref.points, jref.points)
    return cfg, ref


@pytest.mark.parametrize("batch", [4, 6])
def test_stream_fuse_matches_offline_pipeline(tmp_path, rng, batch):
    """Batch 4 over 6 frames exercises the padded final micro-batch."""
    depths, q, t, rgb = _make_frames(rng)
    cfg = _cfg(tmp_path, "stream")
    server = tstream.FrameStreamServer()
    th = _produce(server.port, depths, q, t, rgb)
    res = tstream.stream_fuse(server, cfg, batch=batch, keep_points=True, device="cpu")
    th.join(timeout=60)
    assert not th.is_alive() and res.n_frames == 6
    ocfg, ref = _offline(tmp_path, depths, q, t, rgb)
    assert (res.n_points, res.n_voxels) == (ref.n_points, ref.n_voxels)
    np.testing.assert_array_equal(res.points, ref.points)
    assert _bytes(cfg.out_bt) == _bytes(ocfg.out_bt)
    assert _bytes(cfg.out_ply) == _bytes(ocfg.out_ply)


def test_stream_without_pose_fuses_at_identity(tmp_path, rng):
    depths, _, _, _ = _make_frames(rng, F=2)
    cfg = _cfg(tmp_path, "stream")
    cfg.out_bt = ""
    server = tstream.FrameStreamServer()
    th = _produce(server.port, depths)
    res = tstream.stream_fuse(server, cfg, batch=2, keep_points=True, device="cpu")
    th.join(timeout=60)
    ident_q = np.tile(np.array([0, 0, 0, 1], np.float32), (2, 1))
    ref = jrgbd.run_arrays(depths, ident_q, np.zeros((2, 3), np.float32),
                           _cfg(tmp_path, "id", config=JCfg, camera=JCam), keep_points=True)
    np.testing.assert_array_equal(res.points, ref.points)
    assert res.n_voxels == 0 and not os.path.exists(tmp_path / "stream.bt")


def test_stream_shape_mismatch_raises(tmp_path):
    cfg = _cfg(tmp_path, "stream")  # configured 48x64
    server = tstream.FrameStreamServer()
    th = _produce(server.port, np.zeros((1, 32, 32), np.float32))
    with pytest.raises(ValueError, match="shape"):
        tstream.stream_fuse(server, cfg, batch=2, device="cpu")
    th.join(timeout=60)


def test_truncated_stream_surfaces_error(tmp_path):
    """A producer dying mid-frame raises at the consumer, neither hanging
    nor truncating silently."""
    cfg = _cfg(tmp_path, "stream")
    server = tstream.FrameStreamServer()
    s = socket.create_connection(("127.0.0.1", server.port))
    s.sendall(b"T3DR" + struct.pack("<I", 1))
    s.sendall(struct.pack("<IHHB", 0, 48, 64, 0))
    s.sendall(b"\x00" * 100)  # far less than 4*48*64
    s.close()
    with pytest.raises(ConnectionError, match="mid-message"):
        tstream.stream_fuse(server, cfg, batch=2, device="cpu")


@pytest.mark.parametrize("direction", ["jax_client_to_port", "port_client_to_jax"])
def test_wire_format_across_packages(tmp_path, rng, direction):
    """The JAX package's client feeds the port's server, and the port's
    client the JAX package's server: the same frames arrive."""
    depths, q, t, rgb = _make_frames(rng, F=3)
    if direction == "jax_client_to_port":
        server = tstream.FrameStreamServer()
        th = _produce(server.port, depths, q, t, rgb, client=jstream.FrameStreamClient,
                      frame=jstream.StreamFrame)
    else:
        server = jstream.FrameStreamServer()
        th = _produce(server.port, depths, q, t, rgb)
    got = list(server)
    th.join(timeout=60)
    assert [f.frame_id for f in got] == [0, 1, 2]
    for i, f in enumerate(got):
        np.testing.assert_array_equal(f.depth, depths[i])
        np.testing.assert_array_equal(f.rgb, rgb[i])
        np.testing.assert_array_equal(f.t, t[i])
        np.testing.assert_array_equal(f.q_xyzw, q[i])


def test_capture_blob_bytes_equal(tmp_path, rng):
    depths, q, t, rgb = _make_frames(rng, F=3)
    for kw in (dict(rgb=rgb, t=t, q_xyzw=q), dict(), dict(t=t, q_xyzw=q)):
        a, b = str(tmp_path / "t.t3dc"), str(tmp_path / "j.t3dc")
        tstream.write_capture_blob(a, depths, **kw)
        jstream.write_capture_blob(b, depths, **kw)
        assert _bytes(a) == _bytes(b)


def test_cpp_sender_end_to_end(tmp_path, rng):
    """The port's C++ sender (`utils/csrc/stream_sender.cpp`, built by
    `build_host` into build/, never `make -C native`) streams a recorded
    blob; the fused cloud equals the offline pipeline's."""
    sender = tstream.sender_path()
    depths, q, t, rgb = _make_frames(rng, F=5)
    blob = str(tmp_path / "cap.t3dc")
    tstream.write_capture_blob(blob, depths, rgb=rgb, t=t, q_xyzw=q)
    cfg = _cfg(tmp_path, "stream")
    server = tstream.FrameStreamServer()
    proc = subprocess.Popen([sender, blob, "127.0.0.1", str(server.port)],
                            stdout=subprocess.PIPE, text=True)
    res = tstream.stream_fuse(server, cfg, batch=2, keep_points=True, device="cpu")
    out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0, out
    assert "sent 5 frames" in out and res.n_frames == 5
    ocfg, ref = _offline(tmp_path, depths, q, t, rgb)
    np.testing.assert_array_equal(res.points, ref.points)
    assert _bytes(cfg.out_bt) == _bytes(ocfg.out_bt)
    assert _bytes(cfg.out_ply) == _bytes(ocfg.out_ply)


def test_sender_builds_into_the_port_build_dir():
    exe = tstream.sender_path()
    assert os.path.dirname(exe) == build.BUILD_DIR
    assert os.path.basename(exe).startswith("stream_sender_") and os.access(exe, os.X_OK)
    assert tstream.sender_path() == exe  # built once, then found
    p = subprocess.run([exe], capture_output=True, text=True, timeout=30)
    assert p.returncode == 2 and "usage" in p.stderr


def test_failed_executable_build_raises_with_the_compiler_output(tmp_path):
    bad = tmp_path / "broken_sender.cpp"
    bad.write_text("int main( { return 0; }\n")
    with pytest.raises(RuntimeError, match="broken_sender.cpp"):
        build.build_host(str(bad), executable=True)


def test_serve_cli(tmp_path, rng):
    """`serve` through the port's CLI in its own process, fed by the C++
    sender: the files equal `run_arrays`'s."""
    import json

    depths, q, t, rgb = _make_frames(rng, F=5)
    blob = str(tmp_path / "cap.t3dc")
    tstream.write_capture_blob(blob, depths, rgb=rgb, t=t, q_xyzw=q)
    cfg = _cfg(tmp_path, "unused")
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({"camera": {
        "fx": cfg.camera.fx, "fy": cfg.camera.fy, "cx": cfg.camera.cx, "cy": cfg.camera.cy,
        "width": cfg.camera.width, "height": cfg.camera.height}}))
    ply, bt = str(tmp_path / "serve.ply"), str(tmp_path / "serve.bt")
    env = dict(os.environ, PYTHONPATH=ROOT)
    srv = subprocess.Popen(
        [sys.executable, "-m", "tpu3drec_torch.pipelines.cli", "--device", "cpu", "serve",
         "--config", str(cfg_path), "--batch", "4", "--out-ply", ply, "--out-bt", bt],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        first = srv.stdout.readline()
        assert first.startswith("listening on port"), first + srv.stderr.read()
        port = first.split()[-1]
        sent = subprocess.run([tstream.sender_path(), blob, "127.0.0.1", port],
                              capture_output=True, text=True, timeout=60)
        assert sent.returncode == 0, sent.stderr
        out, err = srv.communicate(timeout=120)
    finally:
        srv.kill()
    assert srv.returncode == 0, err
    assert "stream done: 5 frames" in out
    ocfg, _ = _offline(tmp_path, depths, q, t, rgb)
    assert _bytes(bt) == _bytes(ocfg.out_bt)
    assert _bytes(ply) == _bytes(ocfg.out_ply)

"""Live sensor-stream ingestion (port of `tpu3drec/data/stream.py`): frames
over a socket into the device pipeline.

A capture client streams RGB-D frames (+ poses) over TCP while the consumer
fuses them into the world map in micro-batches on the device. A bounded
queue decouples the socket thread from the device work, so a capture loop
(simulator, camera rig, another host) feeds the pipeline without touching
the filesystem contract.

Wire protocol v1 (little-endian), unchanged from the JAX package, so its
client, this client and the C++ sender (`utils/csrc/stream_sender.cpp`)
all speak it:

    connection:  magic b"T3DR" | u32 version (=1)
    per frame:   u32 frame_id | u16 H | u16 W | u8 flags | payload
                   flags bit0: RGB present      (u8 x H*W*3, after depth)
                   flags bit1: pose present     (7 x f32: tx ty tz qx qy qz qw,
                                                 COLMAP world->cam, the row
                                                 contract of poses.txt)
                   payload:    f32 depth x H*W (metres)
    end:         frame_id = 0xFFFFFFFF (no body)

Frames without a pose are fused at identity (a pure-capture recorder).
"""

from __future__ import annotations

import os
import queue
import socket
import struct
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

MAGIC = b"T3DR"
VERSION = 1
END_FRAME = 0xFFFFFFFF
FLAG_RGB = 1
FLAG_POSE = 2


@dataclass
class StreamFrame:
    frame_id: int
    depth: np.ndarray                 # (H, W) float32 metres
    rgb: np.ndarray | None = None     # (H, W, 3) uint8
    t: np.ndarray | None = None       # (3,) world->cam translation
    q_xyzw: np.ndarray | None = None  # (4,) world->cam quaternion


# ------------------------------------------------------------------ client

class FrameStreamClient:
    """Producer side — the AirSim-capture-client role."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.sendall(MAGIC + struct.pack("<I", VERSION))

    def send(self, frame: StreamFrame) -> None:
        depth = np.ascontiguousarray(frame.depth, np.float32)
        H, W = depth.shape
        flags = 0
        body = depth.tobytes()
        if frame.rgb is not None:
            flags |= FLAG_RGB
            rgb = np.ascontiguousarray(frame.rgb, np.uint8)
            if rgb.shape != (H, W, 3):
                raise ValueError(f"rgb shape {rgb.shape} does not match depth {(H, W)}")
            body += rgb.tobytes()
        if frame.t is not None:
            flags |= FLAG_POSE
            pose = np.concatenate([
                np.asarray(frame.t, np.float32).reshape(3),
                np.asarray(frame.q_xyzw, np.float32).reshape(4),
            ])
            body += pose.astype("<f4").tobytes()
        hdr = struct.pack("<IHHB", frame.frame_id, H, W, flags)
        self.sock.sendall(hdr + body)

    def close(self) -> None:
        try:
            self.sock.sendall(struct.pack("<IHHB", END_FRAME, 0, 0, 0))
        finally:
            self.sock.close()


# ------------------------------------------------------------------ server

def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError(
                f"stream closed mid-message ({len(buf)}/{n} bytes)")
        buf += chunk
    return bytes(buf)


class FrameStreamServer:
    """Consumer side: accepts ONE producer connection and decodes frames
    into a bounded queue (backpressure: a slow consumer throttles the
    producer through TCP flow control once the queue fills)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 queue_frames: int = 32):
        self._listener = socket.socket()
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(1)
        self.port = self._listener.getsockname()[1]
        self.frames: queue.Queue = queue.Queue(maxsize=queue_frames)
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self.error: Exception | None = None
        self._thread.start()

    def _serve(self) -> None:
        try:
            conn, _ = self._listener.accept()
            with conn:
                magic = _recv_exact(conn, 4)
                if magic != MAGIC:
                    raise ValueError(f"bad stream magic {magic!r}")
                (ver,) = struct.unpack("<I", _recv_exact(conn, 4))
                if ver != VERSION:
                    raise ValueError(f"unsupported stream version {ver}")
                while True:
                    fid, H, W, flags = struct.unpack(
                        "<IHHB", _recv_exact(conn, 9))
                    if fid == END_FRAME:
                        break
                    depth = np.frombuffer(
                        _recv_exact(conn, 4 * H * W), "<f4").reshape(H, W)
                    rgb = None
                    if flags & FLAG_RGB:
                        rgb = np.frombuffer(
                            _recv_exact(conn, 3 * H * W), np.uint8
                        ).reshape(H, W, 3)
                    t = q = None
                    if flags & FLAG_POSE:
                        pose = np.frombuffer(_recv_exact(conn, 28), "<f4")
                        t, q = pose[:3].copy(), pose[3:].copy()
                    self.frames.put(StreamFrame(fid, depth.copy(), rgb, t, q))
        except Exception as e:  # surfaced to the consumer via poison pill
            self.error = e
        finally:
            self.frames.put(None)  # EOS sentinel
            self._listener.close()

    def __iter__(self):
        while True:
            f = self.frames.get()
            if f is None:
                if self.error is not None:
                    raise self.error
                return
            yield f


# ---------------------------------------------------------- capture blobs

def write_capture_blob(path: str, depths: np.ndarray,
                       rgb: np.ndarray | None = None,
                       t: np.ndarray | None = None,
                       q_xyzw: np.ndarray | None = None) -> None:
    """Record a capture to the blob format the C++ sender
    (`utils/csrc/stream_sender.cpp`) replays: magic "T3DC" | u32 F | u16 H |
    u16 W | u8 flags | per-frame payloads."""
    F, H, W = depths.shape
    flags = (FLAG_RGB if rgb is not None else 0) | (
        FLAG_POSE if t is not None else 0)
    with open(path, "wb") as f:
        f.write(b"T3DC" + struct.pack("<IHHB", F, H, W, flags))
        for i in range(F):
            f.write(np.ascontiguousarray(depths[i], "<f4").tobytes())
            if rgb is not None:
                f.write(np.ascontiguousarray(rgb[i], np.uint8).tobytes())
            if t is not None:
                pose = np.concatenate([
                    np.asarray(t[i], np.float32).reshape(3),
                    np.asarray(q_xyzw[i], np.float32).reshape(4)])
                f.write(pose.astype("<f4").tobytes())


# ------------------------------------------------------- streaming fusion

@dataclass
class StreamFusionResult:
    n_frames: int
    n_points: int
    n_voxels: int
    points: np.ndarray | None = None


def stream_fuse(server: FrameStreamServer, cfg, batch: int = 4,
                keep_points: bool = False, verbose: bool = False, device=None
                ) -> StreamFusionResult:
    """Fuse an incoming frame stream into the world map on ``device``.

    Frames are consumed in micro-batches of ``batch`` (the last one
    zero-padded), unprojected and world-transformed on the device while the
    socket thread keeps receiving, and voxel-deduped at the end. ``cfg`` is
    an `RGBDPipelineConfig`; artifacts are written per its out_ply/out_bt.
    The points equal `pipelines/rgbd.py::run_arrays`'s on the same frames."""
    from tpu3drec_torch.mapping.btio import write_bt
    from tpu3drec_torch.mapping.voxel import unique_voxels, voxelize
    from tpu3drec_torch.pipelines.rgbd import fuse_arrays
    from tpu3drec_torch.utils.device import resolve_device
    from tpu3drec_torch.utils.plyio import write_ply

    dev = resolve_device(device)
    cam = cfg.camera
    clouds, colors = [], []
    buf_d, buf_t, buf_q, buf_rgb = [], [], [], []
    n_frames = 0

    def flush():
        if not buf_d:
            return
        n = len(buf_d)
        pad = batch - n
        depths = np.stack(buf_d + [np.zeros_like(buf_d[0])] * pad)
        q = np.stack(buf_q + [np.array([0, 0, 0, 1], np.float32)] * pad)
        t = np.stack(buf_t + [np.zeros(3, np.float32)] * pad)
        pts, valid = fuse_arrays(depths, q, t, cfg, device=dev)
        pts = pts.reshape(batch, -1, 3)[:n].reshape(-1, 3)
        val = valid.reshape(batch, -1)[:n].reshape(-1)
        clouds.append(pts[val])
        if any(r is not None for r in buf_rgb):
            rgb = np.stack([
                r if r is not None else np.zeros((cam.height, cam.width, 3), np.uint8)
                for r in buf_rgb])
            colors.append(rgb.reshape(-1, 3)[val.cpu().numpy()])
        buf_d.clear()
        buf_t.clear()
        buf_q.clear()
        buf_rgb.clear()

    for frame in server:
        if frame.depth.shape != (cam.height, cam.width):
            raise ValueError(
                f"frame {frame.frame_id}: shape {frame.depth.shape} != "
                f"configured {(cam.height, cam.width)}")
        buf_d.append(frame.depth)
        buf_rgb.append(frame.rgb)
        buf_t.append(frame.t if frame.t is not None else np.zeros(3, np.float32))
        buf_q.append(frame.q_xyzw if frame.q_xyzw is not None
                     else np.array([0, 0, 0, 1], np.float32))
        n_frames += 1
        if len(buf_d) == batch:
            flush()
            if verbose:
                print(f"[stream] fused through frame {n_frames}")
    flush()

    cloud_d = torch.cat(clouds) if clouds else torch.zeros((0, 3), device=dev)
    cloud_rgb = np.concatenate(colors) if colors else None
    n_voxels = 0
    if cfg.out_bt and len(cloud_d):
        skeys, mask, count = unique_voxels(
            voxelize(cloud_d, cfg.map.voxel_res),
            torch.ones(len(cloud_d), dtype=torch.bool, device=dev))
        n_voxels = int(count)
        write_bt(cfg.out_bt, skeys[mask].cpu().numpy(), cfg.map.voxel_res)
    cloud = cloud_d.cpu().numpy()
    if cfg.map.max_points and cloud.shape[0] > cfg.map.max_points:
        cloud = cloud[: cfg.map.max_points]
        if cloud_rgb is not None:
            cloud_rgb = cloud_rgb[: cfg.map.max_points]
    if cfg.out_ply and len(cloud):
        write_ply(cfg.out_ply, cloud, colors=cloud_rgb, binary=cfg.map.ply_binary)
    return StreamFusionResult(
        n_frames=n_frames, n_points=int(cloud.shape[0]), n_voxels=n_voxels,
        points=cloud if keep_points else None,
    )


def sender_path() -> str:
    """The C++ sender executable (`utils/csrc/stream_sender.cpp`), built
    into ``build/tpu3drec_torch/`` at the first call
    (`ops/build.py::build_host`)."""
    from tpu3drec_torch.ops.build import build_host

    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "utils", "csrc", "stream_sender.cpp")
    return build_host(src, executable=True)

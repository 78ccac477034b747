"""Build and load the port's CUDA kernels: one ``nvcc`` call for each
source in ``ops/csrc/``, all started together, each into a shared library
with a plain C interface that ``ctypes`` loads.

The libraries go to ``build/tpu3drec_torch/`` beside the package, under a
name that carries a hash of the source and the flags, so a changed source
is rebuilt and an unchanged one is loaded as it is. A missing ``nvcc`` or a
failed build raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "tpu3drec_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# compiler output (-Xptxas -v: registers, shared memory, spills) by source
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the port's "
                       "CUDA kernels are built on the machine with the card")


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build(names: list[str] | None = None) -> dict[str, str]:
    """Compile the named sources (default: every ``csrc/*.cu``) that have no
    current library yet, one ``nvcc`` process each, in parallel. Returns the
    library path for each name."""
    if names is None:
        names = sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))
    out = {name: _target(name) for name in names}
    todo = [(name, src, lib) for name, (src, lib) in out.items() if not os.path.exists(lib)]
    nvcc = _nvcc() if todo else None
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name, src, lib in todo:
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, lib, tmp, proc in procs:
        try:
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            log = f"timed out after {BUILD_TIMEOUT_S}s\n{log}"
        build_logs[name] = log
        if proc.returncode == 0:
            os.replace(tmp, lib)
            continue
        errors.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
        if os.path.exists(tmp):
            os.remove(tmp)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: lib for name, (_, lib) in out.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _libs[name] = lib
        return lib

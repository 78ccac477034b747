"""Build and load the port's CUDA kernels: one ``nvcc`` call for each
source in ``ops/csrc/``, all started together, each into a shared library
with a plain C interface that ``ctypes`` loads.

The libraries go to ``build/tpu3drec_torch/`` beside the package, under a
name that carries a hash of the source and the flags, so a changed source
is rebuilt and an unchanged one is loaded as it is. A missing ``nvcc`` or a
failed build raises with the compiler's output; nothing falls back.
`build_host` does the same for host C++ sources with one ``c++`` call: the
map-export library (`utils/csrc/native_io.cpp`, `utils/native.py`) and the
stream sender executable (`utils/csrc/stream_sender.cpp`, `data/stream.py`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

import torch

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
# compiler output (-Xptxas -v: registers, shared memory, spills) by source,
# also kept beside each library as <library>.log
build_logs: dict[str, str] = {}


def ptxas_usage(name: str) -> dict[str, dict[str, int]]:
    """Registers and spill bytes of each __global__ in ``csrc/<name>.cu``,
    from ptxas's report of its build: {function: {"registers", "spill_stores",
    "spill_loads", "smem"}}, keyed by the function's plain name."""
    out: dict[str, dict[str, int]] = {}
    fn = None
    for line in build_logs.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = _plain_name(m.group(1))
            out[fn] = {"registers": 0, "spill_stores": 0, "spill_loads": 0, "smem": 0}
            continue
        if fn is None:
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("smem", r"(\d+) bytes smem")):
            m = re.search(pat, line)
            if m:
                out[fn][key] = int(m.group(1))
    return out


def _plain_name(mangled: str) -> str:
    """The innermost name of an Itanium-mangled function name, e.g.
    icp_nn_kernel from _ZN41_GLOBAL__N__..._cu_568efe9413icp_nn_kernelEPKf..."""
    if not mangled.startswith("_Z"):
        return mangled
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    return name


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
    for name, (_, lib) in out.items():  # a library built earlier: its compiler output
        if os.path.exists(lib) and os.path.exists(lib + ".log"):
            with open(lib + ".log") as f:
                build_logs[name] = f.read()
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
            with open(lib + ".log", "w") as f:
                f.write(log)
            os.replace(tmp, lib)
            continue
        errors.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
        if os.path.exists(tmp):
            os.remove(tmp)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: lib for name, (_, lib) in out.items()}


HOST_CXX_FLAGS = ["-O2", "-std=c++17"]
HOST_LIBRARY_FLAGS = ["-shared", "-fPIC"]


def build_host(src: str, executable: bool = False) -> str:
    """Compile the host C++ source ``src`` (no CUDA) into a shared library,
    or with ``executable`` a program, in ``BUILD_DIR`` with one ``c++``
    call, unless one of the same source and flags is there already; returns
    its path. Written to a temporary file and renamed into place, so
    processes that build at once never load or run a torn file (never
    ``make -C native``, which xdist workers would race). A missing compiler
    or a failed build raises with the compiler's output."""
    flags = HOST_CXX_FLAGS if executable else HOST_CXX_FLAGS + HOST_LIBRARY_FLAGS
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
    name = os.path.splitext(os.path.basename(src))[0]
    lib = os.path.join(BUILD_DIR, f"{name}_{digest}" if executable else f"lib{name}_{digest}.so")
    if os.path.exists(lib):
        return lib
    cxx = shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(f"no host C++ compiler (c++ or g++) to build {src}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run([cxx, *flags, "-o", tmp, src], capture_output=True,
                              text=True, timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {src} (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _libs[name] = lib
        return lib


_blocks_per_sm: dict[tuple[str, int], int] = {}


def blocks_per_sm(name: str, device) -> int:
    """Blocks of the kernel of ``csrc/<name>.cu`` that one SM of the card
    ``device`` holds at once, from the occupancy query that the library
    exports as ``tpu3drec_<name>_blocks_per_sm`` (asked once per card)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if (name, index) not in _blocks_per_sm:
        fn = getattr(load(name), f"tpu3drec_{name}_blocks_per_sm")
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            rc = fn(ctypes.byref(out))
        if rc != 0 or out.value <= 0:
            raise RuntimeError(f"{name} occupancy query failed: cudaError {rc}")
        _blocks_per_sm[(name, index)] = out.value
    return _blocks_per_sm[(name, index)]

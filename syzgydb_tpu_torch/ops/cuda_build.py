"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source has a plain C entry point and is compiled by ``nvcc`` for
``sm_90a`` into its own shared library under ``syzgydb_tpu_torch/_build/``
(ignored by git), then loaded with ctypes.  Nothing is built when a module
is imported: the first launch builds what it needs, and ``build_all``
starts one ``nvcc`` per source in parallel for callers that want every
kernel ready up front (``chip_smoke.py``).  A measurement build of a
source with extra preprocessor defines (``defines``: (name, value) pairs)
goes through the same functions into a subdirectory of its own.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("segmin", "segmin_i8", "hamming", "surface")

_libs: dict[tuple, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def _lib_path(name: str, defines: tuple = ()) -> str:
    sub = "_".join(f"{k}-{v}" for k, v in defines)
    return os.path.join(BUILD_DIR, sub, f"lib{name}.so")


def _stale(name: str, defines: tuple = ()) -> bool:
    """Whether the library is missing or older than its source or any
    shared header (csrc/*.cuh)."""
    lib = _lib_path(name, defines)
    if not os.path.exists(lib):
        return True
    deps = [os.path.join(CSRC, f"{name}.cu")] + [
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")]
    return os.path.getmtime(lib) < max(os.path.getmtime(d) for d in deps)


def _start(name: str, defines: tuple = ()) -> tuple[subprocess.Popen, str]:
    """Start one nvcc into a per-process temp path (renamed into place on
    success, so a concurrent or failed build never leaves a partial .so)."""
    lib = _lib_path(name, defines)
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.tmp.{os.getpid()}"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           *(f"-D{k}={v}" for k, v in defines),
           "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, proc: subprocess.Popen, tmp: str,
            timeout: float, defines: tuple = ()) -> str:
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"nvcc timed out building {name}.cu")
    if proc.returncode != 0:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise RuntimeError(f"nvcc failed building {name}.cu:\n{out}")
    os.replace(tmp, _lib_path(name, defines))
    return out


def build_all(names=SOURCES, timeout: float = 600.0,
              variants=((),)) -> dict[str, str]:
    """Build every stale kernel library, one nvcc per source and variant
    (a tuple of defines; () is the shipped build), all started together.
    Returns each rebuilt library's compiler output (ptxas register and
    shared-memory report) by its path under _build/."""
    with _lock:
        started = {(n, v): _start(n, v) for v in variants for n in names
                   if _stale(n, v)}
        return {os.path.relpath(_lib_path(n, v), BUILD_DIR):
                _finish(n, p, tmp, timeout, v)
                for (n, v), (p, tmp) in started.items()}


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The kernel library for csrc/<name>.cu (built with `defines`), built
    on first use."""
    lib = _libs.get((name, defines))
    if lib is not None:
        return lib
    build_all((name,), variants=(defines,))
    with _lock:
        lib = _libs.get((name, defines))
        if lib is None:
            lib = _libs[name, defines] = ctypes.CDLL(
                _lib_path(name, defines))
    return lib


def check(rc: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a kernel entry point."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def entry(name: str, symbol: str, argtypes: list,
          defines: tuple = ()) -> ctypes._CFuncPtr:
    """The C entry point `symbol` of csrc/<name>.cu (built with
    `defines`), returning a cudaError_t, with its argument types set
    once."""
    fn = getattr(load(name, defines), symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def launch_stream(device: torch.device) -> int:
    """The current stream of `device`, which must be the current CUDA
    device: a kernel launches on the current device, so a tensor on another
    GPU raises instead of being read from the wrong one."""
    if device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {device} but the current CUDA device "
                         f"is {torch.cuda.current_device()}")
    return torch.cuda.current_stream().cuda_stream

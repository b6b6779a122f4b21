"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface and
loaded with ``ctypes`` -- no PyTorch headers, so a build takes seconds.
Libraries land in ``build/repro_torch/`` at the repository root (listed in
``.gitignore``; override with ``REPRO_TORCH_BUILD_DIR``), named by a hash
of the sources and flags, so an edited source is rebuilt and never
confused with a stale library.

Nothing here runs at import time: the CPU tests import every module and
this machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("binary_prefill_attention", "binary_paged_decode_attention",
           "binary_page_score", "binary_decode_attention", "hamming_score")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first "
                       "use and need the CUDA toolkit (set CUDA_HOME)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (proc, tmp, out) or None when the
    library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every named source that is not built yet, one nvcc each,
    all started together. Returns nvcc's output per source it compiled
    (the -Xptxas -v report: registers, shared memory, spills)."""
    with _lock:
        started = {n: _start(n) for n in names}
        logs, errors = {}, []
        for name, st in started.items():
            if st is None:
                continue
            try:
                logs[name] = _finish(name, st)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_lib_path(name)))
                _libs[name] = lib
    return lib


def require(device, dtypes, **tensors) -> None:
    """Raise ValueError unless every named tensor is contiguous, lies on
    `device` (a CUDA device) and has one of `dtypes` -- what a kernel's C
    entry point assumes of the pointers it is given."""
    for name, t in tensors.items():
        if t.dtype not in dtypes or t.device != device or not t.is_cuda \
                or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {'/'.join(map(str, dtypes))} "
                f"tensor on {device} (a CUDA device), got {t.dtype} on "
                f"{t.device}{'' if t.is_contiguous() else ', strided'}")


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        import torch
        try:
            name = torch.cuda.cudart().cudaGetErrorString(err)
        except (AttributeError, RuntimeError, TypeError):
            name = "unknown"            # the code alone still says it
        raise RuntimeError(f"{what} failed to launch: CUDA error {err} "
                           f"({name})")

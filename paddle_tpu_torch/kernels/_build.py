"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled by
``nvcc`` for ``sm_90a`` into a shared library under ``build/kernels/``
at the root of the checkout (listed in ``.gitignore``) and bound with
``ctypes``. The library's file name carries a hash of the source and
the flags, so an edited source rebuilds and an unchanged one is reused.

Nothing here runs at import. :func:`load` builds on first use;
:func:`build_all` starts one ``nvcc`` per source at once, for callers
that want every kernel ready before they start (``chip_smoke.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "DTYPE_CODE", "nvcc_path",
           "nvcc_command", "library_path", "build_all", "build_log",
           "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: the element-type codes of the kernels' C interfaces, by torch dtype
#: name
DTYPE_CODE = {"torch.float32": 0, "torch.float16": 1, "torch.bfloat16": 2}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``CUDA_HOME``
    (default ``/usr/local/cuda``). Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME); the CUDA "
        "kernels of paddle_tpu_torch build only where the CUDA toolkit "
        "is installed")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives once built. The
    tag hashes the source, the shared headers (``csrc/*.cuh``) and the
    flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def nvcc_command(name: str, out: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out),
            str(CSRC / f"{name}.cu")]


def _start(name: str):
    """Start compiling ``name`` unless its library exists; returns
    (final path, temp path, process) or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(nvcc_command(name, tmp),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp: Path, proc) -> None:
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names) -> dict[str, Path]:
    """Compile every named source that is not built yet, one ``nvcc``
    each, all at once; returns each library's path. Raises on the
    first failure after every compiler has exited."""
    started = {n: _start(n) for n in names}
    errors = []
    for n, job in started.items():
        if job is None:
            continue
        try:
            _finish(n, *job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: library_path(n) for n in names}


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``name`` (register
    and spill counts from ``-Xptxas -v``), or "" when none was kept."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


def load(name: str, bind) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed.
    ``bind(lib)`` declares its functions' ``argtypes``/``restype``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            bind(lib)
            _libs[name] = lib
        return lib

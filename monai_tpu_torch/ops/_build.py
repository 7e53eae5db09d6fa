"""Build and load the port's CUDA kernels.

Every ``monai_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` at first use, one process
per source, all started together, and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``. The library lands in
``build/monai_tpu_torch/`` at the root of the checkout; an installed copy of the package
(no checkout around it), or a checkout whose ``build/`` cannot be written, builds into
``monai_tpu_torch/build`` under ``$XDG_CACHE_HOME`` (else ``~/.cache``) instead, and
raises if that cannot be written either. The name carries a hash of the sources and
flags, so an edited source builds anew and an unchanged one is loaded as it is. The
build works in a temporary directory and renames the library into place, so processes
that build at the same time do not see each other's half-written files; the threads of
one process build once, under a lock. A failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "build_dir", "find_nvcc", "library", "library_path"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"


def _writable(path: Path) -> bool:
    """``path`` can be made and written: it, or its nearest existing ancestor, is a
    writable directory."""
    while not path.exists():
        if path.parent == path:
            return False
        path = path.parent
    return path.is_dir() and os.access(path, os.W_OK | os.X_OK)


def build_dir(package_root: Path | None = None) -> Path:
    """Where the library is built: ``build/monai_tpu_torch`` beside the package in a
    checkout (a directory that holds ``setup.py`` and the package), else, or when that
    cannot be written, ``$XDG_CACHE_HOME/monai_tpu_torch/build`` (``~/.cache`` without
    the variable). Raises if neither can be written."""
    root = (package_root or Path(__file__).resolve().parents[1]).parent
    if (root / "setup.py").is_file():
        local = root / "build" / "monai_tpu_torch"
        if _writable(local):
            return local
    cache = Path(os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache") / "monai_tpu_torch" / "build"
    if _writable(cache):
        return cache
    raise RuntimeError(f"monai_tpu_torch: no writable build directory for the CUDA kernels (tried the checkout's "
                       f"build/ and {cache}); set XDG_CACHE_HOME to a writable directory")


BUILD_DIR = build_dir()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags is (or will be) built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmonai_tpu_torch_{h.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install location. Raises if there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of monai_tpu_torch need the CUDA toolkit")


def _run(procs: list[tuple[list[str], subprocess.Popen]]) -> None:
    """Wait for every process; raise with the compiler's errors if one failed."""
    failed = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _start(cmd: list[str]) -> tuple[list[str], subprocess.Popen]:
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(prefix=out.stem + ".", dir=out.parent) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in _sources()]
        _run([_start([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]) for src, obj in zip(_sources(), objs)])
        lib = str(Path(tmp) / out.name)
        _run([_start([nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs])])
        os.replace(lib, out)


_LIBRARY_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use. Threads that reach it at once
    (the DataLoader's workers beside the main thread) wait for one build."""
    with _LIBRARY_LOCK:
        return _load()


@functools.cache
def _load() -> ctypes.CDLL:
    path = library_path()
    if not path.exists():
        _compile(path)
    return ctypes.CDLL(str(path))

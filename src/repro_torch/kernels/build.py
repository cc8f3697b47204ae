"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers),
so ``nvcc`` builds it in seconds into ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``), and ``ctypes`` loads it.  A
library's file name carries a hash of its source, the shared headers and
the flags, so an edited source is rebuilt and a stale library is never
loaded.  ``build`` starts one ``nvcc`` per missing library, all at once;
``load`` builds on first use.  Nothing is built or loaded when this
module is imported.

Processes share ``build/kernels/`` (tensor-parallel ranks, parallel
test workers): ``build`` holds an exclusive lock on a file there while
it looks for missing libraries and compiles them, so a second process
waits and then finds them built, and each library is compiled to a
temporary name and moved into place whole (``os.replace``), so no
process ever loads a half-written one.  The lock is the kernel's
(``fcntl.flock``), released when its holder exits, however it exits.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Iterator

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("decode_attention", "flash_attention", "flash_attention_bwd",
           "paged_decode_attention", "paged_append_attention", "ssd_scan")
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin); the CUDA kernels are "
                           "built on a machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """The library's path; its name hashes the source, every shared
    header in ``csrc/`` and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = hashlib.sha256(h.digest()
                            + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


@contextlib.contextmanager
def _exclusive(directory: Path) -> Iterator[None]:
    """Hold the build directory's lock file exclusively (waiting for
    another process's build to end)."""
    with open(directory / "build.lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source whose library is missing: one ``nvcc``
    each, all started together, under the build directory's lock.
    Returns name -> the compiler's output (``-Xptxas -v``: registers,
    shared memory and spills per kernel) for the sources it compiled;
    raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with _exclusive(BUILD_DIR):
        return _compile_missing(nvcc, names)


def _compile_missing(nvcc: str, names: Iterable[str]) -> Dict[str, str]:
    """``build``'s work, under the lock: a failed compile's temporary
    file is removed."""
    running = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True), tmp, target)
    reports, errors = {}, []
    for name, (proc, tmp, target) in running.items():
        try:
            out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            failed = proc.returncode and \
                f"nvcc exited {proc.returncode}\n{out}"
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            failed = f"nvcc timed out after {NVCC_TIMEOUT_S}s"
        if failed:
            tmp.unlink(missing_ok=True)
            errors.append(f"{name}: {failed}")
            continue
        target.with_suffix(".ptxas.txt").write_text(out)
        os.replace(tmp, target)
        reports[name] = out
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target = library_path(name)
            if not target.exists():
                build([name])
            lib = ctypes.CDLL(str(target))
            _libs[name] = lib
        return lib

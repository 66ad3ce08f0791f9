"""Build the port's CUDA kernels with plain ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, built at first use into ``quantum_computations_tpu_torch/_build/``
(listed in ``.gitignore``). The library's file name carries a hash of the
sources and flags, so a second process reuses it; a changed source builds
anew. Sources are compiled in parallel, one ``nvcc`` each.

There is no fallback: without ``nvcc`` a build raises, and so does a failed
compile. Importing this module needs neither ``nvcc`` nor CUDA. :func:`load`
holds a lock, so engine threads that meet a kernel at once build and load
it once.
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
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else under ``CUDA_HOME``; raises if neither."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    home = os.environ.get("CUDA_HOME") or CUDA_HOME
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME: the port's CUDA kernels "
        "are built from source at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed on sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names) -> dict[str, str | None]:
    """Build the named kernels that are not built yet, in parallel.

    Returns ``{name: nvcc output}``, with ``None`` for a library that was
    already built. Raises with nvcc's output if a compile fails.
    """
    logs: dict[str, str | None] = {n: None for n in names}
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return logs
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed; one
    thread at a time (a build's temporary file is named by the process)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib

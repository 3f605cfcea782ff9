"""Build-at-first-use loader for the hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process (all
started together) into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v -o build/repro_torch/<stem>-<hash>.so

The file name carries a hash of the flags, the source and every header in
``csrc/``, so a stale library is never loaded; the compiler's output
(``-Xptxas=-v``: registers, shared memory and spills per kernel) is kept
beside it as ``<stem>-<hash>.log``.  A library is written under a temporary
name and renamed into place, so concurrent builders never load a partial
file.  The build directory (``build/`` at the repository root) is listed in
``.gitignore``.

Libraries are loaded with :mod:`ctypes`; callers declare each entry point's
argument types (``c_void_p`` for every pointer and the stream, ``c_int`` for
sizes) and every entry returns ``cudaGetLastError()`` of its launches.
Nothing here runs at import time: the CPU-only test suite imports this
module without a compiler.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_libs: dict[str, ctypes.CDLL] = {}
_declared: set[tuple[str, str]] = set()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and Path(path).is_file():
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of repro_torch are compiled from src/repro_torch/csrc at "
        "first use"
    )


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in [source, *sorted(CSRC.glob("*.cuh"))]:
        digest.update(dep.name.encode())
        digest.update(dep.read_bytes())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every source whose library is missing, in parallel; returns
    the seconds spent.  Raises with the compiler's output on failure."""
    start = time.perf_counter()
    pending = [(src, library_path(src)) for src in sources()]
    pending = [(src, lib) for src, lib in pending if not lib.exists()]
    if not pending:
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src, lib in pending:
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, lib, tmp, proc))
    failures = []
    for src, lib, tmp, proc in jobs:
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{src.name}:\n{log}")
        else:
            os.replace(tmp, lib)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return time.perf_counter() - start


def build_log(stem: str) -> str:
    """The compiler's output for ``csrc/<stem>.cu`` (after a build)."""
    return library_path(CSRC / f"{stem}.cu").with_suffix(".log").read_text()


def library(stem: str, signatures: dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built if needed, with
    ``signatures`` (entry name -> argtypes) declared; every entry returns
    a C int.  Entries are declared at their first call whichever entry
    loaded the library (an undeclared entry would take each pointer as a
    C int)."""
    lib = _libs.get(stem)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(library_path(CSRC / f"{stem}.cu")))
        _libs[stem] = lib
    for name, argtypes in signatures.items():
        if (stem, name) not in _declared:
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _declared.add((stem, name))
    return lib


"""Build the port's CUDA kernels on first use.

Each source under ``csrc/`` (with the headers beside it) is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library with a plain C
interface, which the kernel's wrapper loads with ``ctypes``.  Libraries
go to ``_kernels_build/`` beside this file (listed in ``.gitignore``),
named by a digest of the source, the headers and the flags, so an edited
source is never served by a stale library.  Only the sources in this
package are built.

`build()` starts one ``nvcc`` per source that still needs building, all
at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_kernels_build"

# kernel name -> its source under csrc/
SOURCES = {"paged_attention": "paged_attention.cu",
           "flash_attention": "flash_attention.cu",
           "lstm": "lstm.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float     # 0.0 when the library was already built
    log: str           # nvcc/ptxas output (registers, shared memory, spills)


_lock = threading.Lock()
_results: Dict[str, BuildResult] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
    ``nvcc`` on ``PATH``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels cannot be built")
    return found


def build_command(nvcc: str, source: Path, output: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


def library_path(name: str) -> Path:
    """Where `name`'s library lives: keyed by the digest of its source,
    the shared headers (``csrc/*.cuh``) and the flags."""
    src = CSRC / SOURCES[name]
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, BuildResult]:
    """Build every named kernel (default: all) that is not built yet, one
    ``nvcc`` process per source, all started together.  Raises
    RuntimeError with the compiler's output when any build fails."""
    names = list(SOURCES) if names is None else list(names)
    with _lock:
        todo = []
        for name in names:
            if name in _results:
                continue
            path = library_path(name)
            if path.is_file():
                _results[name] = BuildResult(name, path, 0.0, "")
            else:
                todo.append((name, path))
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = find_nvcc()
            t0 = time.perf_counter()
            procs = []
            for name, path in todo:
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                cmd = build_command(nvcc, CSRC / SOURCES[name], tmp)
                procs.append((name, path, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            failures = []
            for name, path, tmp, proc in procs:
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    failures.append(f"{name}: nvcc exited {proc.returncode}"
                                    f"\n{log}")
                    tmp.unlink(missing_ok=True)
                    continue
                os.replace(tmp, path)
                _results[name] = BuildResult(
                    name, path, time.perf_counter() - t0, log)
            if failures:
                raise RuntimeError("kernel build failed:\n"
                                   + "\n".join(failures))
        return {n: _results[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """Kernel `name`'s library, built first if needed.  The caller keeps
    the handle (and declares its argument types once)."""
    return ctypes.CDLL(str(build([name])[name].path))


__all__ = ["BUILD_DIR", "BuildResult", "SOURCES", "build", "build_command",
           "find_nvcc", "library_path", "load"]

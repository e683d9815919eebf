"""Build the hand-written Hopper kernels with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` compiles into a shared library with a plain C
interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC``) that :mod:`ctypes` loads; no PyTorch header is
compiled, so a build takes seconds. Libraries land in
``build/repro_torch/<digest>/`` at the repository root, keyed on a hash
of every source, header and flag, and are built at first use: one
``nvcc`` process per source, all started together. Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

#: kernel name -> source file under csrc/ (every *.cuh there is a header)
SOURCES = {"msgs_fused": "msgs_fused.cu", "msgs_decode": "msgs_decode.cu",
           "msgs_decode_bwd": "msgs_decode_bwd.cu",
           "msgs_windowed": "msgs_windowed.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or in "
                       "/usr/local/cuda/bin; the CUDA kernels cannot be built")


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_digest()


def build_kernels(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Build every missing library among ``names`` (default: all) in
    parallel. Returns {name: {"path", "seconds", "log"}}; raises with the
    compiler's output when a build fails."""
    names = list(SOURCES) if names is None else list(names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    result, procs = {}, {}
    for name in names:
        lib = out_dir / f"lib{name}.so"
        log = out_dir / f"{name}.log"
        if lib.exists():
            result[name] = {"path": str(lib), "seconds": 0.0,
                            "log": log.read_text() if log.exists() else ""}
            continue
        tmp = out_dir / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib, log, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, log, t0) in procs.items():
        text, _ = proc.communicate()
        log.write_text(text)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {SOURCES[name]} (rc {proc.returncode})\n"
                          f"{text}")
            continue
        os.replace(tmp, lib)
        result[name] = {"path": str(lib),
                        "seconds": time.perf_counter() - t0, "log": text}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return result


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Load one kernel library, once per process; the first load builds
    every missing library at once."""
    return ctypes.CDLL(build_kernels()[name]["path"])

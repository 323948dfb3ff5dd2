"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each kernel is one source in `csrc/` with a plain C launch function, so
nvcc compiles it in seconds without PyTorch's headers.  A source is
compiled at first use into `build/repro_torch/` at the repository root
(listed in `.gitignore`), under a name keyed by a hash of the source, the
`csrc/*.cuh` headers it includes and the flags, so an edited source or
header is rebuilt and an unchanged one is reused.
Nothing is compiled or loaded when this module is imported.  A library's
first load in a process opens the `obs` span `kernels.load` (args: the
source's `name`, and `built`, whether it was compiled) and, with `obs` on,
adds to the counter `kernels.built`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

from repro_torch import obs

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "headers", "library_path",
           "build", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
#: every kernel source of the port, by stem
SOURCES = ("gather_rows", "flash_attention", "rglru_scan", "matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((str(Path(home) / "bin" / "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built on the machine with the GPU")


def headers(name: str) -> Tuple[str, ...]:
    """The `csrc/*.cuh` headers that source `name` includes, by name."""
    text = (CSRC / f"{name}.cu").read_text()
    return tuple(sorted(set(re.findall(r'^\s*#include\s+"(\w+\.cuh)"', text,
                                       re.MULTILINE))))


def library_path(name: str) -> Path:
    """Where the shared library of source `name` lives once built."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in headers(name):
        h.update(header.encode() + (CSRC / header).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source whose library is missing, one nvcc
    process per source, all started together.  Returns the compiler's
    output (register and spill report included) per freshly built
    source; raises if any compile fails."""
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    logs: Dict[str, str] = {}
    failed = []
    for name, proc, tmp, out in jobs:
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)        # atomic: a reader never sees half
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exit {proc.returncode}\n"
                          f"{logs[name]}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source `name`, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            built = not library_path(name).exists()
            with obs.span("kernels.load", name=name, built=built):
                build([name])
                lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
            if obs.active():
                obs.counter("kernels.built", int(built))
        return lib

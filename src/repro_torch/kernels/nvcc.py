"""Build the port's CUDA sources into shared libraries with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).

Libraries land in ``kernels/_build/`` (git-ignored), named by a hash of
their sources and flags, so a source change rebuilds and an unchanged one
is reused.  ``build_libraries`` starts one ``nvcc`` per library, all at
once, and waits for all of them.  The compiler's report (``-Xptxas -v``:
registers, shared memory, spills) is kept beside each library as ``.log``.
A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: Dict[Path, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built at first use on the card's host")


def library_path(name: str, sources: Sequence[Path]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(Path(src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_libraries(specs: Sequence[Tuple[str, Sequence[Path]]]) -> Dict[str, Path]:
    """Build every ``(name, sources)`` library that is not built yet, one
    ``nvcc`` process each, all started together."""
    out = {name: library_path(name, srcs) for name, srcs in specs}
    todo = [(name, srcs) for name, srcs in specs if not out[name].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name, srcs in todo:
        tmp = out[name].with_name(f"{out[name].name}.{os.getpid()}.tmp")
        log = open(out[name].with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *(str(s) for s in srcs)]
        procs.append((name, tmp, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name} (nvcc exit {rc}):\n{Path(log.name).read_text()}")
        else:
            os.replace(tmp, out[name])
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return out


def load_library(name: str, sources: Sequence[Path]) -> ctypes.CDLL:
    path = build_libraries([(name, sources)])[name]
    if path not in _LOADED:
        _LOADED[path] = ctypes.CDLL(str(path))
    return _LOADED[path]

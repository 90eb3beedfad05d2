"""Build the port's CUDA sources into shared libraries with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).

Libraries land in ``kernels/_build/`` (git-ignored), named by a hash of
their sources, the ``*.cuh`` headers beside them and the flags, so a
source or header change rebuilds and an unchanged one is reused.
``build_libraries`` starts one ``nvcc -c`` per source of every library it
has to build, all at once, waits for all of them, then links
each library from its objects.  The compiler's report (``-Xptxas -v``:
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: Dict[Path, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built at first use on the card's host")


def library_path(name: str, sources: Sequence[Path]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted({hdr for src in sources for hdr in Path(src).parent.glob("*.cuh")})
    for src in [*sources, *headers]:
        h.update(Path(src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_libraries(specs: Sequence[Tuple[str, Sequence[Path]]]) -> Dict[str, Path]:
    """Build every ``(name, sources)`` library that is not built yet: one
    ``nvcc -c`` process per source, all started together, then one link
    per library."""
    out = {name: library_path(name, srcs) for name, srcs in specs}
    todo = [(name, srcs) for name, srcs in specs if not out[name].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{os.getpid()}.tmp"
    procs = []
    for name, srcs in todo:
        for i, src in enumerate(srcs):
            obj = out[name].with_name(f"{out[name].stem}.{i}.{tag}.o")
            log = open(obj.with_suffix(".log"), "w")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            procs.append((name, obj, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    objs: Dict[str, list] = {name: [] for name, _ in todo}
    logs: Dict[str, list] = {name: [] for name, _ in todo}
    for name, obj, log, proc in procs:
        rc = proc.wait()
        log.close()
        text = Path(log.name).read_text()
        os.remove(log.name)
        logs[name].append(text)
        objs[name].append(obj)
        if rc != 0:
            failed.append(f"{name} (nvcc exit {rc}):\n{text}")
    if not failed:
        for name, _ in todo:
            tmp = out[name].with_name(f"{out[name].name}.{tag}")
            link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objs[name])],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                failed.append(f"{name} (link exit {link.returncode}):\n{link.stdout}{link.stderr}")
                continue
            out[name].with_suffix(".log").write_text("".join(logs[name]))
            os.replace(tmp, out[name])
    for name, _ in todo:
        for obj in objs[name]:
            obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return out


def load_library(name: str, sources: Sequence[Path]) -> ctypes.CDLL:
    path = build_libraries([(name, sources)])[name]
    if path not in _LOADED:
        _LOADED[path] = ctypes.CDLL(str(path))
    return _LOADED[path]

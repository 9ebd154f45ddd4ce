"""Build the CUDA sources in ``repro_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, at first use, under
``build/repro_torch_kernels/`` at the root of the checkout. The library file
name carries a hash of the source, of every ``csrc`` header it includes
(``#include "x.cuh"``, followed recursively) and of the flags, so an edited
source or header is rebuilt and a stale library is never loaded. ``build``
starts one ``nvcc`` per missing library, all at once. ptxas's report
(``-Xptxas -v``: registers, shared memory, spills per kernel) is kept beside
each library as ``.log``. A failed build raises with nvcc's stderr.

Nothing here runs at import time; the CPU tests import this module freely.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
# Compile and link flags in one list. The TMA kernel reaches the driver's
# cuTensorMapEncodeTiled through the runtime's entry-point query, so no
# -lcuda is needed.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("adamw", "flash_attention", "flash_attention_sm90",
           "flash_attention_bwd", "flash_attention_bwd_sm90", "rmsnorm")

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built on the machine with the GPU")


def inputs(src: Path) -> list[Path]:
    """``src`` and every local header it includes, recursively, sorted."""
    seen: set[Path] = set()
    todo = [src]
    while todo:
        f = todo.pop()
        if f not in seen:
            seen.add(f)
            todo += [f.parent / n for n in _INCLUDE.findall(f.read_text())]
    return sorted(seen)


def library_path(src: Path) -> Path:
    h = hashlib.sha256()
    for f in inputs(src):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Build the missing libraries of ``csrc/<name>.cu``, one nvcc each, in
    parallel; return every library's path."""
    paths = {n: library_path(CSRC / f"{n}.cu") for n in names}
    procs = {}
    for n, path in paths.items():
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            procs[n] = (tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {n}.cu (exit {proc.returncode}):\n"
                          f"{err}{out}")
            continue
        paths[n].with_suffix(".log").write_text(err + out)
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if it is missing."""
    return ctypes.CDLL(str(build((name,))[name]))


def ptxas_report(name: str) -> str:
    """ptxas's lines on each kernel of a built library: registers, static
    shared memory, spills and warnings (dynamic shared memory is the
    library's ``repro_<name>_smem_bytes``)."""
    log = library_path(CSRC / f"{name}.cu").with_suffix(".log").read_text()
    return "\n".join(ln for ln in log.splitlines()
                     if "Compiling entry" in ln or "Used" in ln
                     or "spill" in ln or "arning" in ln)

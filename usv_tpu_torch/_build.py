"""Build the port's CUDA kernels with ``nvcc`` on first use and load them.

Each source under ``csrc/`` compiles to its own shared library with a plain C
interface, bound with ``ctypes`` (no PyTorch headers, so a build takes
seconds). The library lands in ``build/kernels/`` at the root of the
checkout, named by a hash of the source and the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is. :func:`build` starts one
``nvcc`` per missing source, all together, and waits for them; :func:`load`
builds every missing library at once, so a cold run waits for ``nvcc`` once.

A machine without ``nvcc``, or a failed build, raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

# name -> source under csrc/
SOURCES = {"raycast": "raycast.cu", "asmc_substeps": "asmc_substeps.cu"}

# -fmad=false: see the numerics notes in csrc/*.cu. No fast math.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels are "
        "built from source on first use"
    )


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None, force: bool = False) -> Dict[str, str]:
    """Compile every named kernel (all by default) whose library is missing,
    or every one with ``force``, all in parallel.

    Returns {name: compiler output (ptxas registers and spills)} for the
    builds this call ran. Raises RuntimeError naming each failed build with
    its compiler output.
    """
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if force or not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    errors, logs = [], {}
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {SOURCES[n]} (rc {proc.returncode}):\n{out}")
            continue
        # atomic: concurrent processes may build the same library
        os.replace(tmp, library_path(n))
        logs[n] = out
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def ptxas_report(log: str):
    """``[(entry point, registers, spill store bytes, spill load bytes)]`` of
    each kernel instance in a build's ``-Xptxas -v`` output."""
    pattern = (r"Compiling entry function '(\S+)'.*?(\d+) bytes spill stores, "
               r"(\d+) bytes spill loads.*?Used (\d+) registers")
    return [(entry, int(regs), int(stores), int(loads))
            for entry, stores, loads, regs in re.findall(pattern, log, flags=re.DOTALL)]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first, together with
    every other missing library, if it is missing."""
    lib = _loaded.get(name)
    if lib is None:
        if not library_path(name).exists():
            build()
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib

"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

Each ``csrc/<name>.cu`` compiles with nvcc into its own shared library with
a plain C interface, loaded with ctypes; ``csrc/*.cuh`` holds device code
they share. Libraries land in ``ops/_build/``
(listed in .gitignore) under a name that carries a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one is reused.
``build_all`` starts one nvcc per source at once and waits for all of them.
Nothing here runs at import: the CPU tests import every module, and the
CPU-only machines have no nvcc.
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
from typing import Dict, Iterable

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
KERNELS = ("place", "evict", "blocks")
# sm_90a: Hopper with its architecture-specific features. -fmad=false keeps
# every multiply and add separately rounded, as PyTorch's elementwise ops
# are, so a kernel and its plain version agree bit for bit. -Xptxas=-v
# reports registers, shared memory and spills into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the CUDA kernels")
    return found


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the headers of
    ``csrc`` it may include and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, all nvcc
    processes at once; returns each kernel's build log (empty when the
    library was already there). Raises with nvcc's output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    logs: Dict[str, str] = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            logs[name] = ""
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (lib, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (lib, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
            continue
        lib.with_suffix(".log").write_text(out)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def build_log(name: str) -> str:
    """nvcc's output (with ptxas's registers, stack frames and spills) from
    the build of the named kernel's current library, built first if it is
    missing."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        build_all([name])
    return log.read_text()


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """Per kernel function of the named library's build (mangled name):
    registers, stack frame bytes, spill store and spill load bytes, as
    ``ptxas -v`` printed them."""
    out: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in build_log(name).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {})
            continue
        if fn is None:
            continue
        for key, pat in (("stack", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers")):
            m = re.search(pat, line)
            if m:
                out[fn][key] = int(m.group(1))
    return out


def load(name: str) -> ctypes.CDLL:
    """The named kernel's library, built first if it is missing."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib

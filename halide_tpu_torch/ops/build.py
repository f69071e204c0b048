"""The one build route of the port's compiled code: a compiler -> a shared
library with a plain C interface -> `ctypes`.

The CUDA kernels go through `nvcc` (`load`); the native host runtime
(runtime/native/ht_runtime.cpp, the trace writer and the memo cache) goes
through `g++` (`load_host`). No source includes PyTorch's headers, so a
build takes seconds. Each source is built once into `build/kernels/<key>.so`
(git-ignored), a kernel for Hopper (`sm_90a`); the key names the source and
its content, so an edited source builds anew, and a host build's key starts
with `host_`, so it never meets a kernel's. A build or load failure raises
with the compiler's stderr: the port never falls back to another route.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_TIMEOUT_S = 180
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v"]

builds: List[Tuple[str, float]] = []       # (library key, nvcc seconds)
# library key -> ptxas's report of each kernel: registers, shared memory,
# stack and spills (`-Xptxas -v`, kept beside the library)
ptxas: Dict[str, List[str]] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return "/usr/local/cuda/bin/nvcc"


def source_key(name: str, text: str) -> str:
    return f"{name}_{hashlib.sha1(text.encode()).hexdigest()[:16]}"


def load(key: str, cu: Path) -> ctypes.CDLL:
    """nvcc `cu` into BUILD_DIR/<key>.so (once per key) and load it."""
    lib = _LIBS.get(key)
    if lib is not None:
        return lib
    so = BUILD_DIR / f"{key}.so"
    if not so.exists():
        r = _compile(key, [nvcc()] + NVCC_FLAGS + ["-I", str(CSRC)], cu)
        so.with_suffix(".ptxas").write_text("\n".join(
            ln.split(":", 1)[-1].strip() for ln in r.stderr.splitlines()
            if "Used" in ln or "spill" in ln or "Compiling entry" in ln))
    if key not in ptxas and so.with_suffix(".ptxas").exists():
        ptxas[key] = so.with_suffix(".ptxas").read_text().splitlines()
    return _open(key, so)


def _compile(key: str, cmd: List[str], src: Path):
    """Run the compiler `cmd` on `src` into BUILD_DIR/<key>.so (written
    under a temporary name first, so that concurrent builds never load a
    half-written library); raises with its stderr on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{key}.{os.getpid()}.so"
    t0 = time.time()
    r = subprocess.run(cmd + ["-o", str(tmp), str(src)], capture_output=True,
                       text=True, timeout=NVCC_TIMEOUT_S)
    if r.returncode != 0:
        raise RuntimeError(
            f"{cmd[0]} failed on {src} (exit {r.returncode}):\n{r.stderr}")
    os.replace(tmp, BUILD_DIR / f"{key}.so")
    builds.append((key, time.time() - t0))
    return r


def _open(key: str, so: Path) -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as ex:
        raise RuntimeError(f"cannot load {so}: {ex}") from ex
    _LIBS[key] = lib
    return lib


def load_host(src: Path) -> ctypes.CDLL:
    """g++ the host source `src` into BUILD_DIR/host_<name>_<hash>.so (once
    per content) and load it."""
    key = source_key(f"host_{src.stem}", src.read_text())
    lib = _LIBS.get(key)
    if lib is not None:
        return lib
    so = BUILD_DIR / f"{key}.so"
    if not so.exists():
        _compile(key, [shutil.which("g++") or "g++"] + GXX_FLAGS, src)
    return _open(key, so)


_FIXED: Dict[str, ctypes.CDLL] = {}


def load_fixed(name: str) -> ctypes.CDLL:
    """Build (once per process) and load the fixed source csrc/<name>.cu."""
    lib = _FIXED.get(name)
    if lib is None:
        cu = CSRC / f"{name}.cu"
        lib = _FIXED[name] = load(source_key(name, cu.read_text()), cu)
    return lib

"""The one build route of the port's CUDA kernels: `nvcc` -> a shared
library with a plain C interface -> `ctypes`.

No source includes PyTorch's headers, so a build takes seconds. Each source
is built once into `build/kernels/<key>.so` (git-ignored) for Hopper
(`sm_90a`); the key names the source's content, so an edited source builds
anew. A build or load failure raises with nvcc's stderr: the port never
falls back from a kernel to another route.
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
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"{key}.so"
    if not so.exists():
        tmp = BUILD_DIR / f"{key}.{os.getpid()}.so"
        cmd = [nvcc()] + NVCC_FLAGS + ["-I", str(CSRC), "-o", str(tmp),
                                       str(cu)]
        t0 = time.time()
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=NVCC_TIMEOUT_S)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {cu} (exit {r.returncode}):\n{r.stderr}")
        so.with_suffix(".ptxas").write_text("\n".join(
            ln.split(":", 1)[-1].strip() for ln in r.stderr.splitlines()
            if "Used" in ln or "spill" in ln or "Compiling entry" in ln))
        os.replace(tmp, so)
        builds.append((key, time.time() - t0))
    if key not in ptxas and so.with_suffix(".ptxas").exists():
        ptxas[key] = so.with_suffix(".ptxas").read_text().splitlines()
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as ex:
        raise RuntimeError(f"cannot load {so}: {ex}") from ex
    _LIBS[key] = lib
    return lib


_FIXED: Dict[str, ctypes.CDLL] = {}


def load_fixed(name: str) -> ctypes.CDLL:
    """Build (once per process) and load the fixed source csrc/<name>.cu."""
    lib = _FIXED.get(name)
    if lib is None:
        cu = CSRC / f"{name}.cu"
        lib = _FIXED[name] = load(source_key(name, cu.read_text()), cu)
    return lib

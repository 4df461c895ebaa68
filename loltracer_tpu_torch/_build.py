"""Builds generated CUDA sources with nvcc into shared libraries with a plain
C interface, loaded with ctypes.

Each library is compiled at first use from the source text it is given, for
Hopper (`sm_90a`), into `loltracer_tpu_torch/_build/` (git-ignored), under a
name keyed by the sha256 of the source and the flags; a later call with the
same source loads the file already built. Only the CUDA toolkit's headers
and the C++ standard library are used — no PyTorch headers, which would
cost minutes of compile time per build.

`--fmad=false` keeps every multiply and add separately rounded, as they are
in the plain PyTorch version, so the kernel's arithmetic matches it op for
op (an FMA contraction of 1 ulp flips near-tied argmins). Never
`--use_fast_math`: it would replace IEEE division and sqrt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, NamedTuple

BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-O3",
    "-std=c++17",
    "--fmad=false",
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)


class Library(NamedTuple):
    lib: ctypes.CDLL
    log: str  # nvcc's output, with ptxas' registers and spills per kernel


_loaded: Dict[str, Library] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then the toolkit's default
    install location."""
    home = os.environ.get("CUDA_HOME")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME to the CUDA toolkit); the CUDA kernels "
        "are compiled at first use"
    )


def build(source: str, stem: str) -> Library:
    """Compile `source` (one .cu translation unit) into a shared library and
    load it; cached on disk and in this process by content."""
    key = hashlib.sha256(
        "\0".join((source,) + NVCC_FLAGS).encode()
    ).hexdigest()[:24]
    if key in _loaded:
        return _loaded[key]
    so = BUILD_DIR / f"{stem}-{key}.so"
    log_path = so.with_suffix(".log")
    if not so.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu = so.with_suffix(".cu")
        cu.write_text(source)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(cu)],
            capture_output=True,
            text=True,
        )
        log_path.write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {cu}:\n"
                + (proc.stdout + proc.stderr)[-4000:]
            )
        os.replace(tmp, so)  # atomic: a concurrent process never loads half a file
    log = log_path.read_text() if log_path.is_file() else ""
    _loaded[key] = Library(ctypes.CDLL(str(so)), log)
    return _loaded[key]

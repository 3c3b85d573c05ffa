"""Build a CUDA source of ``rl_agents_torch/csrc/`` into a shared library with
``nvcc``, at first use, into the git-ignored ``rl_agents_torch/_build/``,
keyed on a hash of the source and the flags. The libraries have a plain C
interface and are loaded with ``ctypes`` by the module that launches them."""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
BUILD_DIR = PACKAGE / "_build"
# no --use_fast_math: logf, sqrtf, division, inf and nan keep IEEE semantics;
# --fmad=false: no contraction into FMA, each op rounds like the plain version
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def build(source: Path, stem: str) -> Path:
    """Build ``source`` with ``NVCC_FLAGS`` into ``_build/<stem>_<digest>.so``
    if it is not built yet; return its path. The compiler's output (``-Xptxas -v``:
    registers, spills) is kept beside it as ``<library>.log``. A failed build
    raises with that output."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"{stem}_{digest}.so"
    if lib_path.is_file():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    lib_path.with_suffix(".so.log").write_text(log)
    os.replace(tmp, lib_path)
    return lib_path

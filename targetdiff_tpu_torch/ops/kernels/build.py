"""Build the CUDA sources into one shared library and load it with ctypes.

At first CUDA use, `load_library` compiles every `csrc/*.cu` with nvcc for
sm_90a into `targetdiff_tpu_torch/_build/<hash of sources and flags>/`, so a
checkout builds its own kernels and a changed source gets a fresh directory.
The sources compile in parallel, one nvcc each, and link into one library.
A missing nvcc or a failed compile raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
NVCC_CANDIDATES = ["/usr/local/cuda/bin/nvcc"]  # tried when nvcc is not on PATH
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class KernelBuildError(RuntimeError):
    pass


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or next(
        (c for c in NVCC_CANDIDATES if os.path.exists(c)), None)
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found: the CUDA kernels are compiled from targetdiff_tpu_torch/csrc "
            "at first CUDA use and need the CUDA toolkit (nvcc on PATH or /usr/local/cuda)")
    return nvcc


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build_dir() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load libtdkernels.so. The build
    seconds and the compiler's report (`-Xptxas -v`) go to build.log beside
    the library."""
    out = build_dir()
    lib_path = out / "libtdkernels.so"
    if not lib_path.exists():
        nvcc = find_nvcc()
        out.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        srcs = [s for s in _sources() if s.suffix == ".cu"]
        objs = [out / f"{s.stem}.{os.getpid()}.o" for s in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)] for s, o in zip(srcs, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        outputs = [proc.communicate() for proc in procs]  # waits for every compile
        logs = [f"{' '.join(c)}\n{o}\n{e}" for c, (o, e) in zip(cmds, outputs)]
        for proc, log in zip(procs, logs):
            if proc.returncode != 0:
                raise KernelBuildError(f"nvcc failed with exit code {proc.returncode}:\n{log}")
        tmp = out / f"libtdkernels.{os.getpid()}.tmp.so"
        link = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp), *[str(o) for o in objs]]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc link failed with exit code {proc.returncode}:\n"
                                   f"{' '.join(link)}\n{proc.stdout}\n{proc.stderr}")
        seconds = time.perf_counter() - t0
        (out / "build.log").write_text(f"build_seconds {seconds:.3f}\n" + "\n".join(logs))
        os.replace(tmp, lib_path)
        for o in objs:
            o.unlink()
    return ctypes.CDLL(str(lib_path))


def check(status: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(t, name: str):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")

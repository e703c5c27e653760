"""Build and bind the port's hand-written Hopper kernels.

Each kernel is a plain C entry point in one CUDA C++ source under
`diff_sal_tpu_torch/csrc/` (a source may hold several: K1 and K12 share
`attention.cu`, K5 and K12's backward `attention_bwd.cu`, the f32
instances of the forward `attention_f32_fwd.cu` and of the backward
`attention_f32.cu`, K4 and K10 `resize.cu`). Each source is compiled with
nvcc for `sm_90a` into one shared library, named by the source and the
hash of its text and of the local headers it includes (`#include
"hopper.cuh"`, and the headers those include), in
`diff_sal_tpu_torch/_build/` (git-ignored), and loaded with ctypes.
Nothing is compiled when a module is imported: the first CUDA launch
builds its library, and `build_all()` builds every library at once with
one nvcc per source, all started together.

The C entry points take device pointers and the CUDA stream as
`c_void_p`, sizes as `c_int`, and return `cudaGetLastError()` after the
launch; `check()` raises on a non-zero code. There is no CPU fallback here:
the wrappers in the op modules route CPU tensors to their plain PyTorch
versions and everything on a CUDA tensor through a library from this
module, or raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

import torch
from torch.distributed.tensor import DTensor

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin)")


class Kernel:
    """One hand-written kernel: its source, the TPU kernel it replaces, the
    C signature of its entry point, its loaded library and its launch
    count (incremented by the op wrapper once per launch, nowhere else)."""

    def __init__(self, name: str, source: str, entry: str,
                 argtypes: Sequence, replaces: str):
        self.name = name
        self.source = source
        self.entry = entry
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.launches = 0
        self._fn = None
        self.build_log = ""

    @property
    def source_path(self) -> Path:
        return CSRC_DIR / self.source

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source_path.read_bytes())
        # an edited header rebuilds every source that includes it, directly
        # or through another header
        for header in _local_headers(self.source_path):
            digest.update((CSRC_DIR / header).read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source_path.stem}-{digest.hexdigest()[:16]}.so"

    def start_build(self):
        """Start nvcc for this source unless its library exists; returns the
        running process (or None) and the library path."""
        lib = self.library_path()
        if lib.exists():
            return None, lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source_path)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc.lib_tmp = tmp
        return proc, lib

    def finish_build(self, proc, lib: Path):
        if proc is None:
            return
        out, _ = proc.communicate()
        self.build_log = out
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc failed for {self.source}:\n{out}")
        os.replace(proc.lib_tmp, lib)

    def fn(self):
        """The loaded C entry point, building the library on first use."""
        if self._fn is None:
            proc, lib = self.start_build()
            self.finish_build(proc, lib)
            cdll = ctypes.CDLL(str(lib))
            f = getattr(cdll, self.entry)
            f.argtypes = self.argtypes
            f.restype = ctypes.c_int
            self._fn = f
        return self._fn

    def launch(self, *args):
        """Call the entry point on the current stream and raise on a CUDA
        error; counts one launch."""
        err = self.fn()(*args)
        if err != 0:
            raise KernelLaunchError(
                f"{self.name}: CUDA error {err} ({_cuda_error_name(err)})"
            )
        self.launches += 1


def _local_headers(path: Path) -> List[str]:
    """The local headers (`#include "x.cuh"`) a source includes, and those
    they include, sorted."""
    seen, todo = set(), [path]
    while todo:
        for name in re.findall(rb'#include "([^"]+)"', todo.pop().read_bytes()):
            name = name.decode()
            if name not in seen:
                seen.add(name)
                todo.append(CSRC_DIR / name)
    return sorted(seen)


def _cuda_error_name(code: int) -> str:
    try:
        cudart = ctypes.CDLL("libcudart.so")
        cudart.cudaGetErrorString.restype = ctypes.c_char_p
        return cudart.cudaGetErrorString(code).decode()
    except OSError:
        return "unknown"


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def registry() -> Dict[str, Kernel]:
    """Every kernel of the port, by name."""
    from diff_sal_tpu_torch.ops import attention, layernorm, mlp, pool, resize

    return {k.name: k for k in (attention.KERNEL, layernorm.KERNEL, mlp.KERNEL,
                                resize.KERNEL, attention.BWD_KERNEL,
                                layernorm.BWD_KERNEL, attention.CVT_KERNEL,
                                resize.CONV_KERNEL, resize.CONV_F32_KERNEL, resize.PHASE_KERNEL,
                                resize.ADD_KERNEL,
                                pool.KERNEL, attention.CLS_KERNEL, attention.CLS_BWD_KERNEL,
                                *attention.F32_KERNELS, mlp.F32_KERNEL)}


def build_all() -> Dict[str, float]:
    """Build every library not yet built, one nvcc per source, all started
    together. Returns the seconds each source's build took (0 for a cached
    one); every kernel of a source keeps that build's log."""
    by_source: Dict[str, List[Kernel]] = {}
    for k in registry().values():
        by_source.setdefault(k.source, []).append(k)
    t0 = time.perf_counter()
    started = [(ks, *ks[0].start_build()) for ks in by_source.values()]
    secs = {}
    for ks, proc, lib in started:
        ks[0].finish_build(proc, lib)
        for k in ks:
            k.build_log = ks[0].build_log
        secs[ks[0].source] = 0.0 if proc is None else time.perf_counter() - t0
    return secs


def reset_launch_counts():
    for k in registry().values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in registry().items()}


def acc_dtype(dt: torch.dtype) -> torch.dtype:
    """The dtype the plain versions and the models' f32 islands accumulate
    in: f32, or f64 for f64 inputs (gradient checks, and a whole step run
    in f64 as the reference for f32 rounding)."""
    return torch.float64 if dt == torch.float64 else torch.float32


def refuse_dtensor(what: str, *tensors):
    """A kernel wrapper takes plain tensors (lists of them too): a weight
    sharded by tensor parallelism (a DTensor) is gathered by its caller
    first (`parallel/tensor.full`)."""
    for t in tensors:
        for u in (t if isinstance(t, (list, tuple)) else (t,)):
            if isinstance(u, DTensor):
                raise TypeError(f"{what}: a DTensor argument; kernel wrappers take plain "
                                "tensors (gather a sharded weight with parallel.tensor.full)")


def require_cuda(t: torch.Tensor, what: str):
    """A tensor that is neither on the CPU nor on CUDA has no route."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensor on {t.device}; expected cpu or cuda")


def check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)

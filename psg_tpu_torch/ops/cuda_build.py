"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds, not minutes).  Libraries are built at first
use into ``build/psg_tpu_torch/`` at the repository root, named by a hash of
their sources and flags so an edited source rebuilds.  Nothing is built or
imported from CUDA when a module is imported: the CPU tests import every
module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

from psg_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "psg_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: set CUDA_HOME or put nvcc "
                           "on PATH")
    return str(Path(CUDA_HOME) / "bin" / name)


class KernelLibrary:
    """One ``csrc/<source>`` shared library, its C entry points and the
    count of kernel launches made through it from the host (the counter
    ``launch.<name>`` of ``utils.profiling``: a launch captured in a CUDA
    graph counts once, its replays not at all)."""

    def __init__(self, name: str, source: str, signatures: Dict[str, tuple]):
        self.name = name
        self.source = CSRC / source
        self.signatures = signatures  # C function -> (restype, argtypes)
        self.counter = f"launch.{name}"
        self._lib = None

    @property
    def launches(self) -> int:
        return profiling.counts().get(self.counter, 0)

    @property
    def path(self) -> Path:
        h = hashlib.sha1()
        # the headers a source may include are part of its hash
        for p in (*sorted(CSRC.glob("*.cuh")), self.source):
            h.update(p.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.source.stem}-{h.hexdigest()[:12]}.so"

    @property
    def log_path(self) -> Path:
        """nvcc's output (ptxas -v) of the build at ``path``."""
        return self.path.with_suffix(".log")

    def _start_build(self):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cuda_tool("nvcc"), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(self.source)]
        return tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)

    def _finish_build(self, tmp: Path, proc) -> str:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source.name} "
                               f"(exit {proc.returncode}):\n{out}")
        self.log_path.write_text(out)
        os.replace(tmp, self.path)  # atomic: concurrent builds agree
        return out

    def lib(self):
        """The loaded library, built first if this source has no build."""
        if self._lib is None:
            if not self.path.exists():
                self._finish_build(*self._start_build())
            lib = ctypes.CDLL(str(self.path))
            for fn, (restype, argtypes) in self.signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = restype
            lib.psg_error_string.argtypes = [ctypes.c_int]
            lib.psg_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def check(self, rc: int) -> None:
        """Raise on a non-zero ``cudaError_t`` from a launch; else count it."""
        if rc != 0:
            msg = self.lib().psg_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: kernel launch failed: {msg} ({rc})")
        profiling.count(self.counter)


def build_all(libs: Iterable[KernelLibrary]) -> Dict[str, dict]:
    """Build every library that has no build yet, one ``nvcc`` per source,
    all started together.  Returns per-library build seconds and compiler
    output (``-Xptxas -v``: registers, shared memory, spills; kept beside
    each library, so a library built earlier reports it too)."""
    libs = list(libs)
    t0 = time.perf_counter()
    started = {lib.name: lib._start_build() for lib in libs
               if not lib.path.exists()}
    report, errors = {}, []
    for lib in libs:  # wait for every nvcc before raising on any
        report[lib.name] = {"built": lib.name in started, "seconds": 0.0,
                            "nvcc_output": (lib.log_path.read_text()
                                            if lib.log_path.exists() else "")}
        if lib.name in started:
            try:
                report[lib.name]["nvcc_output"] = lib._finish_build(*started[lib.name])
            except RuntimeError as e:
                errors.append(str(e))
            report[lib.name]["seconds"] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    for lib in libs:
        lib.lib()
    return report


def check_cuda_tensor(name: str, t: torch.Tensor, dtype=None, *,
                      contiguous: bool = True) -> None:
    """The checks every wrapper makes before handing a pointer to a kernel
    (``contiguous=False`` for a kernel that takes strides)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensor on {t.device}, but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if dtype is not None and t.dtype not in dtype:
        raise TypeError(f"{name}: dtype {t.dtype} not supported "
                        f"(takes {', '.join(str(d) for d in dtype)})")


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream

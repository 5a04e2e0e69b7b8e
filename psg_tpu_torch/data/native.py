"""ctypes binding to the native augmentation engine (``native/augment.cc``).

The port's own binding (``psg_tpu/data/native.py`` is the JAX package's).
At first use it compiles ``native/augment.cc`` with the flags of
``native/Makefile`` into ``build/psg_tpu_torch/`` (gitignored), named by a
hash of the source and the flags, and never writes beside the tracked
source.  The engine is chosen by the JAX package's rule: native when the
library builds and loads, the Python engine (``data/augment.py``)
otherwise; ``available()`` says which, and the choice is logged once.  The
two engines make different batches, so a run that must use the native one
checks ``available()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shlex
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "augment.cc"
BUILD_DIR = _ROOT / "build" / "psg_tpu_torch"
# native/Makefile's CXXFLAGS and LDFLAGS
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LDFLAGS = ("-shared", "-lpthread")

_lib = None
_tried = False
# the loader's threads ask for the engine at once on the first batches; one
# builds while the others wait, so none of them takes the Python engine
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join((*CXXFLAGS, *LDFLAGS)).encode())
    return BUILD_DIR / f"libpsgaug-{h.hexdigest()[:12]}.so"


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cxx = shlex.split(os.environ.get("CXX", "g++"))
    subprocess.run([*cxx, *CXXFLAGS, str(SOURCE), "-o", str(tmp), *LDFLAGS],
                   check=True, capture_output=True, timeout=300)
    os.replace(tmp, path)  # atomic: concurrent builds agree


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if not _tried:
            _lib = _open()
            _tried = True
        return _lib


def _open() -> Optional[ctypes.CDLL]:
    path = library_path()
    try:
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.psg_augment_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ]
        lib.psg_augment_batch.restype = None
        lib.psg_native_version.restype = ctypes.c_int
        if lib.psg_native_version() != 1:
            raise RuntimeError(f"{path.name}: unexpected engine version "
                               f"{lib.psg_native_version()}")
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        log.warning("augmentation engine: python (native build or load failed: %s)", e)
        return None
    log.info("augmentation engine: native (%s)", path.name)
    return lib


def available() -> bool:
    """True when the native engine built and loaded (the loader uses it)."""
    return _load() is not None


def augment_batch(images: np.ndarray, seed: int,
                  background: Tuple[int, int, int] = (255, 255, 255),
                  augment: bool = True, num_threads: int = 4) -> np.ndarray:
    """uint8 [N,H,W,3] -> fp32 [N,H,W,3] in [-1,1], optionally augmented.

    Deterministic in (images, seed).  Releases the GIL for the whole batch.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native augment library unavailable")
    images = np.ascontiguousarray(images, dtype=np.uint8)
    n, h, w, c = images.shape
    if c != 3:
        raise ValueError(f"augment_batch: expected RGB images, got {c} channels")
    out = np.empty((n, h, w, 3), np.float32)
    bg = np.asarray(background, np.uint8)
    lib.psg_augment_batch(
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_uint64(np.uint64(seed & (2**64 - 1))),
        bg.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        1 if augment else 0,
        num_threads,
    )
    return out

"""Builds the port's CUDA sources at first use and loads them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers), one ``nvcc`` process
per source, all started together, into ``build/kernels/`` at the repository
root.  A library's file name carries a hash of its source, the ``csrc/*.cuh``
headers and the flags, so an edited source is rebuilt and a built one is
reused.  Nothing is built or loaded at import: the ops call :func:`kernel`
when they first launch on a CUDA tensor, and :func:`count_launch` each time
they launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["SOURCES", "build", "kernel", "count_launch"]

_CSRC = Path(__file__).resolve().parent
SOURCES = {path.stem: path for path in sorted(_CSRC.glob("*.cu"))}
_BUILD_DIR = _CSRC.parents[1] / "build" / "kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, ctypes._CFuncPtr] = {}
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the port's kernels are built "
                       "from csrc/ at first use")


def _target(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    return _BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` source not built yet (one ``nvcc`` per
    source, all started together) and return ``{name: library path}``;
    raises with nvcc's stderr on failure.  ``-Xptxas -v``'s register report
    lands in the ``.log`` beside each library."""
    out = {name: _target(name) for name in SOURCES}
    todo = {name: path for name, path in out.items() if not path.is_file()}
    if not todo:
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (cmd, tmp, proc) in procs.items():
        try:
            _, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{err}")
            continue
        todo[name].with_suffix(".log").write_text(err)
        os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def kernel(name: str, symbol: str, argtypes: Sequence, restype=ctypes.c_int):
    """``symbol`` of the library built from ``csrc/<name>.cu`` (built at the
    first call), with its ctypes signature set.  Pass every pointer as
    ``c_void_p`` so none is cut to 32 bits."""
    with _lib_lock:
        fn = _fns.get(symbol)
        if fn is None:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(str(build()[name]))
            fn = getattr(_libs[name], symbol)
            fn.argtypes = list(argtypes)
            fn.restype = restype
            _fns[symbol] = fn
        return fn


def count_launch(wrapper, dtype) -> None:
    """One launch of ``wrapper``'s kernel, instantiated for ``dtype``: adds
    one to ``wrapper.launches`` and to ``wrapper.launches_by_dtype["float32"
    or "bfloat16"]``."""
    wrapper.launches += 1
    wrapper.launches_by_dtype[str(dtype).replace("torch.", "")] += 1

"""Builds the port's CUDA sources at first use and loads them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers), one ``nvcc`` process
per source, all started together, into ``build/kernels/`` at the repository
root.  A library's file name carries a hash of its source, the ``csrc/*.cuh``
headers and the flags, so an edited source is rebuilt and a built one is
reused.  Nothing is built or loaded at import: the ops call :func:`kernel`
when they first launch on a CUDA tensor, and :func:`count_launch` each time
they launch.

**Warm start.**  A runner given ``--warmstart-dir`` calls
:func:`set_store` with a ``serving.warmstart.WarmStore`` before its first
kernel.  :func:`build` then looks each missing library up in the store
(its key: the runtime fields of ``serving/warmkey.py`` and this file's
digest as the program): a hit is placed under its build name atomically
and skips nvcc; a miss or an unusable entry (a fallback) is built by nvcc
as without a store and saved.  Before :func:`kernel` hands out any
function of a library that came from the store, the library's canary
(registered by the op module with :func:`register_canary`) runs each of
its kernels once at a small fixed shape against the plain PyTorch version;
a rejected library is counted, rebuilt by nvcc under a new file name
(a library is never unloaded: a captured CUDA graph may hold its
functions) and saved over.  :func:`library_counts` has the hits, misses,
fallbacks, canary rejects, serialized entries and nvcc runs of each
library.  A build that fails raises, store or not.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import logging
import os
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

__all__ = ["SOURCES", "build", "kernel", "count_launch", "set_store",
           "register_canary", "library_counts", "library_digests",
           "rebuild_store_libraries", "store_totals", "uncounted"]

_logger = logging.getLogger(__name__)

_CSRC = Path(__file__).resolve().parent
SOURCES = {path.stem: path for path in sorted(_CSRC.glob("*.cu"))}
_BUILD_DIR = _CSRC.parents[1] / "build" / "kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_COUNT_KEYS = ("hits", "misses", "fallbacks", "canary_rejects",
               "serialized", "nvcc")

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, ctypes._CFuncPtr] = {}
_fn_lib: Dict[str, str] = {}           # symbol -> library name
_lib_lock = threading.RLock()          # a canary re-enters kernel()
_store = None
_origin: Dict[str, str] = {}           # name -> "store" (canary pending),
# "verified" (canary passed), "nvcc" or "local" (built by an earlier run)
_rebuilt: Dict[str, Path] = {}         # name -> library rebuilt after a reject
_canaries: Dict[str, Callable[[], Optional[str]]] = {}
_counts: Dict[str, Counter] = {name: Counter() for name in SOURCES}
_nvcc_s = 0.0


def _nvcc() -> str:
    from ..serving.warmkey import nvcc_path
    found = nvcc_path()
    if found is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the port's kernels are "
                           "built from csrc/ at first use")
    return found


def _digest(name: str) -> str:
    digest = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def _target(name: str) -> Path:
    return _BUILD_DIR / f"{name}-{_digest(name)}.so"


def library_digests() -> List[str]:
    """``<name>-<digest>`` of every source: what a capture's store key
    carries of the kernels it replays."""
    return [f"{name}-{_digest(name)}" for name in SOURCES]


def _nvcc_compile(todo: Dict[str, Path]) -> Dict[str, str]:
    """Run one nvcc per ``{name: output path}``, all started together;
    returns ``{name: ptxas log}``, raises with nvcc's stderr on failure."""
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed, logs = [], {}
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
        logs[name] = err
        os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


#: the compiler: ``{name: output path}`` -> ``{name: ptxas log}`` (a seam
#: the CPU tests replace, since there is no nvcc there)
_compile = _nvcc_compile


def set_store(store) -> None:
    """Use ``store`` (a ``serving.warmstart.WarmStore``, or None) for the
    libraries not built yet."""
    global _store
    with _lib_lock:
        _store = store


def register_canary(name: str, fn: Callable[[], Optional[str]]) -> None:
    """``fn()`` runs the kernels of library ``name`` once at a small shape
    against their plain versions: None when they agree, else why not."""
    _canaries[name] = fn


def _device_fields():
    import torch
    if not torch.cuda.is_available():
        return "cpu", ""
    major, minor = torch.cuda.get_device_capability()
    return torch.cuda.get_device_name(), f"{major}.{minor}"


def _library_fields(name: str) -> dict:
    from ..serving.warmkey import key_fields
    kind, capability = _device_fields()
    return key_fields(device_kind=kind, capability=capability,
                      program=_digest(name), geometry={"library": name},
                      bucket=0, chans=0, wire="", quant="")


def _save(name: str, path: Path, log: str) -> None:
    from ..serving.warmkey import nvcc_version
    if _store.save_library(_library_fields(name), str(path),
                           nvcc_version=nvcc_version(), ptxas_log=log):
        _counts[name]["serialized"] += 1


def _nvcc_build(todo: Dict[str, Path]) -> None:
    """nvcc for ``todo``, counted, the ptxas logs beside the libraries and,
    with a store, the libraries saved."""
    global _nvcc_s
    if not todo:
        return
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    logs = _compile(todo)
    _nvcc_s += time.perf_counter() - t0
    for name, path in todo.items():
        _counts[name]["nvcc"] += 1
        path.with_suffix(".log").write_text(logs.get(name, ""))
        _origin[name] = "nvcc"
        if _store is not None:
            _save(name, path, logs.get(name, ""))


def build() -> Dict[str, Path]:
    """Bring every ``csrc/*.cu`` library into ``build/kernels/`` (from the
    store where one is set and holds it, else one ``nvcc`` per source, all
    started together) and return ``{name: library path}``; raises with
    nvcc's stderr on failure.  ``-Xptxas -v``'s register report lands in
    the ``.log`` beside each library."""
    from ..serving.warmstart import WarmstartMiss
    with _lib_lock:
        out = {name: _rebuilt.get(name) or _target(name) for name in SOURCES}
        todo = {}
        for name, path in out.items():
            if path.is_file():
                _origin.setdefault(name, "local")
                continue
            if _store is not None:
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                try:
                    manifest = _store.load_library(_library_fields(name),
                                                   str(path))
                except WarmstartMiss as e:
                    _counts[name]["misses" if e.reason == "absent"
                                  else "fallbacks"] += 1
                    if e.reason != "absent":
                        _logger.warning("warmstart: library %s unusable "
                                        "(%s); building it with nvcc",
                                        name, e)
                else:
                    _counts[name]["hits"] += 1
                    _origin[name] = "store"
                    path.with_suffix(".log").write_text(
                        manifest.get("ptxas_log", ""))
                    continue
            todo[name] = path
        _nvcc_build(todo)
        return out


def _reload(name: str) -> None:
    """nvcc ``name`` again under a new file name (the loaded library stays
    mapped), place the result under its build name too, save it, and load
    it; functions handed out of the old library are forgotten."""
    target = _target(name)
    fresh = target.with_name(
        f"{target.stem}.r{_counts[name]['nvcc'] + 1}.so")
    _nvcc_build({name: fresh})
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_bytes(fresh.read_bytes())
    os.replace(tmp, target)
    _rebuilt[name] = fresh
    _libs[name] = ctypes.CDLL(str(fresh))
    for symbol in [s for s, n in _fn_lib.items() if n == name]:
        del _fns[symbol], _fn_lib[symbol]


def _canary(name: str) -> None:
    """Run library ``name``'s canary; on a reject rebuild it by nvcc."""
    check = _canaries.get(name)
    try:
        why = check() if check is not None else None
    except Exception as e:                     # noqa: BLE001 — any fault
        why = f"{type(e).__name__}: {e}"
    if why is None:
        _origin[name] = "verified"
        return
    _counts[name]["canary_rejects"] += 1
    _logger.error("warmstart: library %s from the store REJECTED by its "
                  "canary (%s); rebuilding it with nvcc", name, why)
    _reload(name)


def kernel(name: str, symbol: str, argtypes: Sequence, restype=ctypes.c_int):
    """``symbol`` of the library built from ``csrc/<name>.cu`` (built at the
    first call), with its ctypes signature set.  Pass every pointer as
    ``c_void_p`` so none is cut to 32 bits."""
    with _lib_lock:
        fn = _fns.get(symbol)
        if fn is None:
            if name not in _libs:
                # set before the canary, whose own launches re-enter here
                _libs[name] = ctypes.CDLL(str(build()[name]))
                if _origin.get(name) == "store":
                    _canary(name)
            fn = getattr(_libs[name], symbol)
            fn.argtypes = list(argtypes)
            fn.restype = restype
            _fns[symbol] = fn
            _fn_lib[symbol] = name
        return fn


def rebuild_store_libraries() -> List[str]:
    """nvcc every loaded library that came from the store again, under new
    file names (the old ones stay mapped for the graphs that hold them);
    returns their names.  After it, every graph captured before must be
    captured again."""
    with _lib_lock:
        names = [n for n in list(_libs)
                 if _origin.get(n) in ("store", "verified")]
        for name in names:
            _reload(name)
        return names


def library_counts() -> Dict[str, object]:
    """``{"libraries": {name: {hits, misses, fallbacks, canary_rejects,
    serialized, nvcc, origin}}, "nvcc_s": seconds nvcc ran}``."""
    with _lib_lock:
        return {"libraries": {
            name: dict({k: int(_counts[name][k]) for k in _COUNT_KEYS},
                       origin=_origin.get(name, ""))
            for name in SOURCES}, "nvcc_s": _nvcc_s}


def store_totals() -> Counter:
    """The counts of every library summed, by key."""
    with _lib_lock:
        total = Counter()
        for c in _counts.values():
            total.update(c)
        return total


@contextlib.contextmanager
def uncounted(*wrappers):
    """Launches inside the block leave the wrappers' counts as they were
    (a canary's launches are no launches of the path)."""
    saved = [(w.launches, Counter(w.launches_by_dtype)) for w in wrappers]
    try:
        yield
    finally:
        for w, (n, by) in zip(wrappers, saved):
            w.launches = n
            w.launches_by_dtype.clear()
            w.launches_by_dtype.update(by)


def count_launch(wrapper, dtype) -> None:
    """One launch of ``wrapper``'s kernel, instantiated for ``dtype``: adds
    one to ``wrapper.launches`` and to ``wrapper.launches_by_dtype["float32"
    or "bfloat16"]``."""
    wrapper.launches += 1
    wrapper.launches_by_dtype[str(dtype).replace("torch.", "")] += 1

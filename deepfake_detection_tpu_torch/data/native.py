"""ctypes bridges to the port's native host code: its JPEG decoder
(``native/jpeg_decode.cc``) and its image ops (``native/imaging.cc``).

The decoder is the port's own: no libjpeg, no Pillow.  It gives the bytes
libjpeg-turbo gives under the JAX package's native pool settings (ISLOW
IDCT, fancy upsampling, RGB out), so a frame decodes to the same array in
both packages.  It declines (returns None) 4-component, 12-bit,
arithmetic-coded, lossless and hierarchical streams, and a progressive
stream libjpeg would block-smooth (a truncated one); the ``reasons``
argument of the pool's methods says why.

The decoder and the image ops are one library,
with one worker pool (``native/pool.h``), built at first use with the host
C++ compiler (``$CXX``, else ``c++``, else ``g++``) into
``build/native/dfd_native-<digest>.so`` at the repository root: written to
a temporary path and renamed, so concurrent first uses never load a
half-written file.  It is built with ``-ffp-contract=off`` (the image ops'
Pillow arithmetic must not be fused into FMAs; the decoder is integer
arithmetic).  A library that cannot be built or loaded makes every decode
and every image op raise with the compiler's output; nothing falls back
to Pillow here (callers decide that, and count it).  ctypes releases the
GIL for each call, so the pool's threads work while Python runs.

API (the JAX package's ``data/native.py`` names): :func:`available`,
:func:`decode_jpeg_file`, :func:`decode_jpeg_bytes`, :class:`DecodePool`
(``decode_files`` / ``decode_buffers``), :func:`default_pool`,
:func:`set_default_pool_threads`, :func:`warp_affine_batch` (the JAX
bridge's warp: its signature, its index-space coefficients, bitwise its
output, on the same pool).  ``scale_denom`` is 1 only.  :func:`library`
is the loaded library; ``data/imaging.py`` holds the Pillow-exact ops
over it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["available", "unavailable_reason", "build_info",
           "decode_jpeg_file", "decode_jpeg_bytes", "DecodePool",
           "default_pool", "set_default_pool_threads", "is_jpeg",
           "library", "warp_affine_batch"]

_NATIVE = Path(__file__).resolve().parents[1] / "native"
_SRCS = (_NATIVE / "jpeg_decode.cc", _NATIVE / "imaging.cc")
_HEADERS = (_NATIVE / "pool.h",)
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# no -march=native: a library built here may be loaded on another host;
# no -ffast-math, and no FMA contraction, which would move a rounding of
# the image ops
_FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")
_ABI_VERSION = 1           # dfd_jpeg_abi_version() in jpeg_decode.cc
_IMG_ABI_VERSION = 2       # dfd_img_abi_version() in imaging.cc

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_info: dict = {}
_lock = threading.Lock()


def is_jpeg(data) -> bool:
    """Whether ``data`` starts with a JPEG's SOI and a marker (FF D8 FF)."""
    return bytes(data[:3]) == b"\xff\xd8\xff"


def _compiler() -> Optional[str]:
    cxx = os.environ.get("CXX")
    if cxx:
        return shutil.which(cxx) or cxx
    return shutil.which("c++") or shutil.which("g++")


def _target() -> Path:
    digest = hashlib.sha256()
    for src in (*_SRCS, *_HEADERS):
        digest.update(src.read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    return _BUILD_DIR / f"dfd_native-{digest.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    """Compile the sources into ``target`` (a temporary file, then
    renamed); raises with the compiler's output."""
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler ($CXX, c++, g++) to build "
                           f"{', '.join(s.name for s in _SRCS)}")
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *_FLAGS, *map(str, _SRCS), "-o", str(tmp), "-lpthread"]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building the native library failed: "
                           f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native library failed "
                           f"({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stderr}")
    os.replace(tmp, target)
    _info.update(compiler=cxx, build_s=time.perf_counter() - t0)


def _bind(lib: ctypes.CDLL) -> None:
    lib.dfd_jpeg_abi_version.restype = ctypes.c_int
    got = lib.dfd_jpeg_abi_version()
    if got != _ABI_VERSION:
        raise RuntimeError(f"JPEG decoder ABI {got} != {_ABI_VERSION}")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.dfd_jpeg_reason.restype = ctypes.c_char_p
    lib.dfd_jpeg_reason.argtypes = [ctypes.c_int]
    lib.dfd_jpeg_free.argtypes = [u8p]
    lib.dfd_jpeg_decode.restype = u8p
    lib.dfd_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ip, ip, ip]
    lib.dfd_jpeg_decode_file.restype = u8p
    lib.dfd_jpeg_decode_file.argtypes = [ctypes.c_char_p, ip, ip, ip]
    lib.dfd_jpeg_pool_new.restype = ctypes.c_void_p
    lib.dfd_jpeg_pool_new.argtypes = [ctypes.c_int]
    lib.dfd_jpeg_pool_free.argtypes = [ctypes.c_void_p]
    lib.dfd_jpeg_pool_decode_files.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(u8p), ip, ip, ip]
    lib.dfd_jpeg_pool_decode_buffers.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(u8p), ip, ip, ip]
    lib.dfd_img_abi_version.restype = ctypes.c_int
    got = lib.dfd_img_abi_version()
    if got != _IMG_ABI_VERSION:
        raise RuntimeError(f"image ops ABI {got} != {_IMG_ABI_VERSION}")
    dp = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.c_int64
    vp = ctypes.c_void_p
    lib.dfd_img_warp_affine.argtypes = [vp, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, vp, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int, dp]
    lib.dfd_img_pool_warp_affine.argtypes = [
        vp, ctypes.c_int, ctypes.POINTER(u8p), ip, ip, ip,
        ctypes.POINTER(u8p), ctypes.c_int, ctypes.c_int, ctypes.c_int, dp]
    for name in ("dfd_img_luma", "dfd_img_rgb_to_hsv", "dfd_img_hsv_to_rgb"):
        getattr(lib, name).argtypes = [vp, ctypes.c_int, vp, i64]
    for name in ("dfd_img_brightness", "dfd_img_contrast", "dfd_img_color"):
        getattr(lib, name).argtypes = [vp, ctypes.c_int, vp, i64,
                                       ctypes.c_float]
    lib.dfd_img_hue.argtypes = [vp, ctypes.c_int, vp, i64, ctypes.c_int]
    lib.dfd_img_grey_mean.restype = ctypes.c_int
    lib.dfd_img_grey_mean.argtypes = [vp, ctypes.c_int, i64]
    lib.dfd_img_gaussian_blur.argtypes = [vp, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, vp, ctypes.c_float]
    lib.dfd_img_affine_nearest.argtypes = [vp, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, vp, ctypes.c_int,
                                           ctypes.c_int, dp]


def library() -> ctypes.CDLL:
    """The native library (decoder and image ops), built at first use;
    raises when it cannot be built or loaded (and on every later call,
    with the same text)."""
    global _lib, _error
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        try:
            target = _target()
            if not target.is_file():
                _build(target)
            else:
                _info.update(compiler=None, build_s=0.0)
            lib = ctypes.CDLL(str(target))
            _bind(lib)
        except (OSError, RuntimeError, AttributeError) as e:
            _error = (f"the port's native library (JPEG decoder, image "
                      f"ops) is unavailable: {e}")
            raise RuntimeError(_error) from e
        _info["library"] = str(target)
        _lib = lib
        return _lib


def unavailable_reason() -> Optional[str]:
    """None once the native library builds and loads, else why not."""
    try:
        library()
    except RuntimeError as e:
        return str(e)
    return None


def available() -> bool:
    """True once the native library builds and loads."""
    return unavailable_reason() is None


def build_info() -> dict:
    """``{"library", "compiler", "build_s"}`` of the loaded library
    (``compiler`` None when an earlier run had built it); builds first."""
    library()
    return dict(_info)


def _check_scale(scale_denom: int) -> None:
    if scale_denom != 1:
        raise ValueError(f"scale_denom={scale_denom}: the port's decoder "
                         f"decodes at full size only (scale_denom=1)")


def _take(lib, ptr, w: int, h: int, why: int, reasons, i: int
          ) -> Optional[np.ndarray]:
    if reasons is not None:
        reasons[i] = None if ptr else lib.dfd_jpeg_reason(why).decode()
    if not ptr:
        return None
    try:
        return np.ctypeslib.as_array(ptr, shape=(h, w, 3)).copy()
    finally:
        lib.dfd_jpeg_free(ptr)


def _decode_one(fn, arg, *extra, reasons=None) -> Optional[np.ndarray]:
    lib = library()
    w, h, why = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    ptr = fn(lib)(arg, *extra, ctypes.byref(w), ctypes.byref(h),
                  ctypes.byref(why))
    if reasons is not None:
        reasons[:] = [None]
    return _take(lib, ptr, w.value, h.value, why.value, reasons, 0)


def decode_jpeg_file(path: str, scale_denom: int = 1, *,
                     reasons: Optional[list] = None
                     ) -> Optional[np.ndarray]:
    """Decode one JPEG file to an (H, W, 3) uint8 array, or None (then
    ``reasons``, when given, holds why)."""
    _check_scale(scale_denom)
    return _decode_one(lambda lib: lib.dfd_jpeg_decode_file,
                       os.fsencode(path), reasons=reasons)


def decode_jpeg_bytes(data: bytes, scale_denom: int = 1, *,
                      reasons: Optional[list] = None
                      ) -> Optional[np.ndarray]:
    """Decode a JPEG byte string to an (H, W, 3) uint8 array, or None
    (then ``reasons``, when given, holds why)."""
    _check_scale(scale_denom)
    data = bytes(data)
    return _decode_one(lambda lib: lib.dfd_jpeg_decode, data, len(data),
                       reasons=reasons)


class DecodePool:
    """Persistent C++ worker pool decoding a batch of JPEGs in one call.

    Each method blocks until the batch is done; a declined image comes
    back as None, and ``reasons`` (a list of the batch's length, when
    given) receives why (None for a decoded image)."""

    def __init__(self, num_threads: int = 4):
        self._lib = library()
        self.num_threads = max(1, int(num_threads))
        self._pool = self._lib.dfd_jpeg_pool_new(self.num_threads)

    def _run(self, n: int, call, reasons) -> List[Optional[np.ndarray]]:
        if not getattr(self, "_pool", None):
            raise ValueError("DecodePool is closed")
        if n == 0:
            return []
        lib = self._lib
        outs = (ctypes.POINTER(ctypes.c_uint8) * n)()
        ws, hs, whys = ((ctypes.c_int * n)() for _ in range(3))
        call(outs, ws, hs, whys)
        if reasons is not None and len(reasons) != n:
            reasons[:] = [None] * n
        return [_take(lib, outs[i], ws[i], hs[i], whys[i], reasons, i)
                for i in range(n)]

    def decode_files(self, paths: Sequence[str], scale_denom: int = 1,
                     reasons: Optional[list] = None
                     ) -> List[Optional[np.ndarray]]:
        _check_scale(scale_denom)
        n = len(paths)
        c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        return self._run(n, lambda o, w, h, y:
                         self._lib.dfd_jpeg_pool_decode_files(
                             self._pool, n, c_paths, o, w, h, y), reasons)

    def decode_buffers(self, datas: Sequence[bytes], scale_denom: int = 1,
                       reasons: Optional[list] = None
                       ) -> List[Optional[np.ndarray]]:
        _check_scale(scale_denom)
        datas = [bytes(d) for d in datas]
        n = len(datas)
        c_datas = (ctypes.c_char_p * n)(*datas)
        sizes = (ctypes.c_size_t * n)(*[len(d) for d in datas])
        return self._run(n, lambda o, w, h, y:
                         self._lib.dfd_jpeg_pool_decode_buffers(
                             self._pool, n, c_datas, sizes, o, w, h, y),
                         reasons)

    def close(self) -> None:
        if getattr(self, "_pool", None):
            self._lib.dfd_jpeg_pool_free(self._pool)
            self._pool = None

    def __del__(self):  # best effort; close() is the API
        try:
            self.close()
        except Exception:
            pass


_default_pool: Optional[DecodePool] = None
_default_pool_threads: Optional[int] = None
_pool_lock = threading.Lock()


def set_default_pool_threads(num_threads: int) -> None:
    """Pin the thread count of the lazily made default pool (loader worker
    processes call this before their first decode); a no-op once the pool
    exists, and ``DFD_NATIVE_POOL_THREADS`` overrides it."""
    global _default_pool_threads
    _default_pool_threads = max(1, int(num_threads))


def default_pool(num_threads: int = 4) -> DecodePool:
    """The process-wide pool, made at first use; raises when the decoder
    cannot be built."""
    global _default_pool
    if _default_pool is None:
        with _pool_lock:
            if _default_pool is None:
                n = int(os.environ.get("DFD_NATIVE_POOL_THREADS", 0)) \
                    or _default_pool_threads or num_threads
                _default_pool = DecodePool(n)
    return _default_pool


def _drop_pool_after_fork() -> None:  # pragma: no cover - fork-start only
    """A forked child cannot use the parent's pool threads: drop the handle
    (leaking it; freeing would join threads the child does not have) so the
    child makes its own."""
    global _default_pool
    _default_pool = None


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_drop_pool_after_fork)


def _stage_warp_src(a: np.ndarray):
    """``(array, pixel stride)``: a uint8 (H, W, 3) frame whose rows are
    dense (a channel slice of a C-contiguous (H, W, 3F) clip is one) is
    read in place; anything else is copied to a tight buffer first."""
    if a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] == 3 and \
            a.strides[2] == 1 and a.strides[1] >= 3 and \
            a.strides[0] == a.shape[1] * a.strides[1]:
        return a, int(a.strides[1])
    return np.ascontiguousarray(a, dtype=np.uint8), 3


def warp_affine_batch(frames: Sequence[np.ndarray], coeffs: Sequence[float],
                      out_size, pool: Optional[DecodePool] = None,
                      packed: bool = False):
    """Bilinear-warp a clip's frames with one shared affine draw, bitwise
    the JAX bridge's ``warp_affine_batch``.

    ``coeffs`` = (A, B, C, D, E, F) maps output pixel index (x, y) to
    source pixel index (A·x+B·y+C, D·x+E·y+F) (index space: Pillow's
    ``Image.transform`` maps continuous coordinates, ``(A+B)/2 − ½`` off in
    the constant terms); ``out_size`` = (width, height).  Returns (H, W, 3)
    uint8 arrays, or with ``packed=True`` one (H, W, 3·n) array that each
    frame wrote its channel slice of.  The frames warp in parallel on
    ``pool`` (default :func:`default_pool`), outside the interpreter
    lock."""
    lib = library()
    tw, th = int(out_size[0]), int(out_size[1])
    n = len(frames)
    if n == 0:
        return np.empty((th, tw, 0), np.uint8) if packed else []
    staged = [_stage_warp_src(np.asarray(f)) for f in frames]
    srcs_np = [a for a, _ in staged]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if packed:
        out = np.empty((th, tw, 3 * n), np.uint8)
        base = out.ctypes.data
        stride = 3 * n
        dsts = (u8p * n)(*[ctypes.cast(base + 3 * i, u8p)
                           for i in range(n)])
    else:
        outs = [np.empty((th, tw, 3), np.uint8) for _ in range(n)]
        stride = 3
        dsts = (u8p * n)(*[o.ctypes.data_as(u8p) for o in outs])
    srcs = (u8p * n)(*[f.ctypes.data_as(u8p) for f in srcs_np])
    sws = (ctypes.c_int * n)(*[f.shape[1] for f in srcs_np])
    shs = (ctypes.c_int * n)(*[f.shape[0] for f in srcs_np])
    sss = (ctypes.c_int * n)(*[ss for _, ss in staged])
    c = (ctypes.c_double * 6)(*[float(v) for v in coeffs])
    p = pool or default_pool()
    lib.dfd_img_pool_warp_affine(p._pool, n, srcs, sws, shs, sss, dsts,
                                 tw, th, stride, c)
    return out if packed else outs

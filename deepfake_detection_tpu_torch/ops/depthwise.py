"""Fused depthwise conv → per-channel affine → activation, forward.

Replaces the Pallas TPU kernel
``deepfake_detection_tpu/ops/depthwise_pallas.py::_fwd_kernel`` (launched by
``_dw_call``, public ``fused_depthwise``) with a CUDA C++ kernel written for
Hopper, ``csrc/depthwise_fwd.cu``.

What bounds it on an H100: memory bytes.  The stage reads x once and writes
y once; at the flagship's 55 stages that is 1.21 GB per 600² image in f32
against 4.0 GFLOP, ~3 FLOP per byte, far under the card's f32 ridge.  The
kernel's design follows from that (see the source's header): coalesced
16-byte accesses along C, a register strip of output pixels along W that
reuses each loaded input column across taps, and the halo handled by bounds
checks instead of the padded copy of x the TPU version makes in XLA.

* :func:`fused_depthwise_reference` is the plain PyTorch version: ``F.pad``
  where the padding is asymmetric, ``F.conv2d(groups=C)`` in f32, affine,
  act, cast.  The CPU tests run it; ``chip_smoke.py`` holds the kernel
  against it on the card.
* :func:`fused_depthwise` sends a CPU tensor to the plain version and a CUDA
  tensor to the kernel, or raises; there is no fallback.  Its ``launches``
  attribute counts kernel launches.

The kernel is compiled at first use by ``nvcc`` into ``build/kernels/`` at
the repository root and loaded with ``ctypes``; nothing is built or
imported at module import.  Only the forward exists: a gradient through a
CUDA stage raises (the backward and the dw-gradient kernel are ROADMAP
Queue 2 items 1-2).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from .conv import explicit_padding

__all__ = ["FUSED_DW_ACTS", "fused_depthwise", "fused_depthwise_reference",
           "build", "output_size"]

#: epilogue activations the kernel fuses, in the order of its act codes
FUSED_DW_ACTS = ("none", "silu", "relu")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_SIZES = (3, 5)

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "depthwise_fwd.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the depthwise kernel is built "
                       "from csrc/ at first use")


def build() -> Path:
    """Compile ``csrc/depthwise_fwd.cu`` (once per source and flag set) and
    return the shared library's path; raises with nvcc's stderr on failure.
    ``-Xptxas -v``'s register report lands in the ``.log`` beside it."""
    src = _SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"depthwise_fwd-{key}.so"
    if out.is_file():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stderr)
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.dfd_depthwise_fwd
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 6
                           + [ctypes.c_int] * 6 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _kernel_3d(w: torch.Tensor) -> torch.Tensor:
    """``(kh, kw, C)`` view of a ``(kh, kw, C)`` or HWIO ``(kh, kw, 1, C)``
    depthwise kernel."""
    if w.dim() == 4:
        if w.shape[2] != 1:
            raise ValueError(f"not a depthwise kernel: {tuple(w.shape)}")
        return w.view(w.shape[0], w.shape[1], w.shape[3])
    if w.dim() != 3:
        raise ValueError(f"depthwise kernel must be (kh, kw, C), got "
                         f"{tuple(w.shape)}")
    return w


def _stride(stride) -> int:
    sh, sw = (stride, stride) if isinstance(stride, int) else tuple(stride)
    if sh != sw:
        raise ValueError(f"anisotropic depthwise stride unsupported "
                         f"({sh},{sw})")
    return int(sh)


def output_size(h: int, w: int, k: int, stride: int,
                pads: Tuple[int, int, int, int]) -> Tuple[int, int]:
    t, b, l, r = pads
    return (h + t + b - k) // stride + 1, (w + l + r - k) // stride + 1


def _act(u: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(u)
    if act == "relu":
        return torch.relu(u)
    return u


def fused_depthwise_reference(x: torch.Tensor, w: torch.Tensor,
                              scale: Optional[torch.Tensor] = None,
                              bias: Optional[torch.Tensor] = None,
                              stride: Union[int, Tuple[int, int]] = 1,
                              padding: Union[str, int, None, Sequence] = "",
                              act: str = "silu") -> torch.Tensor:
    """The plain PyTorch version of :func:`fused_depthwise` (same arguments,
    same result up to summation order)."""
    if act not in FUSED_DW_ACTS:
        raise ValueError(f"act must be one of {FUSED_DW_ACTS}, got {act!r}")
    w = _kernel_3d(w)
    s = _stride(stride)
    k_h, k_w, c = w.shape
    t, b, l, r = explicit_padding(padding, (k_h, k_w), 1, s, x.shape[1],
                                  x.shape[2])
    xc = x.permute(0, 3, 1, 2).float()
    if t == b and l == r:
        pad = (t, l)
    else:
        xc, pad = F.pad(xc, (l, r, t, b)), (0, 0)
    z = F.conv2d(xc, w.float().permute(2, 0, 1).unsqueeze(1), None, s, pad,
                 1, c)
    if scale is not None:
        z = z * scale.float().view(1, -1, 1, 1)
    if bias is not None:
        z = z + bias.float().view(1, -1, 1, 1)
    return _act(z, act).to(x.dtype).permute(0, 2, 3, 1)


def _check_param(name: str, v: Optional[torch.Tensor], c: int,
                 device: torch.device) -> None:
    if v is None:
        return
    if (v.dtype != torch.float32 or v.shape != (c,) or v.device != device
            or not v.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous float32 ({c},) tensor "
                         f"on {device}, got {v.dtype} {tuple(v.shape)} on "
                         f"{v.device}")


def _launch(x, w, scale, bias, s: int, pads, act: str) -> torch.Tensor:
    """Validate, allocate y, launch ``dfd_depthwise_fwd`` on the current
    stream.  Nothing is copied or made contiguous here: a layout the kernel
    does not take is an error."""
    if x.dim() != 4:
        raise ValueError(f"expected NHWC (B, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"x must be NHWC-contiguous, got strides {x.stride()}"
                         " (an NCHW tensor in channels_last memory becomes one"
                         " with .permute(0, 2, 3, 1))")
    bsz, h, wd, c = x.shape
    k_h, k_w, kc = w.shape
    if k_h != k_w or k_h not in _KERNEL_SIZES or kc != c:
        raise ValueError(f"kernel {tuple(w.shape)}: the CUDA kernel takes a "
                         f"square k in {_KERNEL_SIZES} with C={c}")
    if w.dtype != torch.float32 or w.device != x.device or \
            not w.is_contiguous():
        raise ValueError(f"w must be contiguous float32 on {x.device}, got "
                         f"{w.dtype} on {w.device}")
    _check_param("scale", scale, c, x.device)
    _check_param("bias", bias, c, x.device)
    if s not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {s}")
    if min(pads) < 0:
        raise ValueError(f"negative padding {pads}")
    ho, wo = output_size(h, wd, k_h, s, pads)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"empty output for input {tuple(x.shape)}, k={k_h}, "
                         f"stride={s}, padding={pads}")
    y = torch.empty((bsz, ho, wo, c), dtype=x.dtype, device=x.device)
    fn = _library().dfd_depthwise_fwd
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(),
                 None if scale is None else scale.data_ptr(),
                 None if bias is None else bias.data_ptr(), y.data_ptr(),
                 bsz, h, wd, c, ho, wo, k_h, s, pads[0], pads[2],
                 FUSED_DW_ACTS.index(act), _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"dfd_depthwise_fwd launch failed: cudaError_t "
                           f"{err} for x {tuple(x.shape)} {x.dtype}, "
                           f"k={k_h}, stride={s}")
    fused_depthwise.launches += 1
    return y


class _CudaDepthwise(torch.autograd.Function):
    """The kernel as an autograd node whose backward is not written yet."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, s, pads, act):
        return _launch(x, w, scale, bias, s, pads, act)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "fused_depthwise has no CUDA backward yet: the depthwise "
            "backward and the dw-gradient kernel are ROADMAP Queue 2 "
            "items 1-2")


def fused_depthwise(x: torch.Tensor, w: torch.Tensor,
                    scale: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None,
                    stride: Union[int, Tuple[int, int]] = 1,
                    padding: Union[str, int, None, Sequence] = "",
                    act: str = "silu") -> torch.Tensor:
    """``act(depthwise_conv(x, w) · scale + bias)`` in one pass.

    ``x`` is NHWC ``(B, H, W, C)`` (f32 or bf16); ``w`` is ``(kh, kw, C)``
    or HWIO ``(kh, kw, 1, C)`` f32; ``scale``/``bias`` are ``(C,)`` f32 or
    None (identity).  ``padding`` takes :func:`ops.conv.resolve_padding`'s
    values (``''`` static symmetric, ``'same'`` TF SAME, int, or explicit
    ``[(top, bottom), (left, right)]``).  Accumulation and epilogue in f32;
    the result is NHWC in ``x``'s dtype.  CPU tensors take the plain
    version, CUDA tensors the kernel.
    """
    if act not in FUSED_DW_ACTS:
        raise ValueError(f"act must be one of {FUSED_DW_ACTS}, got {act!r}")
    if x.device.type == "cpu":
        return fused_depthwise_reference(x, w, scale, bias, stride, padding,
                                         act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_depthwise runs on cpu or cuda, got "
                         f"{x.device}")
    w = _kernel_3d(w)
    s = _stride(stride)
    pads = explicit_padding(padding, tuple(w.shape[:2]), 1, s, x.shape[1],
                            x.shape[2])
    return _CudaDepthwise.apply(x, w, scale, bias, s, pads, act)


fused_depthwise.launches = 0

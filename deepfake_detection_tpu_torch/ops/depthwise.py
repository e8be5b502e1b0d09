"""Fused depthwise conv → per-channel affine → activation, and its backward.

Replaces the Pallas TPU kernels of
``deepfake_detection_tpu/ops/depthwise_pallas.py`` with CUDA C++ kernels
written for Hopper:

* ``_fwd_kernel`` (launched by ``_dw_call``, public ``fused_depthwise``) →
  ``csrc/depthwise_fwd.cu``, which also writes the f32 pre-affine output z
  when the backward of a non-identity epilogue needs it;
* the TPU backward's reuse of that kernel for dx (over the upstream
  gradient dilated by ``stride - 1``, kernel flipped, then cropped) →
  ``csrc/depthwise_dx.cu``, a direct transposed kernel: each dx pixel takes
  only the taps of its stride phase, nothing is dilated or cropped;
* ``_dwgrad_kernel`` (launched by ``_dwgrad_call``) →
  ``csrc/depthwise_dwgrad.cu``, the weight gradient, reduced in two passes
  without atomics so that two calls give bitwise-equal dw.

What bounds them on an H100: memory bytes.  The forward reads x once and
writes y once; at the flagship's 55 stages that is 1.21 GB per 600² image
in f32 against 4.0 GFLOP, ~3 FLOP per byte, far under the card's f32 ridge.
dx reads dz once and writes dx once; the dw gradient reads x and dz once,
2.25-6.25 FLOP per byte.  All three put threads along C for coalesced
16-byte accesses and stage tiles with their halo in shared memory (zeros
outside the image; the forward and dx by TMA, two tiles in flight a block)
instead of the padded copy of x the TPU version makes in XLA.

* :func:`fused_depthwise_reference`, :func:`depthwise_dx_reference` and
  :func:`depthwise_dwgrad_reference` are the plain PyTorch versions.  The
  CPU tests run them; ``chip_smoke.py`` holds the kernels against them on
  the card.
* :func:`fused_depthwise`, :func:`depthwise_dx` and :func:`depthwise_dwgrad`
  send a CPU tensor to the plain version and a CUDA tensor to the kernel,
  or raise; there is no fallback.  Their ``launches`` attributes count
  kernel launches.
* :func:`depthwise_backward` is the backward's glue (the counterpart of
  ``fused_depthwise::_op_bwd``): the epilogue cotangents, with the two
  device ops passed in.  The CUDA autograd node passes the kernels; the CPU
  tests pass the plain versions.

The kernels are compiled at first use by ``csrc/build.py`` (``nvcc``, one
process per source, in parallel) into ``build/kernels/`` at the repository
root and loaded with ``ctypes``; nothing is built or imported at module
import.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..csrc.build import kernel
from .conv import explicit_padding

__all__ = ["FUSED_DW_ACTS", "fused_depthwise", "fused_depthwise_reference",
           "depthwise_dx", "depthwise_dx_reference", "depthwise_dwgrad",
           "depthwise_dwgrad_reference", "depthwise_backward", "output_size"]

#: epilogue activations the kernel fuses, in the order of its act codes
FUSED_DW_ACTS = ("none", "silu", "relu")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_SIZES = (3, 5)

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "dfd_depthwise_fwd": ([_P] * 6 + [_I64] * 6 + [_I] * 6 + [_P], _I),
    "dfd_depthwise_dx": ([_P] * 3 + [_I64] * 6 + [_I] * 5 + [_P], _I),
    "dfd_depthwise_dwgrad": ([_P] * 4 + [_I64] * 6 + [_I] * 5 + [_P], _I),
    "dfd_depthwise_dwgrad_workspace": ([_I64] * 4 + [_I], _I64),
}


def _fn(name: str, symbol: str):
    """``symbol`` of the library built from ``csrc/<name>.cu``."""
    return kernel(name, symbol, *_SIGNATURES[symbol])


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


def _launch(x, w, scale, bias, s: int, pads, act: str,
            want_z: bool = False):
    """Validate, allocate y (and z when ``want_z``), launch
    ``dfd_depthwise_fwd`` on the current stream; returns ``(y, z or
    None)``.  Nothing is copied or made contiguous here: a layout the
    kernel does not take is an error."""
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
    z = torch.empty((bsz, ho, wo, c), dtype=torch.float32,
                    device=x.device) if want_z else None
    fn = _fn("depthwise_fwd", "dfd_depthwise_fwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(),
                 None if scale is None else scale.data_ptr(),
                 None if bias is None else bias.data_ptr(), y.data_ptr(),
                 None if z is None else z.data_ptr(),
                 bsz, h, wd, c, ho, wo, k_h, s, pads[0], pads[2],
                 FUSED_DW_ACTS.index(act), _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"dfd_depthwise_fwd launch failed: cudaError_t "
                           f"{err} for x {tuple(x.shape)} {x.dtype}, "
                           f"k={k_h}, stride={s}")
    fused_depthwise.launches += 1
    return y, z


# ---------------------------------------------------------------------------
# dw gradient
# ---------------------------------------------------------------------------

def depthwise_dwgrad_reference(x: torch.Tensor, dz: torch.Tensor, k: int,
                               stride: int, pads) -> torch.Tensor:
    """The plain PyTorch version of :func:`depthwise_dwgrad`: an explicit
    k²-tap loop of shifted (strided) slices of the zero-padded x times dz,
    each summed over ``(B, Ho, Wo)``.  Returns ``(k, k, C)`` float32."""
    t, l = pads[0], pads[2]
    _, h, wd, c = x.shape
    _, ho, wo, _ = dz.shape
    span_h, span_w = (ho - 1) * stride + 1, (wo - 1) * stride + 1
    xp = F.pad(x.float(), (0, 0, l, max(0, span_w + k - 1 - l - wd),
                           t, max(0, span_h + k - 1 - t - h)))
    dz = dz.float()
    rows = []
    for r in range(k):
        taps = []
        for q in range(k):
            tap = xp[:, r:r + span_h:stride, q:q + span_w:stride]
            taps.append((tap * dz).sum(dim=(0, 1, 2)))
        rows.append(torch.stack(taps))
    return torch.stack(rows)


def depthwise_dwgrad(x: torch.Tensor, dz: torch.Tensor, k: int, stride: int,
                     pads) -> torch.Tensor:
    """``dw[r, q, c] = Σ_{b,h,w} dz[b,h,w,c] · x[b, h·s+r-top, w·s+q-left,
    c]`` (x zero outside its bounds), float32 ``(k, k, C)``.

    ``x`` is NHWC f32 or bf16, ``dz`` NHWC f32 ``(B, Ho, Wo, C)``, ``pads``
    ``(top, bottom, left, right)`` (only top and left are read).  CPU
    tensors take the plain version, CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return depthwise_dwgrad_reference(x, dz, k, stride, pads)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_dwgrad runs on cpu or cuda, got "
                         f"{x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPE_CODE or not x.is_contiguous():
        raise ValueError(f"x must be NHWC-contiguous float32 or bfloat16, got "
                         f"{x.dtype} {tuple(x.shape)} strides {x.stride()}")
    bsz, h, wd, c = x.shape
    if (dz.dim() != 4 or dz.dtype != torch.float32 or dz.device != x.device
            or not dz.is_contiguous() or dz.shape[0] != bsz
            or dz.shape[3] != c):
        raise ValueError(f"dz must be contiguous float32 ({bsz}, Ho, Wo, {c}) "
                         f"on {x.device}, got {dz.dtype} {tuple(dz.shape)} on "
                         f"{dz.device}")
    if k not in _KERNEL_SIZES or stride not in (1, 2) or \
            min(pads[0], pads[2]) < 0:
        raise ValueError(f"k={k} stride={stride} pads={pads}: the kernel "
                         f"takes k in {_KERNEL_SIZES}, stride 1 or 2 and "
                         f"non-negative padding")
    ho, wo = dz.shape[1], dz.shape[2]
    n_ws = _fn("depthwise_dwgrad", "dfd_depthwise_dwgrad_workspace")(
        bsz, ho, wo, c, k)
    ws = torch.empty(n_ws, dtype=torch.float32, device=x.device)
    dw = torch.empty((k, k, c), dtype=torch.float32, device=x.device)
    fn = _fn("depthwise_dwgrad", "dfd_depthwise_dwgrad")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dz.data_ptr(), ws.data_ptr(), dw.data_ptr(),
                 bsz, h, wd, c, ho, wo, k, stride, pads[0], pads[2],
                 _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"dfd_depthwise_dwgrad launch failed: cudaError_t "
                           f"{err} for x {tuple(x.shape)} {x.dtype}, "
                           f"dz {tuple(dz.shape)}, k={k}, stride={stride}")
    depthwise_dwgrad.launches += 1
    return dw


depthwise_dwgrad.launches = 0


# ---------------------------------------------------------------------------
# dx and the backward glue
# ---------------------------------------------------------------------------

def _act_grad(u: torch.Tensor, act: str) -> torch.Tensor:
    """d act(u) / du in f32."""
    if act == "silu":
        sig = torch.sigmoid(u)
        return sig * (1.0 + u * (1.0 - sig))
    if act == "relu":
        return (u > 0.0).float()
    return torch.ones_like(u)


def _dx_pads(h: int, w: int, k: int, stride: int, pads, ho: int,
             wo: int) -> Tuple[int, int, int, int]:
    """Signed padding of the stride-1 correlation that gives dx from dz
    dilated by ``stride - 1``: ``k-1-top`` before, and after whatever makes
    the output exactly ``h × w``.  A negative side means the forward padded
    beyond ``k-1`` there: that many leading (or trailing) rows of the
    correlation's output lie in the padding and are cropped."""
    t, _, l, _ = pads
    return (k - 1 - t,
            h + t - 1 - (ho - 1) * stride,
            k - 1 - l,
            w + l - 1 - (wo - 1) * stride)


def _dilate(dz: torch.Tensor, stride: int) -> torch.Tensor:
    """NHWC ``dz`` with ``stride - 1`` zero rows and columns between its
    own (``dz`` itself at stride 1), as ``lax.pad`` in the JAX package."""
    if stride == 1:
        return dz
    bsz, ho, wo, c = dz.shape
    out = dz.new_zeros((bsz, (ho - 1) * stride + 1, (wo - 1) * stride + 1, c))
    out[:, ::stride, ::stride] = dz
    return out


def depthwise_dx_reference(dz: torch.Tensor, w: torch.Tensor, x_shape,
                           stride: int, pads,
                           dtype: torch.dtype) -> torch.Tensor:
    """The plain PyTorch version of :func:`depthwise_dx`, the composition
    the JAX backward runs: dz dilated by ``stride - 1``, the stride-1
    correlation with the flipped kernel, padded by at most ``k-1`` a side
    (:func:`_dx_pads`), then the rows and columns that lie in a forward
    padding beyond ``k-1`` cropped (the JAX ``_op_bwd`` pads by ``k-1`` and
    crops the same way)."""
    k = w.shape[0]
    h, wd = x_shape[1], x_shape[2]
    signed = _dx_pads(h, wd, k, stride, pads, dz.shape[1], dz.shape[2])
    t, b, l, r = (max(p, 0) for p in signed)
    dx = fused_depthwise_reference(
        _dilate(dz.float(), stride), torch.flip(w.float(), dims=(0, 1)), None,
        None, 1, [(t, b), (l, r)], "none")
    top, left = max(-signed[0], 0), max(-signed[2], 0)
    dx = dx[:, top:top + h, left:left + wd]
    if tuple(dx.shape) != tuple(x_shape):
        raise AssertionError(f"dx {tuple(dx.shape)} for x {tuple(x_shape)}")
    return dx.to(dtype)


def depthwise_dx(dz: torch.Tensor, w: torch.Tensor, x_shape, stride: int,
                 pads, dtype: torch.dtype) -> torch.Tensor:
    """``dx[b,h,w,c] = Σ w[r,s,c] · dz[b, (h+top-r)/s, (w+left-s)/s, c]``
    over the taps where both quotients are whole and inside dz: the input
    gradient of the depthwise conv, in ``dtype`` (x's: f32 or bf16, one
    rounding from f32) at exactly ``x_shape`` ``(B, H, W, C)``.

    ``dz`` is NHWC f32 ``(B, Ho, Wo, C)``, ``w`` ``(k, k, C)`` f32,
    ``pads`` the forward's ``(top, bottom, left, right)``, any non-negative
    size.  CPU tensors take the plain version, CUDA tensors the kernel."""
    if dz.device.type == "cpu":
        return depthwise_dx_reference(dz, w, x_shape, stride, pads, dtype)
    if dz.device.type != "cuda":
        raise ValueError(f"depthwise_dx runs on cpu or cuda, got "
                         f"{dz.device}")
    bsz, h, wd, c = x_shape
    k = w.shape[0]
    if (dz.dim() != 4 or dz.dtype != torch.float32
            or not dz.is_contiguous() or dz.shape[0] != bsz
            or dz.shape[3] != c):
        raise ValueError(f"dz must be contiguous float32 ({bsz}, Ho, Wo, {c})"
                         f", got {dz.dtype} {tuple(dz.shape)} strides "
                         f"{dz.stride()}")
    if (w.shape != (k, k, c) or w.dtype != torch.float32
            or w.device != dz.device or not w.is_contiguous()):
        raise ValueError(f"w must be contiguous float32 (k, k, {c}) on "
                         f"{dz.device}, got {w.dtype} {tuple(w.shape)} on "
                         f"{w.device}")
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"dx must be float32 or bfloat16, got {dtype}")
    if k not in _KERNEL_SIZES or stride not in (1, 2) or min(pads) < 0:
        raise ValueError(f"k={k} stride={stride} pads={pads}: the kernel "
                         f"takes k in {_KERNEL_SIZES}, stride 1 or 2 and "
                         f"non-negative padding")
    ho, wo = dz.shape[1], dz.shape[2]
    if output_size(h, wd, k, stride, pads) != (ho, wo):
        raise ValueError(f"dz {tuple(dz.shape)} is not the output of x "
                         f"{tuple(x_shape)} at k={k}, stride={stride}, "
                         f"padding {tuple(pads)}")
    dx = torch.empty(x_shape, dtype=dtype, device=dz.device)
    fn = _fn("depthwise_dx", "dfd_depthwise_dx")
    with torch.cuda.device(dz.device):
        stream = torch.cuda.current_stream(dz.device).cuda_stream
        err = fn(dz.data_ptr(), w.data_ptr(), dx.data_ptr(), bsz, h, wd, c,
                 ho, wo, k, stride, pads[0], pads[2], _DTYPE_CODE[dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"dfd_depthwise_dx launch failed: cudaError_t "
                           f"{err} for dz {tuple(dz.shape)}, x "
                           f"{tuple(x_shape)} {dtype}, k={k}, "
                           f"stride={stride}")
    depthwise_dx.launches += 1
    return dx


depthwise_dx.launches = 0


def depthwise_backward(grad: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                       scale: Optional[torch.Tensor],
                       bias: Optional[torch.Tensor],
                       z: Optional[torch.Tensor], stride: int, pads,
                       act: str, dx_fn: Callable, dwgrad: Callable):
    """``(dx, dw, dscale, dbias)`` of :func:`fused_depthwise` at the
    cotangent ``grad`` of y (NHWC); the counterpart of
    ``depthwise_pallas.py::fused_depthwise::_op_bwd``.

    ``z`` is the f32 pre-affine conv output, or None for the identity
    epilogue (no scale, no bias, act ``none``), where dz = grad and nothing
    was saved.  ``dx_fn(dz, w, x_shape, stride, pads, dtype)`` computes the
    input gradient (:func:`depthwise_dx`), ``dwgrad(x, dz, k, stride,
    pads)`` the weight gradient (:func:`depthwise_dwgrad`).  dscale/dbias
    are None where scale/bias are."""
    g = grad.float()
    dscale = dbias = None
    if z is None:
        dz = g
    else:
        u = z
        if scale is not None:
            u = u * scale
        if bias is not None:
            u = u + bias
        du = g * _act_grad(u, act) if act != "none" else g
        if bias is not None:
            dbias = du.sum(dim=(0, 1, 2))
        if scale is not None:
            dscale = (du * z).sum(dim=(0, 1, 2))
            du = du * scale
        dz = du
    dz = dz.contiguous()
    dx = dx_fn(dz, w, tuple(x.shape), stride, pads, x.dtype)
    dw = dwgrad(x, dz, w.shape[0], stride, pads)
    return dx, dw.to(w.dtype), dscale, dbias


class _CudaDepthwise(torch.autograd.Function):
    """The forward kernel as an autograd node; its backward runs the dx and
    dw-gradient kernels."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, s, pads, act):
        needs_z = scale is not None or bias is not None or act != "none"
        y, z = _launch(x, w, scale, bias, s, pads, act, want_z=needs_z)
        ctx.save_for_backward(x, w, scale, bias, z)
        ctx.cfg = (s, pads, act)
        return y

    @staticmethod
    def backward(ctx, grad):
        x, w, scale, bias, z = ctx.saved_tensors
        s, pads, act = ctx.cfg
        dx, dw, dscale, dbias = depthwise_backward(
            grad, x, w, scale, bias, z, s, pads, act, depthwise_dx,
            depthwise_dwgrad)
        return dx, dw, dscale, dbias, None, None, None


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
    version (autograd differentiates it), CUDA tensors the kernel, through
    an autograd node only where a gradient is wanted: that node saves z
    only for a non-identity epilogue.  Any non-negative padding.
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
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, scale, bias)):
        return _CudaDepthwise.apply(x, w, scale, bias, s, pads, act)
    return _launch(x, w, scale, bias, s, pads, act)[0]


fused_depthwise.launches = 0

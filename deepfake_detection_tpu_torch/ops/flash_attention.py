"""Flash attention: the forward and its two backward kernels.

Counterpart of ``deepfake_detection_tpu/ops/flash_attention.py``, whose three
Pallas TPU kernels become CUDA C++ kernels written for Hopper:

* ``_fwd_kernel`` (launched by ``_fwd``) → ``csrc/flash_fwd.cu``,
  :func:`flash_fwd`: O and the per-row f32 log-sum-exp;
* ``_bwd_dq_kernel`` (``_bwd_dq``) → ``csrc/flash_bwd_dq.cu``,
  :func:`flash_bwd_dq`;
* ``_bwd_dkv_kernel`` (``_bwd_dkv``) → ``csrc/flash_bwd_dkv.cu``,
  :func:`flash_bwd_dkv`.

The device functions work on ``(B·H, L, D)`` with ``D <= 128`` and take the
TPU kernels' ``scale, seq_len, causal, q_off, kv_off``: keys at or past
``seq_len`` are padding, and the causal mask compares global positions
(``q_off + row`` against ``kv_off + key``), so the ring of sequence
parallelism can reuse them unchanged.  Nothing is padded: the kernels mask
the ragged edge of L and of D themselves, and the lse stays ``(B·H, L)``
f32 (the TPU's 128-lane copy is a layout artifact).  What bounds the
kernels on an H100 (operations, in f32) and how their design answers it is
in each source's note.

Beside each device function is its plain PyTorch version (a masked dense
softmax in f32 with the same guards); the CPU tests run them and
``chip_smoke.py`` holds the kernels against them.  A CPU tensor takes the
plain version, a CUDA tensor the kernel, anything else raises; there is no
fallback.  Each device function counts its kernel launches in its
``launches`` attribute, and by the instantiation's dtype in
``launches_by_dtype``.

:func:`flash_attention` is the public op, ``(B, L, H, D) → (B, L, H, D)``,
self-attention shapes only, differentiable through
:class:`FlashAttentionFunction`, whose backward runs dK/dV and then dQ, as
the JAX ``_bwd`` does; ``delta = rowsum(dO ∘ O)`` is plain torch (XLA
outside any kernel in the JAX package).
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional, Tuple

import torch

from ..csrc.build import count_launch, kernel

__all__ = ["flash_attention", "FlashAttentionFunction", "flash_fwd",
           "flash_bwd_dq", "flash_bwd_dkv", "flash_fwd_reference",
           "flash_bwd_dq_reference", "flash_bwd_dkv_reference",
           "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "dfd_flash_fwd": [_P] * 5 + [_I] * 8 + [_F, _I, _P],
    "dfd_flash_bwd_dq": [_P] * 7 + [_I] * 8 + [_F, _I, _P],
    "dfd_flash_bwd_dkv": [_P] * 8 + [_I] * 8 + [_F, _I, _P],
}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _hidden(lq: int, lk: int, seq_len: int, causal: bool, q_off: int,
            kv_off: int, device) -> torch.Tensor:
    """(Lq, Lk) bool: key padding past ``seq_len`` and, causal, keys after
    the query in the global sequence."""
    kpos = torch.arange(lk, device=device)
    hide = (kpos >= seq_len).expand(lq, lk)
    if causal:
        qpos = torch.arange(lq, device=device)
        hide = hide | (kv_off + kpos[None, :] > q_off + qpos[:, None])
    return hide


def _scores(q, k, scale, seq_len, causal, q_off, kv_off):
    """``(q·scale)·kᵀ`` in f32 and the mask, as the kernels compute them."""
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    return s, _hidden(q.shape[1], k.shape[1], seq_len, causal, q_off, kv_off,
                      q.device)


def flash_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, seq_len: int, causal: bool = False,
                        q_off: int = 0, kv_off: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`flash_fwd`: a masked dense softmax in f32
    with the kernel's guards; a row that sees no key gives o = 0 and
    lse = log(1e-30)."""
    s, hide = _scores(q, k, scale, seq_len, causal, q_off, kv_off)
    s = s.masked_fill(hide, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, v.float()) / l
    return o.to(q.dtype), (m_safe + torch.log(l)).squeeze(-1)


def _probs_and_dscores(q, k, v, do, lse, delta, scale, seq_len, causal,
                       q_off, kv_off):
    s, hide = _scores(q, k, scale, seq_len, causal, q_off, kv_off)
    p = torch.where(hide, torch.zeros_like(s), torch.exp(s - lse[..., None]))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None]) * scale


def flash_bwd_dq_reference(q, k, v, do, lse, delta, scale: float,
                           seq_len: int, causal: bool = False, q_off: int = 0,
                           kv_off: int = 0) -> torch.Tensor:
    """The plain version of :func:`flash_bwd_dq`: ``dS·K`` in f32."""
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, scale, seq_len,
                               causal, q_off, kv_off)
    return torch.matmul(ds, k.float())


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, scale: float,
                            seq_len: int, causal: bool = False,
                            q_off: int = 0, kv_off: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`flash_bwd_dkv`: ``(dSᵀ·Q, Pᵀ·dO)`` in
    f32."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, scale, seq_len,
                               causal, q_off, kv_off)
    return (torch.matmul(ds.transpose(-1, -2), q.float()),
            torch.matmul(p.transpose(-1, -2), do.float()))


# ---------------------------------------------------------------------------
# device functions
# ---------------------------------------------------------------------------

def _on_cpu(name: str, x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {x.device}")
    return False


def _check(q, k, v, seq_len, *more) -> None:
    """What the kernels take: contiguous (BH, L, D) f32 or bf16 on one card,
    D <= 128, BH <= 65535, 0 <= seq_len <= Lk; ``more`` are (name, tensor,
    dtype, shape) of the backward's extra inputs."""
    if q.dim() != 3 or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"q must be (BH, L, D) float32 or bfloat16, got "
                         f"{q.dtype} {tuple(q.shape)}")
    bh, _, d = q.shape
    lk = k.shape[1] if k.dim() == 3 else -1
    if d > MAX_HEAD_DIM or bh > 65535:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM} or B·H {bh} > 65535:"
                         f" the flash kernels do not take it")
    if not 0 <= seq_len <= lk:
        raise ValueError(f"seq_len {seq_len} outside [0, Lk={lk}]")
    for name, t, dtype, shape in (("q", q, q.dtype, q.shape),
                                  ("k", k, q.dtype, (bh, lk, d)),
                                  ("v", v, q.dtype, (bh, lk, d))) + more:
        if (t.device != q.device or t.dtype != dtype or t.shape != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} "
                             f"{tuple(shape)} tensor on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"strides {t.stride()}")


def _call(symbol: str, name: str, q, args) -> None:
    fn = kernel(name, symbol, _SIGNATURES[symbol])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*args, _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError_t {err} for "
                           f"q {tuple(q.shape)} {q.dtype}")


def _ints(q, k, seq_len, causal, q_off, kv_off):
    bh, lq, d = q.shape
    return (bh, lq, k.shape[1], d, seq_len, int(causal), q_off, kv_off)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, seq_len: int, causal: bool = False,
              q_off: int = 0, kv_off: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` of attention over ``(BH, L, D)`` q, k, v: o in q's
    dtype, lse ``(BH, Lq)`` f32.  CPU tensors take
    :func:`flash_fwd_reference`, CUDA tensors the kernel."""
    if _on_cpu("flash_fwd", q):
        return flash_fwd_reference(q, k, v, scale, seq_len, causal, q_off,
                                   kv_off)
    _check(q, k, v, seq_len)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _call("dfd_flash_fwd", "flash_fwd", q,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
           lse.data_ptr(), *_ints(q, k, seq_len, causal, q_off, kv_off),
           scale))
    count_launch(flash_fwd, q.dtype)
    return o, lse


flash_fwd.launches = 0
flash_fwd.launches_by_dtype = Counter()


def _bwd_more(q, do, lse, delta):
    f32 = torch.float32
    return (("do", do, q.dtype, q.shape), ("lse", lse, f32, q.shape[:2]),
            ("delta", delta, f32, q.shape[:2]))


def flash_bwd_dq(q, k, v, do, lse, delta, scale: float, seq_len: int,
                 causal: bool = False, q_off: int = 0,
                 kv_off: int = 0) -> torch.Tensor:
    """dQ in f32 from the forward's lse and ``delta = rowsum(dO ∘ O)``
    (both ``(BH, Lq)`` f32); ``do`` in q's dtype."""
    if _on_cpu("flash_bwd_dq", q):
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, scale,
                                      seq_len, causal, q_off, kv_off)
    _check(q, k, v, seq_len, *_bwd_more(q, do, lse, delta))
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _call("dfd_flash_bwd_dq", "flash_bwd_dq", q,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
           *_ints(q, k, seq_len, causal, q_off, kv_off), scale))
    count_launch(flash_bwd_dq, q.dtype)
    return dq


flash_bwd_dq.launches = 0
flash_bwd_dq.launches_by_dtype = Counter()


def flash_bwd_dkv(q, k, v, do, lse, delta, scale: float, seq_len: int,
                  causal: bool = False, q_off: int = 0, kv_off: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)`` in f32, from the same inputs as :func:`flash_bwd_dq`."""
    if _on_cpu("flash_bwd_dkv", q):
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, scale,
                                       seq_len, causal, q_off, kv_off)
    _check(q, k, v, seq_len, *_bwd_more(q, do, lse, delta))
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    _call("dfd_flash_bwd_dkv", "flash_bwd_dkv", q,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
           *_ints(q, k, seq_len, causal, q_off, kv_off), scale))
    count_launch(flash_bwd_dkv, q.dtype)
    return dk, dv


flash_bwd_dkv.launches = 0
flash_bwd_dkv.launches_by_dtype = Counter()


# ---------------------------------------------------------------------------
# public op
# ---------------------------------------------------------------------------

class FlashAttentionFunction(torch.autograd.Function):
    """Self-attention over ``(BH, L, D)`` q, k, v; the backward runs dK/dV,
    then dQ, from the saved lse, in f32, cast to the inputs' dtype."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool):
        o, lse = flash_fwd(q, k, v, scale, k.shape[1], causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (scale, causal)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        scale, causal = ctx.cfg
        do = do.to(q.dtype).contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, scale, k.shape[1],
                               causal)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, scale, k.shape[1], causal)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention in O(L) memory, ``(B, L, H, D) → (B, L, H, D)`` (the JAX
    layout, as :func:`parallel.ring_attention.full_attention`); scale
    defaults to ``D**-0.5``.  Self-attention shapes only."""
    if q.dim() != 4 or not q.shape == k.shape == v.shape:
        raise ValueError(f"flash_attention takes (B, L, H, D) self-attention "
                         f"shapes (equal q, k, v), got q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    b, l, h, d = q.shape
    scale = d ** -0.5 if scale is None else scale

    def prep(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, l, d).contiguous()

    qb, kb, vb = prep(q), prep(k), prep(v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = FlashAttentionFunction.apply(qb, kb, vb, scale, causal)
    else:
        out = flash_fwd(qb, kb, vb, scale, l, causal)[0]
    return out.view(b, h, l, d).permute(0, 2, 1, 3)

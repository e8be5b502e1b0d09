"""Weight-only post-training quantization for the inference path.

The counterpart of ``deepfake_detection_tpu/serving/quant.py``: the
checkpoint on disk, the reload watcher's input and the canary's shape gate
stay f32; only the copy of the weights kept on the device is compressed,
and the compute stays f32:

* ``bf16`` casts every tensor whose flax counterpart is a ``params`` leaf
  (the module's ``nn.Parameter``s; never the BN running statistics) to
  bfloat16.  :func:`realize` widens them back to f32, so the model
  computes in f32 on bf16-rounded weights, as the JAX program does after
  type promotion.  This is not the ``--amp`` compute policy
  (``models/helpers.set_compute_dtype``): no activation is bf16 and the
  depthwise kernel runs its f32 instantiation.
* ``int8`` quantizes the tensors whose flax counterpart is a ``kernel``
  leaf (conv, depthwise and linear weights, chosen by the weight bridge's
  naming, :func:`..convert.flax_leaf`, not by ndim: a ViT's ``pos_embed``
  is 3-d and not a kernel) to int8 with symmetric per-output-channel
  scales: axis 0 of the torch layout, the last axis of flax's.  Each
  becomes a :class:`Q8` of the int8 values and the f32 scales, and
  :func:`realize` dequantizes it (``q.float() * scale``) inside the scoring
  program.  Everything else (biases, BN, LayerNorm, embeddings) stays f32.

A quantized store is an ordinary dict (name → bf16 tensor or :class:`Q8`)
of the quantized tensors only; :func:`quantized_store` is deterministic,
so a reloaded checkpoint re-quantizes to tensors of the same shapes and
dtypes, which the engine ``copy_``s into its resident store in place.
:func:`quantize_leaf` is a numpy copy of the JAX function: the same
operations in the same order, so the int8 values and scales are bitwise
the JAX package's once the layouts are bridged.  ``f32`` has no store, and
:func:`module_forward` then is the module itself: an f32 program adds no
operation.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..convert import flax_leaf

__all__ = ["QUANT_MODES", "Q8", "canonical_mode", "quantize_leaf",
           "quantized_store", "realize", "quant_summary", "ptq_names",
           "resident_bytes", "module_forward", "strip_module",
           "quantize_module"]

#: canonical serving dtypes (aliases accepted by :func:`canonical_mode`)
QUANT_MODES = ("f32", "bf16", "int8")

_ALIASES = {"f32": "f32", "float32": "f32",
            "bf16": "bf16", "bfloat16": "bf16",
            "int8": "int8"}


class Q8(NamedTuple):
    """One int8-quantized kernel: values in the tensor's own layout and the
    f32 scale of each output channel (axis 0)."""
    q: torch.Tensor
    scale: torch.Tensor


def canonical_mode(mode: str) -> str:
    """``float32``/``bfloat16`` aliases → the canonical short names."""
    try:
        return _ALIASES[str(mode).lower()]
    except KeyError:
        raise ValueError(
            f"unknown quantization dtype {mode!r}; pick one of "
            f"{QUANT_MODES} (aliases: float32, bfloat16)") from None


def quantize_leaf(w: np.ndarray, axis: int = 0
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """One kernel → (int8 values, per-output-channel f32 scales), the
    output channel on ``axis`` (0 in torch's layout; -1 gives the JAX
    function on flax's).

    Symmetric: ``scale = amax(|w|) / 127`` over every other axis, ``q =
    round(w / scale)`` clipped to [-127, 127].  An all-zero channel gets
    scale 1.0; a non-finite channel gets scale NaN, so that dequantizing
    reproduces the poison and the reload canary sees it."""
    w = np.asarray(w, np.float32)
    axis = axis % w.ndim
    axes = tuple(a for a in range(w.ndim) if a != axis)
    amax = np.max(np.abs(w), axis=axes)
    scale = np.where(amax > 0, amax / 127.0, 1.0)
    scale = np.where(np.isfinite(amax), scale, np.nan).astype(np.float32)
    shape = [1] * w.ndim
    shape[axis] = -1
    with np.errstate(invalid="ignore"):
        q = np.clip(np.rint(w / scale.reshape(shape)), -127,
                    127).astype(np.int8)
    return q, scale


def ptq_names(names: Iterable[str], params: Iterable[str]
              ) -> Tuple[frozenset, frozenset]:
    """(bf16-eligible, int8-eligible) names of a state dict: the
    parameters (flax ``params`` leaves), and of those the ones the weight
    bridge maps from a flax ``kernel`` leaf."""
    params = set(params)
    bf16 = frozenset(n for n in names if n in params)
    int8 = frozenset(n for n in bf16 if flax_leaf(n) == "kernel")
    return bf16, int8


def quantized_store(state: Mapping[str, Any], mode: str, *,
                    bf16_names: Iterable[str], int8_names: Iterable[str],
                    device: Optional[torch.device] = None
                    ) -> Optional[Dict[str, Any]]:
    """PTQ of an f32 state dict: the quantized tensors of the eligible
    names (see the module docstring), in the state's order, on ``device``
    (default: where they were); None at f32.  This is what a server or the
    CLI keeps resident in place of those f32 tensors.  The int8 values are
    computed on the host (:func:`quantize_leaf`)."""
    mode = canonical_mode(mode)
    if mode == "f32":
        return None
    names = set(bf16_names if mode == "bf16" else int8_names)
    out: Dict[str, Any] = {}
    for name, v in state.items():
        if name not in names:
            continue
        t = torch.as_tensor(v).detach()
        dev = t.device if device is None else device
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: PTQ takes f32 weights, got {t.dtype}")
        if mode == "bf16":
            out[name] = t.to(device=dev, dtype=torch.bfloat16)
        else:
            q, scale = quantize_leaf(t.cpu().numpy())
            out[name] = Q8(torch.from_numpy(q).to(dev).contiguous(
                memory_format=_memory_format(t)),
                torch.from_numpy(scale).to(dev))
    return out


def strip_module(model: torch.nn.Module, names: Iterable[str]) -> None:
    """Replace the parameters ``names`` of ``model`` by shape-only ``meta``
    tensors: a quantized store holds them now, and the device keeps no f32
    copy.  :func:`module_forward` supplies them realized."""
    for name in names:
        prefix, _, leaf = name.rpartition(".")
        mod = model.get_submodule(prefix) if prefix else model
        old = getattr(mod, leaf)
        setattr(mod, leaf, torch.nn.Parameter(
            torch.empty_like(old, device="meta"), requires_grad=False))


def quantize_module(model: torch.nn.Module, mode: str
                    ) -> Optional[Dict[str, Any]]:
    """PTQ of ``model``'s loaded f32 weights in place: returns the
    quantized store on the model's device and strips those parameters
    from the module (None, and the module untouched, at f32).  Run the
    model as ``module_forward(model, store)``."""
    if canonical_mode(mode) == "f32":
        return None
    state = model.state_dict()
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    bf16, int8 = ptq_names(state, params)
    store = quantized_store(state, mode, bf16_names=bf16, int8_names=int8,
                            device=device)
    strip_module(model, store)
    return store


def _memory_format(t: torch.Tensor) -> torch.memory_format:
    """channels_last for a 4-d tensor laid out so (an EfficientNet's conv
    weights), so that realized weights keep the layout cuDNN was given."""
    if t.dim() == 4 and not t.is_contiguous() and \
            t.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


def _realize_one(v):
    if isinstance(v, Q8):
        return v.q.to(torch.float32) * v.scale.view(
            (-1,) + (1,) * (v.q.dim() - 1))
    if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
        return v.to(torch.float32)
    return v


def realize(state: Mapping[str, Any]) -> Dict[str, Any]:
    """Dequantize: each :class:`Q8` becomes ``q.float() * scale`` (the
    scale broadcast along axis 0), each bf16 tensor its f32 widening;
    everything else passes through."""
    return {k: _realize_one(v) for k, v in state.items()}


def quant_summary(state: Mapping[str, Any]) -> Dict[str, int]:
    """{quantized_leaves, quantized_bytes, bf16_leaves, total_leaves} of
    the dict given (a store holds the quantized tensors only), the JAX
    summary's keys: what the CLI prints and the engine logs, so an
    operator sees the transform happened."""
    n_q = n_bf16 = q_bytes = 0
    for v in state.values():
        if isinstance(v, Q8):
            n_q += 1
            q_bytes += int(v.q.numel())
        elif isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
            n_bf16 += 1
    return {"quantized_leaves": n_q, "quantized_bytes": q_bytes,
            "bf16_leaves": n_bf16, "total_leaves": len(state)}


def resident_bytes(state: Mapping[str, Any]) -> int:
    """Bytes a (quantized) state holds: int8 values plus scales, bf16 or
    f32 tensors."""
    total = 0
    for v in state.values():
        for t in (v if isinstance(v, Q8) else (v,)):
            if isinstance(t, torch.Tensor):
                total += t.numel() * t.element_size()
    return total


def module_forward(model: torch.nn.Module,
                   store: Optional[Mapping[str, Any]] = None):
    """``model`` itself without a quantized store (f32: no operation
    added); else a function that realizes ``store`` and runs ``model`` on
    those weights through ``torch.func.functional_call`` (the module's own
    tensors for every other name)."""
    if not store:
        return model

    def forward(x: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(model, realize(store), (x,))
    return forward

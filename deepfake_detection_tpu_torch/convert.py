"""JAX variables → the port's state dict.

The inverse of ``tools/convert_torch_checkpoint.py::convert_state_dict`` for
the EfficientNet family, written here so the port needs neither the tool nor
msgpack: the JAX package's ``{'params', 'batch_stats'}`` tree (numpy arrays)
becomes a ``{timm name: torch.Tensor}`` state dict.

* conv kernels HWIO → OIHW (depthwise ``(kh, kw, 1, C)`` → ``(C, 1, kh,
  kw)`` falls out of the same transpose), dense ``(in, out)`` → ``(out,
  in)``;
* BN ``scale``/``bias``/``mean``/``var`` → ``weight``/``bias``/
  ``running_mean``/``running_var``, plus a zero ``num_batches_tracked``;
* flax paths map to timm names: ``conv_stem.conv.conv.kernel`` →
  ``conv_stem.weight``, ``conv_stem.bn1.bn.*`` → ``bn1.*``,
  ``blocks_{s}_{b}.<conv>.conv.kernel`` → ``blocks.{s}.{b}.<conv>.weight``,
  ``blocks_{s}_{b}.se.conv_reduce.conv.bias`` →
  ``blocks.{s}.{b}.se.conv_reduce.bias``, ``bn2.bn.*`` → ``bn2.*``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

__all__ = ["state_dict_from_flax"]

_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}
_W_LEAF = {"kernel": "weight", "bias": "bias"}


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def _bn_name(base: str, leaf: str) -> str:
    return f"{base}.{_BN_LEAF[leaf]}"


def _map_path(parts: Tuple[str, ...]) -> Tuple[str, bool]:
    """flax path (without its collection) → (timm name, is a BN leaf)."""
    head, leaf = parts[0], parts[-1]
    if head == "conv_stem" and parts[1] == "conv":
        return "conv_stem.weight", False
    if head == "conv_stem" and parts[1] == "bn1":
        return _bn_name("bn1", leaf), True
    if head == "bn2":
        return _bn_name("bn2", leaf), True
    if head in ("conv_head", "classifier"):
        return f"{head}.{_W_LEAF[leaf]}", False
    if head.startswith("blocks_"):
        _, s, b = head.split("_")
        prefix, sub = f"blocks.{s}.{b}", parts[1]
        if sub == "se":
            return f"{prefix}.se.{parts[2]}.{_W_LEAF[leaf]}", False
        if sub.startswith("bn"):
            return _bn_name(f"{prefix}.{sub}", leaf), True
        if sub.startswith("conv"):
            return f"{prefix}.{sub}.{_W_LEAF[leaf]}", False
    raise KeyError(f"no timm name for flax path {'/'.join(parts)}")


def _to_torch_layout(v: np.ndarray) -> np.ndarray:
    if v.ndim == 4:
        return np.transpose(v, (3, 2, 0, 1))          # HWIO → OIHW
    if v.ndim == 2:
        return np.transpose(v, (1, 0))                # (in,out) → (out,in)
    return v


def state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{'params': ..., 'batch_stats': ...}`` of an EfficientNet → the
    port's state dict (float32 tensors that own their memory)."""
    sd: Dict[str, torch.Tensor] = {}
    bn_bases = set()
    for collection in ("params", "batch_stats"):
        for parts, v in _flatten(variables.get(collection, {})).items():
            name, is_bn = _map_path(parts)
            if name in sd:
                raise KeyError(f"two flax leaves map to {name}")
            arr = _to_torch_layout(np.asarray(v, np.float32))
            sd[name] = torch.from_numpy(np.ascontiguousarray(arr).copy())
            if is_bn:
                bn_bases.add(name.rsplit(".", 1)[0])
    for base in sorted(bn_bases):
        sd[f"{base}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd

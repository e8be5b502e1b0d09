"""JAX variables → the port's state dict.

The inverse of ``tools/convert_torch_checkpoint.py::convert_state_dict``,
written here so the port needs neither the tool nor msgpack: the JAX
package's ``{'params', 'batch_stats'}`` tree (numpy arrays) becomes a
``{timm name: torch.Tensor}`` state dict.  The family follows from the
tree: a ``patch_embed`` means ViT or TimeSformer, anything else the
EfficientNet family.

EfficientNet:

* conv kernels HWIO → OIHW (depthwise ``(kh, kw, 1, C)`` → ``(C, 1, kh,
  kw)`` falls out of the same transpose), dense ``(in, out)`` → ``(out,
  in)``;
* BN ``scale``/``bias``/``mean``/``var`` → ``weight``/``bias``/
  ``running_mean``/``running_var``, plus a zero ``num_batches_tracked``;
* flax paths map to timm names: ``conv_stem.conv.conv.kernel`` →
  ``conv_stem.weight``, ``conv_stem.bn1.bn.*`` → ``bn1.*``,
  ``blocks_{s}_{b}.<conv>.conv.kernel`` → ``blocks.{s}.{b}.<conv>.weight``,
  ``blocks_{s}_{b}.se.conv_reduce.conv.bias`` →
  ``blocks.{s}.{b}.se.conv_reduce.bias``, ``bn2.bn.*`` → ``bn2.*``;
* a split BN (``--split-bn``) takes timm's ``SplitBatchNorm2d`` layout:
  ``<bn>.main.bn.*`` → ``<bn>.*`` (the main BN under the module's own
  name) and ``<bn>.aux{i}.bn.*`` → ``<bn>.aux_bn.{i}.*``.

ViT and TimeSformer:

* dense kernels ``(in, out)`` → ``(out, in)``, the patch conv HWIO → OIHW
  (``patch_embed.proj``), LayerNorm ``scale`` → ``weight``;
* the fused qkv kernel's and bias's 3C columns go from the JAX model's
  head-major (H, 3, D) to timm's (3, H, D), which needs ``num_heads``;
* ``blocks_{i}.<module>`` → ``blocks.{i}.<module>`` with ``mlp_fc1`` →
  ``mlp.fc1``; ViT's ``norm1``/``attn``/``norm2`` are timm's names,
  TimeSformer's ``norm_t``/``attn_t``/``norm_s``/``attn_s``/``norm_mlp``
  the port's own (it has no timm counterpart); ``cls_token``,
  ``pos_embed``, ``time_embed``, ``norm`` and ``head`` keep theirs.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["state_dict_from_flax", "flax_leaf"]

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


def _split_part(part: str) -> Optional[str]:
    """A split BN's level of a flax path: ``""`` for ``main``, ``"aux_bn.i"``
    for ``aux{i}``, None for any other part."""
    if part == "main":
        return ""
    if part.startswith("aux") and part[3:].isdigit():
        return f"aux_bn.{part[3:]}"
    return None


def _map_path(parts: Tuple[str, ...]) -> Tuple[str, bool]:
    """flax path (without its collection) → (timm name, is a BN leaf)."""
    for i, part in enumerate(parts[:-1]):
        sub = _split_part(part)
        if sub is not None and parts[i + 1:i + 2] == ("bn",):
            name, is_bn = _map_path(parts[:i] + parts[i + 1:])
            if sub and is_bn:
                base, leaf = name.rsplit(".", 1)
                name = f"{base}.{sub}.{leaf}"
            return name, is_bn
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


def flax_leaf(name: str) -> str:
    """The flax leaf a port state-dict name maps from, by the names above:
    ``kernel`` for the ``weight`` of a conv or linear layer, ``scale`` for
    that of a BN (``bn*``) or LayerNorm (``norm*``), ``bias``, ``mean`` and
    ``var`` for BN's running statistics, and the name itself for the
    transformers' top-level ``cls_token`` / ``pos_embed`` / ``time_embed``
    (and ``num_batches_tracked``, which has no flax leaf)."""
    parts = name.split(".")
    leaf = parts[-1]
    if len(parts) == 1:
        return leaf
    if leaf == "weight":
        bn = parts[-2].startswith(("bn", "norm")) or parts[-3:-2] == [
            "aux_bn"]
        return "scale" if bn else "kernel"
    return {"running_mean": "mean", "running_var": "var"}.get(leaf, leaf)


def _to_torch_layout(v: np.ndarray) -> np.ndarray:
    if v.ndim == 4:
        return np.transpose(v, (3, 2, 0, 1))          # HWIO → OIHW
    if v.ndim == 2:
        return np.transpose(v, (1, 0))                # (in,out) → (out,in)
    return v


def _map_transformer(parts: Tuple[str, ...]) -> str:
    """flax path of a ViT/TimeSformer parameter → the port's name."""
    head, leaf = parts[0], parts[-1]
    if len(parts) == 1:                           # cls_token, embeddings
        return head
    name = {"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf]
    if head == "patch_embed":
        return f"patch_embed.proj.{name}"
    if head.startswith("blocks_"):
        sub = parts[1].replace("mlp_fc", "mlp.fc")
        return ".".join(("blocks", head.split("_")[1], sub, *parts[2:-1],
                         name))
    return f"{head}.{name}"


def _qkv_to_timm(v: np.ndarray, num_heads: Optional[int]) -> np.ndarray:
    """Last axis (H, 3, D) → (3, H, D)."""
    if not num_heads:
        raise ValueError("a fused qkv needs num_heads for its column order")
    d = v.shape[-1] // (3 * num_heads)
    v = v.reshape(v.shape[:-1] + (num_heads, 3, d))
    return np.swapaxes(v, -3, -2).reshape(v.shape[:-3] + (3 * num_heads * d,))


def state_dict_from_flax(variables: Dict[str, Any],
                         num_heads: Optional[int] = None
                         ) -> Dict[str, torch.Tensor]:
    """``{'params': ..., 'batch_stats': ...}`` of an EfficientNet, or
    ``{'params': ...}`` of a ViT or TimeSformer with ``num_heads`` heads →
    the port's state dict (float32 tensors that own their memory)."""
    params = variables.get("params", {})
    if "patch_embed" in params:
        sd = {}
        for parts, v in _flatten(params).items():
            arr = np.asarray(v, np.float32)
            if parts[-2:-1] == ("qkv",):
                arr = _qkv_to_timm(arr, num_heads)
            name = _map_transformer(parts)
            arr = _to_torch_layout(arr) if arr.ndim in (2, 4) and \
                parts[-1] == "kernel" else arr
            sd[name] = torch.from_numpy(np.ascontiguousarray(arr).copy())
        return sd
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

"""JAX variables → the port's state dict.

The inverse of ``tools/convert_torch_checkpoint.py::convert_state_dict``,
written here so the port needs neither the tool nor msgpack: the JAX
package's ``{'params', 'batch_stats'}`` tree (numpy arrays) becomes a
``{timm name: torch.Tensor}`` state dict.  The family follows from the
tree: a ``patch_embed`` means ViT or TimeSformer, a ``layer1_0`` the
ResNet-derived families or SENet, anything else the EfficientNet family.

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
* a MixedConv arm ``blocks_{s}_{b}.<conv>.conv_{i}.conv.kernel`` →
  ``blocks.{s}.{b}.<conv>.{i}.weight`` (timm's module dict of arms);
* a CondConv's experts ``blocks_{s}_{b}.<conv>.weight`` ``(E, kh, kw,
  in/g, out)`` → the same name flat, ``(E, out·in/g·kh·kw)`` (timm's
  layout), and its router ``routing_fn.kernel`` → ``routing_fn.weight``;
* the MobileNetV3 head's ``conv_head.conv.bias`` → ``conv_head.bias``, and
  a ``catavgmax`` classifier's ``(2F, classes)`` kernel as any dense one;
* a split BN (``--split-bn``) takes timm's ``SplitBatchNorm2d`` layout:
  ``<bn>.main.bn.*`` → ``<bn>.*`` (the main BN under the module's own
  name) and ``<bn>.aux{i}.bn.*`` → ``<bn>.aux_bn.{i}.*``.

ResNet, gluon_resnet, res2net, sknet and SENet:

* the flat block paths ``layer{s}_{b}/...`` → ``layer{s}.{b}....``; the
  layouts and leaves as the EfficientNet family's, and ECA's 1-D kernel
  ``(k, 1, 1)`` → timm's ``(1, 1, k)``;
* the deep stem ``conv1_{0,1,2}`` / ``stem_bn{0,1}`` → ``conv1.{0,3,6}`` /
  ``conv1.{1,4}``; SENet's stem (``conv1`` … ``bn3``) → ``layer0.*``;
* the shortcut ``downsample/{conv,bn}`` → ``downsample.{0,1}``, or
  ``.{1,2}`` under ``avg_down`` (timm's pool holds index 0; the flax tree
  does not record it, so the caller says so), SENet's
  ``downsample_{conv,bn}`` → ``downsample.{0,1}``;
* res2net's ``convs_{i}``/``bns_{i}`` → ``convs.{i}``/``bns.{i}``;
* the SK conv's ``path_{i}_{conv,bn}`` → ``paths.{i}.{conv,bn}``,
  ``attn_fc``/``attn_bn``/``attn_sel`` → ``attn.fc_reduce``/``attn.bn``/
  ``attn.fc_select``, and an SK block's plain ``conv{n}``/``bn{n}`` →
  timm's ``ConvBnAct`` ``conv{n}.conv``/``conv{n}.bn``.

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

import re
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
        if sub == "routing_fn":
            return f"{prefix}.routing_fn.{_W_LEAF[leaf]}", False
        if sub.startswith("conv"):
            arm = parts[2] if len(parts) > 3 else ""
            if arm.startswith("conv_") and arm[5:].isdigit():
                return f"{prefix}.{sub}.{arm[5:]}.{_W_LEAF[leaf]}", False
            if leaf == "weight":                      # CondConv experts
                return f"{prefix}.{sub}.weight", False
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
    if v.ndim == 3:                 # ECA's 1-D conv (k, in, out) → (out, in, k)
        return np.transpose(v, (2, 1, 0))
    if v.ndim == 5:                 # CondConv (E, kh, kw, in/g, out) → flat
        return np.transpose(v, (0, 4, 3, 1, 2)).reshape(v.shape[0], -1)
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


_SENET_STEM = {"conv1", "bn1", "conv2", "bn2", "conv3", "bn3"}
_DEEP_STEM = {"conv1_0": "conv1.0", "stem_bn0": "conv1.1",
              "conv1_1": "conv1.3", "stem_bn1": "conv1.4",
              "conv1_2": "conv1.6"}
_SK_ATTN = {"attn_fc": "attn.fc_reduce", "attn_bn": "attn.bn",
            "attn_sel": "attn.fc_select"}


def _map_resnet(parts: Tuple[str, ...], senet: bool, sk: bool,
                avg_down: bool) -> Tuple[str, bool]:
    """flax path of a ResNet-family or SENet leaf → (timm name, is a BN
    leaf); see the module docstring."""
    leaf = parts[-1]
    is_bn = leaf in ("scale", "mean", "var") or parts[-2] == "bn"
    mods = list(parts[:-1])
    # the Conv2d / BatchNorm2d wrappers' inner module; ECA's own nn.Conv
    # (``se/conv``, the only 1-D kernel) is a module of its block
    if len(mods) > 1 and mods[-1] in ("conv", "bn") and \
            mods[-2:] != ["se", "conv"]:
        mods.pop()
    head = mods[0]
    if head.startswith("layer"):
        s, b = head[len("layer"):].split("_")
        out = [f"layer{s}", b]
        rest = mods[1:]
        if rest[0] in ("downsample", "downsample_conv", "downsample_bn"):
            kind = rest[-1] if rest[0] == "downsample" else rest[0][11:]
            index = (kind == "bn") + (avg_down and not senet)
            out += ["downsample", str(index)]
        elif re.fullmatch(r"(convs|bns)_\d+", rest[0]):
            out += rest[0].split("_")
        elif len(rest) > 1 and rest[1].startswith("path_"):
            _, i, kind = rest[1].split("_")
            out += [rest[0], "paths", i, kind]
        elif len(rest) > 1 and rest[1] in _SK_ATTN:
            out += [rest[0], _SK_ATTN[rest[1]]]
        elif sk and len(rest) == 1 and re.fullmatch(r"(conv|bn)\d", rest[0]):
            out += [f"conv{rest[0][-1]}", rest[0][:-1]]
        else:
            out += rest
    elif head in _DEEP_STEM:
        out = [_DEEP_STEM[head]]
    elif senet and head in _SENET_STEM:
        out = ["layer0", head]
    else:
        out = mods
    name = ".".join(out)
    if is_bn:
        return _bn_name(name, leaf), True
    return f"{name}.{_W_LEAF[leaf]}", False


def state_dict_from_flax(variables: Dict[str, Any],
                         num_heads: Optional[int] = None,
                         avg_down: bool = False
                         ) -> Dict[str, torch.Tensor]:
    """``{'params': ..., 'batch_stats': ...}`` of an EfficientNet, a
    ResNet-family model (``avg_down``: its shortcuts pool first) or a
    SENet, or ``{'params': ...}`` of a ViT or TimeSformer with
    ``num_heads`` heads → the port's state dict (float32 tensors that own
    their memory)."""
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
    map_path = _map_path
    trees = [variables.get(c, {}) for c in ("params", "batch_stats")]
    if any("layer1_0" in tree for tree in trees):
        paths = [p for tree in trees for p in _flatten(tree)]
        senet = any("se_module" in p or "downsample_bn" in p for p in paths)
        sk = any("path_0_conv" in p or "path_0_bn" in p for p in paths)

        def map_path(parts):
            return _map_resnet(parts, senet, sk, avg_down)
    sd: Dict[str, torch.Tensor] = {}
    bn_bases = set()
    for collection in ("params", "batch_stats"):
        for parts, v in _flatten(variables.get(collection, {})).items():
            name, is_bn = map_path(parts)
            if name in sd:
                raise KeyError(f"two flax leaves map to {name}")
            arr = _to_torch_layout(np.asarray(v, np.float32))
            sd[name] = torch.from_numpy(np.ascontiguousarray(arr).copy())
            if is_bn:
                bn_bases.add(name.rsplit(".", 1)[0])
    for base in sorted(bn_bases):
        sd[f"{base}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd

"""Vision Transformer (PyTorch, NCHW input).

Counterpart of ``deepfake_detection_tpu/models/vit.py``: pre-LN blocks,
learned position embedding, optional class token, token or mean pooling,
LayerNorm ε = 1e-5 and exact (erf) GELU.  Module and parameter names are
timm's (``patch_embed.proj``, ``cls_token``, ``pos_embed``,
``blocks.{i}.norm1/attn.qkv/attn.proj/norm2/mlp.fc1/mlp.fc2``, ``norm``,
``head``), and so is the fused qkv's column order, (3, H, D); the JAX model
reads those columns head-major, (H, 3, D), and ``convert`` permutes them.

Attention is ``attn_impl='full'`` (dense, :func:`parallel.ring_attention.
full_attention`) or ``'flash'`` (the CUDA kernels of
:mod:`ops.flash_attention`).  The sequence-parallel impls raise: they are
ROADMAP Queue 1 item 13, and so are the JAX module's pipeline helpers
``prepare_vit_pipeline`` / ``vit_pipeline_forward``.

Under a compute dtype (``models.helpers.set_compute_dtype``) the patch
conv, every dense layer and LayerNorm compute as the JAX modules' ``dtype=``
does, and the class token and position embedding are cast to the tokens'
dtype before they are added, as the JAX model casts them.

Where the JAX model sizes ``pos_embed`` from its first input, this one
takes ``img_size`` at construction (the registered default, or the size the
caller passes) and raises on an input of another token count.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import Conv2d
from ..ops.drop import drop_path, dropout
from ..ops.flash_attention import flash_attention
from ..ops.linear import Linear
from ..ops.norm import LayerNorm
from ..parallel.ring_attention import full_attention
from ..registry import register_model

__all__ = ["VisionTransformer", "Attention", "Block", "Mlp", "init_weights",
           "default_cfgs", "ATTN_IMPLS"]

#: every attn_impl of the JAX package; the port runs the first two
ATTN_IMPLS = ("full", "flash", "ring", "ring_flash", "ulysses")


def _cfg(**kwargs) -> Dict[str, Any]:
    cfg = dict(num_classes=1000, input_size=(3, 224, 224), pool_size=None,
               crop_pct=0.9, interpolation="bicubic",
               mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
               first_conv="patch_embed", classifier="head")
    cfg.update(kwargs)
    return cfg


def _pair(size: Union[int, Sequence[int]]):
    return (size, size) if isinstance(size, int) else tuple(size)


def check_attn_impl(attn_impl: str) -> None:
    if attn_impl in ("ring", "ring_flash", "ulysses"):
        raise NotImplementedError(
            f"attn_impl={attn_impl!r}: sequence-parallel attention is not "
            f"ported yet (ROADMAP Queue 1 item 13); use 'full' or 'flash'")
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl={attn_impl!r}: expected one of "
                         f"{ATTN_IMPLS}")


class Attention(nn.Module):
    """Multi-head self-attention over ``(B, L, C)`` with a pluggable
    kernel."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_impl: str = "full"):
        super().__init__()
        check_attn_impl(attn_impl)
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, c = x.shape
        h = self.num_heads
        # timm's (3, H, D) column order
        q, k, v = self.qkv(x).reshape(b, l, 3, h, c // h).unbind(2)
        attend = flash_attention if self.attn_impl == "flash" \
            else full_attention
        return self.proj(attend(q, k, v).reshape(b, l, c))


class Mlp(nn.Module):
    """fc1 → exact GELU → dropout → fc2 → dropout."""

    def __init__(self, dim: int, hidden: int, drop_rate: float = 0.0):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)
        self.drop_rate = drop_rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = self.drop_rate if self.training else 0.0
        x = dropout(F.gelu(self.fc1(x)), rate, generator)
        return dropout(self.fc2(x), rate, generator)


class Block(nn.Module):
    """Pre-LN transformer block: x + attn(norm1(x)), then x + mlp(norm2(x)),
    each branch with dropout and stochastic depth in train mode."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, attn_impl: str = "full"):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = Attention(dim, num_heads, qkv_bias, attn_impl)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop_rate)
        self.drop_rate = drop_rate
        self.drop_path_rate = drop_path_rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        train = self.training
        y = dropout(self.attn(self.norm1(x)),
                    self.drop_rate if train else 0.0, generator)
        x = x + drop_path(y, self.drop_path_rate if train else 0.0, generator)
        y = self.mlp(self.norm2(x), generator)
        return x + drop_path(y, self.drop_path_rate if train else 0.0,
                             generator)


class PatchEmbed(nn.Module):
    """Non-overlapping p×p patches → ``embed_dim`` (timm's ``proj``)."""

    def __init__(self, in_chans: int, embed_dim: int, patch_size: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Conv2d(in_chans, embed_dim, patch_size, patch_size,
                           padding="valid", bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW → ``(B, N, C)``, tokens in row-major patch order."""
        p = self.patch_size
        if x.shape[2] % p or x.shape[3] % p:
            raise ValueError(f"input {tuple(x.shape)} is not a multiple of "
                             f"the patch size {p}")
        return self.proj(x).flatten(2).transpose(1, 2)


class VisionTransformer(nn.Module):
    """ViT classifier over an NCHW batch; token or mean pooling."""

    def __init__(self, img_size: Union[int, Sequence[int]] = 224,
                 patch_size: int = 16, in_chans: int = 3,
                 num_classes: int = 1000, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 class_token: bool = True, global_pool: str = "token",
                 drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 attn_impl: str = "full", default_cfg: Optional[dict] = None):
        super().__init__()
        if global_pool not in ("token", "avg"):
            raise ValueError(f"global_pool must be 'token' or 'avg', got "
                             f"{global_pool!r}")
        if global_pool == "token" and not class_token:
            raise ValueError("token pooling needs a class token")
        h, w = _pair(img_size)
        self.in_chans = in_chans
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads = num_heads
        self.class_token = class_token
        self.global_pool = global_pool
        self.drop_rate = drop_rate
        self.default_cfg = default_cfg
        self.patch_embed = PatchEmbed(in_chans, embed_dim, patch_size)
        n = (h // patch_size) * (w // patch_size) + int(class_token)
        if class_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n, embed_dim))
        # stochastic depth grows linearly over the blocks (timm convention)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, drop_rate,
                  drop_path_rate * i / max(depth - 1, 1), attn_impl)
            for i in range(depth))
        self.norm = LayerNorm(embed_dim, eps=1e-5)
        self.head = Linear(embed_dim, num_classes) \
            if num_classes > 0 else None

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x.shape[1] != self.in_chans:
            raise ValueError(f"expected {self.in_chans} input channels "
                             f"(NCHW), got {tuple(x.shape)}")
        x = self.patch_embed(x)
        if self.class_token:
            cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
            x = torch.cat([cls, x], 1)
        if x.shape[1] != self.pos_embed.shape[1]:
            raise ValueError(f"{x.shape[1]} tokens, but pos_embed was made "
                             f"for {self.pos_embed.shape[1]}: build the "
                             f"model with this input's img_size")
        x = dropout(x + self.pos_embed.to(x.dtype),
                    self.drop_rate if self.training else 0.0, generator)
        for block in self.blocks:
            x = block(x, generator)
        x = self.norm(x)
        if self.global_pool == "avg":
            feat = x[:, int(self.class_token):].mean(dim=1)
        else:
            feat = x[:, 0]
        return feat if self.head is None else self.head(feat)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init in module order: LeCun-normal dense and patch kernels
    (the flax default) with zero biases, unit LayerNorm, position and time
    embeddings N(0, 0.02²), a zero class token."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, Conv2d)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                                 generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for name, p in model.named_parameters():
            if name in ("pos_embed", "time_embed"):
                p.normal_(0.0, 0.02, generator=generator)
            elif name == "cls_token":
                p.zero_()
    return model


# name: (patch, dim, depth, heads)
_VIT_DEFS = {
    "vit_tiny_patch16_224": (16, 192, 12, 3),
    "vit_small_patch16_224": (16, 384, 12, 6),
    "vit_base_patch16_224": (16, 768, 12, 12),
    "vit_base_patch16_384": (16, 768, 12, 12),
    "vit_base_patch32_224": (32, 768, 12, 12),
    "vit_large_patch16_224": (16, 1024, 24, 16),
    "vit_large_patch16_384": (16, 1024, 24, 16),
}

default_cfgs: Dict[str, Dict[str, Any]] = {}


def _register():
    for name, (p, dim, depth, heads) in _VIT_DEFS.items():
        size = 384 if name.endswith("_384") else 224
        default_cfgs[name] = _cfg(input_size=(3, size, size))

        def fn(pretrained=False, *, _p=p, _dim=dim, _depth=depth,
               _heads=heads, _name=name, **kwargs):
            kwargs.setdefault("default_cfg", default_cfgs[_name])
            kwargs.setdefault("img_size",
                              kwargs["default_cfg"]["input_size"][1:])
            return VisionTransformer(patch_size=_p, embed_dim=_dim,
                                     depth=_depth, num_heads=_heads, **kwargs)
        fn.__name__ = name
        fn.__qualname__ = name
        fn.__module__ = __name__
        fn.__doc__ = f"{name} (BASELINE.json stretch config)."
        register_model(fn)


_register()

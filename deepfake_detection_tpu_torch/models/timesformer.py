"""TimeSformer: divided space-time attention over frame clips (PyTorch).

Counterpart of ``deepfake_detection_tpu/models/timesformer.py``.  The input
is the pipeline's channel-concat clip, NCHW with ``3·F`` channels (channel
``3·f + rgb`` is colour ``rgb`` of frame ``f``); the model splits the frames
out, embeds each frame's patches with one shared conv, adds a ``(1, 1, n,
C)`` position embedding and a ``(1, F, 1, C)`` time embedding, and runs
blocks of temporal attention (each patch across its F frames, always
dense), spatial attention (the patches of one frame, ``attn_impl`` full or
flash) and an MLP, each pre-LN with stochastic depth.  The logits come from
the mean over frames and patches.  Under a compute dtype the embeddings are
cast to the tokens' dtype before they are added, as in the JAX model.

TimeSformer has no timm counterpart, so the parameter names are the port's
own, after the JAX module names: ``patch_embed.proj``, ``pos_embed``,
``time_embed``, ``blocks.{i}.norm_t``, ``blocks.{i}.attn_t.{qkv,proj}``,
``blocks.{i}.norm_s``, ``blocks.{i}.attn_s.{qkv,proj}``,
``blocks.{i}.norm_mlp``, ``blocks.{i}.mlp.{fc1,fc2}``, ``norm``, ``head``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import torch
import torch.nn as nn

from ..ops.drop import drop_path
from ..ops.linear import Linear
from ..ops.norm import LayerNorm
from ..registry import register_model
from .vit import Attention, Mlp, PatchEmbed, _pair, init_weights

__all__ = ["TimeSformer", "DividedBlock", "init_weights", "default_cfgs"]


def _cfg(**kwargs) -> Dict[str, Any]:
    cfg = dict(num_classes=2, input_size=(12, 224, 224), pool_size=None,
               crop_pct=0.9, interpolation="bicubic",
               mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
               first_conv="patch_embed", classifier="head")
    cfg.update(kwargs)
    return cfg


class DividedBlock(nn.Module):
    """Pre-LN block over ``(B, F, N, C)``: temporal attention → spatial
    attention → MLP."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0, attn_impl: str = "full"):
        super().__init__()
        self.norm_t = LayerNorm(dim, eps=1e-5)
        # F is tiny (4): the dense kernel, one batched matmul
        self.attn_t = Attention(dim, num_heads, attn_impl="full")
        self.norm_s = LayerNorm(dim, eps=1e-5)
        self.attn_s = Attention(dim, num_heads, attn_impl=attn_impl)
        self.norm_mlp = LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.drop_path_rate = drop_path_rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, f, n, c = x.shape
        rate = self.drop_path_rate if self.training else 0.0
        # temporal: each spatial location attends across its F frames
        y = self.norm_t(x).transpose(1, 2).reshape(b * n, f, c)
        y = self.attn_t(y).reshape(b, n, f, c).transpose(1, 2)
        x = x + drop_path(y, rate, generator)
        # spatial: patches attend within their own frame
        y = self.attn_s(self.norm_s(x).reshape(b * f, n, c))
        x = x + drop_path(y.reshape(b, f, n, c), rate, generator)
        return x + drop_path(self.mlp(self.norm_mlp(x)), rate, generator)


class TimeSformer(nn.Module):
    """Divided space-time transformer over channel-concat clips;
    ``in_chans`` must be ``3 · frames``."""

    def __init__(self, img_size: Union[int, Sequence[int]] = 224,
                 patch_size: int = 16, in_chans: int = 12,
                 num_classes: int = 2, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0, attn_impl: str = "full",
                 default_cfg: Optional[dict] = None):
        super().__init__()
        if in_chans % 3:
            raise ValueError(f"in_chans must be 3·frames, got {in_chans}")
        h, w = _pair(img_size)
        self.in_chans = in_chans
        self.frames = in_chans // 3
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads = num_heads
        self.default_cfg = default_cfg
        self.patch_embed = PatchEmbed(3, embed_dim, patch_size)
        n = (h // patch_size) * (w // patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, 1, n, embed_dim))
        self.time_embed = nn.Parameter(
            torch.zeros(1, self.frames, 1, embed_dim))
        self.blocks = nn.ModuleList(
            DividedBlock(embed_dim, num_heads, mlp_ratio,
                         drop_path_rate * i / max(depth - 1, 1), attn_impl)
            for i in range(depth))
        self.norm = LayerNorm(embed_dim, eps=1e-5)
        self.head = Linear(embed_dim, num_classes) \
            if num_classes > 0 else None

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, chans, h, w = x.shape
        if chans != self.in_chans:
            raise ValueError(f"expected {self.in_chans} input channels "
                             f"(NCHW), got {tuple(x.shape)}")
        f = self.frames
        # frames out of the channel axis: channel 3·f + rgb → (B·F, 3, H, W)
        x = x.reshape(b, f, 3, h, w).reshape(b * f, 3, h, w)
        x = self.patch_embed(x)                            # (B·F, N, C)
        n = x.shape[1]
        if n != self.pos_embed.shape[2]:
            raise ValueError(f"{n} patches a frame, but pos_embed was made "
                             f"for {self.pos_embed.shape[2]}: build the "
                             f"model with this input's img_size")
        x = x.reshape(b, f, n, self.embed_dim) + self.pos_embed.to(x.dtype) \
            + self.time_embed.to(x.dtype)
        for block in self.blocks:
            x = block(x, generator)
        feat = self.norm(x).mean(dim=(1, 2))               # frames, patches
        return feat if self.head is None else self.head(feat)


# name: (patch, dim, depth, heads)
_TSF_DEFS = {
    "timesformer_tiny_patch16_224": (16, 192, 12, 3),
    "timesformer_base_patch16_224": (16, 768, 12, 12),
    # flagship 600² clips: 600 = 24·25 → patch 25, 576 tokens a frame
    "timesformer_base_patch25_600": (25, 768, 12, 12),
}

default_cfgs: Dict[str, Dict[str, Any]] = {
    name: _cfg(input_size=(12, int(name.rsplit("_", 1)[-1]),
                           int(name.rsplit("_", 1)[-1])))
    for name in _TSF_DEFS}


def _register():
    for name, (p, dim, depth, heads) in _TSF_DEFS.items():
        size = int(name.rsplit("_", 1)[-1])

        def fn(pretrained=False, *, _p=p, _dim=dim, _depth=depth,
               _heads=heads, _size=size, **kwargs):
            # default_cfg channels track the constructed in_chans
            in_chans = kwargs.get("in_chans", 12)
            kwargs.setdefault("default_cfg",
                              _cfg(input_size=(in_chans, _size, _size)))
            kwargs.setdefault("img_size", _size)
            return TimeSformer(patch_size=_p, embed_dim=_dim, depth=_depth,
                               num_heads=_heads, **kwargs)
        fn.__name__ = name
        fn.__qualname__ = name
        fn.__module__ = __name__
        fn.__doc__ = (f"{name}: divided space-time attention over "
                      f"{name.split('_')[1]}-scale ViT dims.")
        register_model(fn)


_register()

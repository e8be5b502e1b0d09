"""EfficientNet arch-string DSL decoder + stage builder.

Counterpart of ``deepfake_detection_tpu/models/efficientnet_builder.py``
(pure Python, copied so the port imports nothing of the JAX package):
strings like ``ir_r2_k3_s2_e6_c24_se0.25`` decode to block-arg dicts, stage
depths scale with ceil-truncation, and ``build_block_configs`` finalizes
per-block kwargs (channel rounding, stride→dilation for a reduced
``output_stride``, linearly scaled drop_path).
"""

from __future__ import annotations

import math
import re
from copy import deepcopy
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .efficientnet_blocks import round_channels

__all__ = ["decode_arch_def", "build_block_configs", "round_channels"]

_ACT_ABBREV = {
    "re": "relu",
    "r6": "relu6",
    "hs": "hard_swish",
    "sw": "swish",
    "mi": "mish",
}


def _parse_ksize(ss: str):
    """'3' → 3; '3.5.7' → [3, 5, 7] (mixed conv)."""
    if "." in ss:
        return [int(k) for k in ss.split(".")]
    return int(ss)


def _decode_block_str(block_str: str) -> Tuple[Dict[str, Any], int]:
    """One block string → (block kwargs, num_repeat) (builder.py:20-137).

    Grammar: ``<type>_<opts>`` with opts ``r<int>`` repeat, ``k<ks>`` kernel,
    ``s<int>`` stride, ``e<float>`` expansion, ``c<int>`` out chs, ``se<float>``
    SE ratio, ``cc<int>`` condconv experts, ``fc<int>`` fake in-chs (EdgeTPU),
    ``d<int>`` dilation, ``n<act>`` activation override, ``noskip`` flag,
    ``a`` (pw act, 'dsa' type suffix).
    """
    ops = block_str.split("_")
    block_type = ops[0]
    options: Dict[str, str] = {}
    noskip = False
    act: Optional[str] = None
    for op in ops[1:]:
        if op == "noskip":
            noskip = True
        elif op.startswith("n"):
            act = _ACT_ABBREV.get(op[1:], op[1:])
        else:
            splits = re.split(r"(\d.*)", op)
            if len(splits) >= 2:
                options[splits[0]] = splits[1]
    num_repeat = int(options.get("r", 1))
    common = dict(
        pad_type="",
        noskip=noskip,
        stride=int(options.get("s", 1)),
        dilation=int(options.get("d", 1)),
    )
    if act is not None:
        common["act"] = act
    if block_type in ("ir", "ds", "dsa"):
        common["dw_kernel_size"] = _parse_ksize(options.get("k", "3"))
    if "c" in options:
        common["out_chs"] = int(options["c"])
    if "se" in options:
        common["se_ratio"] = float(options["se"])

    if block_type == "ir":
        args = dict(common,
                    block_type="ir",
                    exp_ratio=float(options.get("e", 1.0)),
                    exp_kernel_size=_parse_ksize(options.get("a", "1"))
                    if "a" in options else 1,
                    pw_kernel_size=_parse_ksize(options.get("p", "1"))
                    if "p" in options else 1)
        if "cc" in options:
            args["block_type"] = "cc"
            args["num_experts"] = int(options["cc"])
    elif block_type in ("ds", "dsa"):
        args = dict(common, block_type="ds", pw_act=(block_type == "dsa"))
    elif block_type == "er":
        args = dict(common,
                    block_type="er",
                    exp_kernel_size=int(options.get("k", 3)),
                    exp_ratio=float(options.get("e", 1.0)),
                    fake_in_chs=int(options.get("fc", 0)))
    elif block_type == "cn":
        args = dict(common, block_type="cn",
                    kernel_size=_parse_ksize(options.get("k", "3")))
    else:
        raise ValueError(f"Unknown block type {block_type!r} in {block_str!r}")
    return args, num_repeat


def _scale_stage_depth(stack_args: List[Dict], repeats: List[int],
                       depth_multiplier: float = 1.0,
                       depth_trunc: str = "ceil") -> List[Dict]:
    """Scale a stage's total depth, distributing across its block defs
    back-to-front (builder.py:139-174)."""
    num_repeat = sum(repeats)
    if depth_trunc == "round":
        num_repeat_scaled = max(1, round(num_repeat * depth_multiplier))
    else:
        num_repeat_scaled = int(math.ceil(num_repeat * depth_multiplier))
    repeats_scaled: List[int] = []
    for r in repeats[::-1]:
        rs = max(1, round(r / num_repeat * num_repeat_scaled))
        repeats_scaled.append(rs)
        num_repeat -= r
        num_repeat_scaled -= rs
    repeats_scaled = repeats_scaled[::-1]
    sa_scaled: List[Dict] = []
    for ba, rep in zip(stack_args, repeats_scaled):
        sa_scaled.extend([deepcopy(ba) for _ in range(rep)])
    return sa_scaled


def decode_arch_def(arch_def: Sequence[Sequence[str]],
                    depth_multiplier: float = 1.0,
                    depth_trunc: str = "ceil",
                    experts_multiplier: int = 1,
                    fix_first_last: bool = False) -> List[List[Dict]]:
    """Arch-def (list of stage string-lists) → per-stage block-kwargs lists
    (builder.py:177-191).  ``fix_first_last`` exempts stem/tail stages from
    depth scaling (MobileNetV3 behavior)."""
    arch_args: List[List[Dict]] = []
    for stack_idx, block_strings in enumerate(arch_def):
        stack_args: List[Dict] = []
        repeats: List[int] = []
        for block_str in block_strings:
            ba, rep = _decode_block_str(block_str)
            if ba.get("num_experts", 0) > 0 and experts_multiplier > 1:
                ba["num_experts"] *= experts_multiplier
            stack_args.append(ba)
            repeats.append(rep)
        if fix_first_last and (stack_idx == 0 or stack_idx == len(arch_def) - 1):
            arch_args.append(_scale_stage_depth(stack_args, repeats, 1.0, depth_trunc))
        else:
            arch_args.append(_scale_stage_depth(stack_args, repeats,
                                                depth_multiplier, depth_trunc))
    return arch_args


def build_block_configs(block_args: List[List[Dict]],
                        channel_multiplier: float = 1.0,
                        channel_divisor: int = 8,
                        channel_min: Optional[int] = None,
                        output_stride: int = 32,
                        drop_path_rate: float = 0.0,
                        default_act: Any = "relu",
                        ) -> List[List[Dict]]:
    """Finalize per-block kwargs: channel rounding, stride→dilation conversion
    for ``output_stride`` (builder.py:330-339), per-block linearly-scaled
    drop_path (builder.py:229), repeat-stride semantics (only the first block
    of a stage strides)."""
    total_blocks = sum(len(s) for s in block_args)
    out: List[List[Dict]] = []
    block_idx = 0
    current_stride = 2  # after stem
    current_dilation = 1
    for stage in block_args:
        stage_out: List[Dict] = []
        for i, ba in enumerate(stage):
            ba = deepcopy(ba)
            if "out_chs" in ba:
                ba["out_chs"] = round_channels(ba["out_chs"], channel_multiplier,
                                               channel_divisor, channel_min)
            if "fake_in_chs" in ba and ba["fake_in_chs"]:
                ba["fake_in_chs"] = round_channels(ba["fake_in_chs"],
                                                   channel_multiplier,
                                                   channel_divisor, channel_min)
            stride = ba.get("stride", 1) if i == 0 else 1
            next_dilation = current_dilation
            if stride > 1:
                next_stride = current_stride * stride
                if next_stride > output_stride:
                    # absorb stride into dilation to hold output_stride; the
                    # striding block itself keeps the old dilation
                    next_dilation = current_dilation * stride
                    stride = 1
                else:
                    current_stride = next_stride
            ba["stride"] = stride
            ba["dilation"] = current_dilation
            current_dilation = next_dilation
            ba.setdefault("act", default_act)
            ba["drop_path_rate"] = drop_path_rate * block_idx / total_blocks
            stage_out.append(ba)
            block_idx += 1
        out.append(stage_out)
    return out

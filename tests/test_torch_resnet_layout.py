"""PyTorch port, the parameter layout of all 85 names of the ResNet-derived
families and SENet against the JAX package on CPU.

Each name is built in both packages: the port's module at full depth on
the ``meta`` device (no memory), the JAX tree by ``jax.eval_shape`` of
``init``.  The JAX tree goes through the bridge's own name and layout rules
(:func:`convert._map_resnet`, :func:`convert._to_torch_layout` on
zero-stride arrays); the port's state dict must have exactly those names
and shapes, BN counters included.

A JAX trace costs ~1 s a 50-layer net (flax's module overhead), and the
five modules hold 54 distinct trees, so the JAX module is traced with at
most two blocks a stage (``.clone(layers=...)``): a stage's blocks after
its first are built from the same arguments (the JAX ``ResNet`` and
``SENet`` loops change only the first block's stride, shortcut and
dilation), so block 1's names and shapes stand for every later block's,
and the expected layout repeats them to the name's full depth.  Names
whose cut JAX modules differ only in fields that leave the tree alone (the
tv_/ssl_/swsl_/ig_ twins, the depths, the avg-down shortcut, drop rates,
BN arguments, the default config) share one trace; each port module is
built and compared on its own, with its own avg-down naming.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfake_detection_tpu.models import create_model as j_create_model
from deepfake_detection_tpu.registry import list_models as j_list_models
from deepfake_detection_tpu_torch import convert, models  # noqa: F401
from deepfake_detection_tpu_torch.registry import model_entrypoint

MODULES = ("resnet", "gluon_resnet", "res2net", "sknet", "senet")

# fields that leave the parameter tree alone
_NOT_IN_TREE = {"avg_down", "default_cfg", "drop_rate", "drop_path_rate",
                "drop_block_rate", "zero_init_last_bn", "bn_momentum",
                "bn_eps", "bn_axis_name", "dtype", "parent", "name"}


def _cut(jm):
    return jm.clone(layers=tuple(min(n, 2) for n in jm.layers))


def _full_depth(cut_layout, layers):
    """The cut layout with block 1 of each stage repeated to ``layers``."""
    out = dict(cut_layout)
    for s, n in enumerate(layers, start=1):
        one = f"layer{s}.1."
        for k, v in cut_layout.items():
            if k.startswith(one):
                for b in range(2, n):
                    out[f"layer{s}.{b}." + k[len(one):]] = v
    return out


def _tree_key(jm):
    return tuple(sorted((f.name, repr(getattr(jm, f.name)))
                        for f in dataclasses.fields(jm)
                        if f.name not in _NOT_IN_TREE))


def _port_layout_from_jax(shapes, avg_down):
    trees = [shapes.get(c, {}) for c in ("params", "batch_stats")]
    paths = [p for tree in trees for p in convert._flatten(tree)]
    senet = any("se_module" in p or "downsample_bn" in p for p in paths)
    sk = any("path_0_conv" in p for p in paths)
    out = {}
    for tree in trees:
        for parts, leaf in convert._flatten(tree).items():
            name, is_bn = convert._map_resnet(parts, senet, sk, avg_down)
            arr = np.broadcast_to(np.float32(0), leaf.shape)
            out[name] = tuple(convert._to_torch_layout(arr).shape)
            if is_bn:
                out[name.rsplit(".", 1)[0] + ".num_batches_tracked"] = ()
    return out


_TRACED = {}


@pytest.mark.parametrize("module", MODULES)
def test_every_layout_matches_jax(module):
    names = j_list_models(module=module)
    for name in names:
        jm = j_create_model(name, num_classes=2, in_chans=12)
        cut = _cut(jm)
        key = _tree_key(cut)
        if key not in _TRACED:
            _TRACED[key] = jax.eval_shape(
                lambda r, jm=cut: jm.init({"params": r, "dropout": r},
                                          jnp.zeros((1, 32, 32, 12)),
                                          training=False),
                jax.random.PRNGKey(0))
        want = _full_depth(_port_layout_from_jax(
            _TRACED[key], bool(getattr(jm, "avg_down", False))), jm.layers)
        with torch.device("meta"):
            model = model_entrypoint(name)(num_classes=2, in_chans=12)
        got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert got == want, (name, sorted(set(got) ^ set(want))[:6])

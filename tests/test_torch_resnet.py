"""PyTorch port, the ResNet-derived families' ops and registry against the
JAX package on CPU: the registry and ``default_cfg`` of each of the five
modules (resnet, gluon_resnet, res2net, sknet, senet), the torch-windowed
pools, SE / ECA / CECA / CBAM / light CBAM and the SK conv alone (within
1e-5 of the output's scale), DropBlock from JAX's own seed mask (within
1e-6, f32; bitwise in bf16, where both sum the kept map in f32 and round
the count to bf16), a seeded port draw reproducible from its
``torch.Generator``, where DropBlock sits in the blocks, and the factory's
``drop_block_rate`` rule.

Modules alone take their weights from the JAX module's init, through the
bridge (:func:`convert.state_dict_from_flax`, the module placed at a
block's ``se`` or ``conv1`` slot of a ResNet tree).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfake_detection_tpu.models import create_model as j_create_model
from deepfake_detection_tpu.ops import attention as j_attn
from deepfake_detection_tpu.ops import drop as j_drop
from deepfake_detection_tpu.ops import pool as j_pool
from deepfake_detection_tpu.registry import list_models as j_list_models
from deepfake_detection_tpu_torch.convert import state_dict_from_flax
from deepfake_detection_tpu_torch.models import create_model
from deepfake_detection_tpu_torch.models import factory as t_factory
from deepfake_detection_tpu_torch.ops import attention as t_attn
from deepfake_detection_tpu_torch.ops import drop as t_drop
from deepfake_detection_tpu_torch.ops import pool as t_pool
from deepfake_detection_tpu_torch.ops.drop import DropBlock2d
from deepfake_detection_tpu_torch.registry import list_models

torch.set_num_threads(2)

MODULES = ("resnet", "gluon_resnet", "res2net", "sknet", "senet")


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _scale_close(got, want, rel=1e-5):
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), err


# ---------------------------------------------------------------------------
# the registry and default_cfg
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", MODULES)
def test_registry_and_default_cfg_match_jax(module):
    names = list_models(module=module)
    assert names == j_list_models(module=module)
    for name in names:
        assert t_factory.default_cfg(name) == \
            j_create_model(name).default_cfg, name


def test_make_divisible_matches_jax():
    for v in range(1, 300, 7):
        for d in (4, 8):
            assert t_attn.make_divisible(v, d) == \
                j_attn.make_divisible(v, d), (v, d)


def test_eighty_five_names():
    assert sum(len(list_models(module=m)) for m in MODULES) == 85


# ---------------------------------------------------------------------------
# the pools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(36, 36), (37, 35), (9, 8), (5, 5)])
@pytest.mark.parametrize("ceil", [False, True])
def test_max_pool2d_torch_matches_jax(hw, ceil):
    """The ResNet stem's pool (3, 2, pad 1) and SENet's ceil-mode one (3,
    2, no pad): at 36 SENet's gives 18, not 17."""
    x = np.random.default_rng(hw[0]).standard_normal(
        (2,) + hw + (5,)).astype(np.float32)
    pad = 0 if ceil else 1
    want = np.asarray(j_pool.max_pool2d_torch(jnp.asarray(x), (3, 3), (2, 2),
                                              padding=pad, ceil_mode=ceil))
    got = _nhwc(t_pool.max_pool2d_torch(_nchw(x), 3, 2, pad, ceil))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if ceil and hw == (36, 36):
        assert got.shape[1:3] == (18, 18)


@pytest.mark.parametrize("hw,stride", [((10, 10), 2), ((11, 9), 2),
                                       ((7, 8), 1)])
@pytest.mark.parametrize("include", [True, False])
def test_avg_pools_match_jax(hw, stride, include):
    """res2net's ``AvgPool2d(3, stride, padding=1)`` and the avg-down
    shortcut's TF SAME 2×2 pool (pads (0, 1) at an odd map), each with and
    without the pads in the divisor."""
    x = np.random.default_rng(sum(hw)).standard_normal(
        (2,) + hw + (4,)).astype(np.float32)
    want = np.asarray(j_pool.avg_pool2d_torch(
        jnp.asarray(x), (3, 3), (stride, stride), padding=1,
        count_include_pad=include))
    got = _nhwc(t_pool.avg_pool2d_torch(_nchw(x), 3, stride, 1, include))
    _scale_close(got, want)
    want = np.asarray(j_pool.avg_pool2d_same(
        jnp.asarray(x), (2, 2), (stride, stride), count_include_pad=include))
    got = _nhwc(t_pool.avg_pool2d_same(_nchw(x), 2, stride, include))
    assert got.shape == want.shape
    _scale_close(got, want)


# ---------------------------------------------------------------------------
# attention modules alone
# ---------------------------------------------------------------------------

def _bridged(variables, slot):
    """The port's state dict of a module whose JAX variables sit at a
    block's ``slot`` (``se`` or ``conv1``)."""
    tree = {c: {"layer1_0": {slot: v}} for c, v in variables.items()}
    prefix = f"layer1.0.{slot}."
    return {k[len(prefix):]: v
            for k, v in state_dict_from_flax(tree).items()}


def _perturbed(variables, rng):
    """The JAX init with every BN leaf and bias made non-trivial."""
    def leaf(path, a):
        names = [getattr(p, "key", "") for p in path]
        a = np.asarray(a, np.float32)
        if names[-1] == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if names[-1] in ("mean", "bias") or (names[-1] == "scale"):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(
                np.float32)
        return a
    return jax.tree_util.tree_map_with_path(leaf, variables)


ATTN_CASES = [
    ("se", lambda: j_attn.SEModule(), lambda c: t_attn.SEModule(c), 64),
    ("eca", lambda: j_attn.EcaModule(), lambda c: t_attn.EcaModule(c), 256),
    ("eca_k3", lambda: j_attn.EcaModule(), lambda c: t_attn.EcaModule(c),
     24),
    ("ceca", lambda: j_attn.CecaModule(), lambda c: t_attn.CecaModule(c),
     256),
    ("cbam", lambda: j_attn.CbamModule(), lambda c: t_attn.CbamModule(c),
     64),
    ("lcbam", lambda: j_attn.LightCbamModule(),
     lambda c: t_attn.LightCbamModule(c), 64),
]


@pytest.mark.parametrize("name,jm,tm,chs", ATTN_CASES,
                         ids=[c[0] for c in ATTN_CASES])
def test_attention_modules_match_jax(name, jm, tm, chs):
    rng = np.random.default_rng(chs)
    x = rng.standard_normal((2, 7, 6, chs)).astype(np.float32)
    j = jm()
    v = _perturbed(j.init(jax.random.PRNGKey(1), jnp.asarray(x)), rng)
    want = np.asarray(j.apply(v, jnp.asarray(x)))
    t = tm(chs)
    t.load_state_dict(_bridged(v, "se"), strict=True)
    with torch.no_grad():
        got = _nhwc(t(_nchw(x)))
    _scale_close(got, want)
    # the same module through create_attn
    assert type(t_attn.create_attn(name.split("_")[0], chs)) is type(t)


SK_CASES = [dict(in_chs=16, out_chs=32, stride=1),
            dict(in_chs=16, out_chs=32, stride=2, split_input=True,
                 attn_reduction=8, min_attn_channels=16),
            dict(in_chs=32, out_chs=64, stride=2, groups=8, dilation=1),
            dict(in_chs=24, out_chs=24, kernel_size=(3, 5, 7),
                 keep_3x3=False)]


@pytest.mark.parametrize("kw", SK_CASES)
@pytest.mark.parametrize("training", [False, True])
def test_selective_kernel_conv_matches_jax(kw, training):
    """Eval with perturbed statistics, and train mode (batch statistics
    and their running update).  Each sample of the batch has its own scale
    and offset: the attention's train-mode BN normalizes one pooled
    descriptor a sample, and over i.i.d. noise samples those are nearly
    equal, so E[x²] - E[x]² cancels to ~1e-4 of the output in f32 in
    either package (as the port's BN, the statistics stay f32 whatever
    the input's dtype)."""
    kw = dict(kw)
    in_chs = kw.pop("in_chs")
    rng = np.random.default_rng(in_chs + kw["out_chs"])
    x = (rng.standard_normal((3, 9, 10, in_chs))
         * np.array([0.5, 1.0, 2.0])[:, None, None, None]
         + np.array([-1.0, 0.0, 1.0])[:, None, None, None]).astype(
             np.float32)
    j = j_attn.SelectiveKernelConv(**kw)
    v = _perturbed(j.init(jax.random.PRNGKey(2), jnp.asarray(x)), rng)
    t = t_attn.SelectiveKernelConv(in_chs, **kw)
    t.load_state_dict(_bridged(v, "conv1"), strict=True)
    t.train(training)
    with torch.no_grad():
        got = _nhwc(t(_nchw(x)))
    if not training:
        _scale_close(got, np.asarray(j.apply(v, jnp.asarray(x))))
        return
    want, upd = j.apply(v, jnp.asarray(x), training=True,
                        mutable=["batch_stats"])
    _scale_close(got, np.asarray(want))
    stats = _bridged({"batch_stats": upd["batch_stats"]}, "conv1")
    own = t.state_dict()
    for k, w in stats.items():
        if k.endswith(("running_mean", "running_var")):
            g = own[k].numpy()
            assert np.abs(g - w.numpy()).max() <= \
                1e-5 * np.abs(w.numpy()).max(), k


# ---------------------------------------------------------------------------
# DropBlock
# ---------------------------------------------------------------------------

DB_CASES = [((2, 9, 9, 5), 6, 1.0),       # clipped 6: even, pads (2, 3)
            ((2, 14, 12, 6), 7, 0.25),    # clipped 7: odd
            ((3, 5, 6, 3), 7, 1.0),       # clipped to the map's 5
            ((1, 16, 16, 8), 4, 1.0)]     # clipped 4


@pytest.mark.parametrize("shape,block,gamma_scale", DB_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_drop_block_from_jax_seeds_matches_jax(shape, block, gamma_scale,
                                               dtype):
    """JAX's ``drop_block_2d`` against the port fed the seed mask JAX draws
    (``bernoulli(split(rng)[0], gamma, (B, H, W, C))``)."""
    drop_prob = 0.5
    rng = jax.random.PRNGKey(sum(shape) + block)
    x = np.random.default_rng(block).standard_normal(shape).astype(
        np.float32)
    jdt = jnp.dtype(dtype)
    want = np.asarray(j_drop.drop_block_2d(
        jnp.asarray(x, jdt), rng, drop_prob, block, gamma_scale)
        .astype(jnp.float32))
    _, gamma = t_drop.drop_block_gamma(shape[1], shape[2], drop_prob, block,
                                       gamma_scale)
    seeds = np.asarray(jax.random.bernoulli(jax.random.split(rng)[0], gamma,
                                            shape))
    assert seeds.any()
    tdt = getattr(torch, dtype)
    got = t_drop.drop_block_from_seeds(_nchw(x).to(tdt), _nchw(seeds),
                                       block)
    assert got.dtype == tdt
    got = _nhwc(got.float())
    assert (got == 0).any() and (got != 0).any()
    if dtype == "float32":
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    else:
        np.testing.assert_array_equal(got, want)


def test_drop_block_draw_is_reproducible_from_its_generator():
    x = torch.randn(2, 4, 19, 19)
    draw = [t_drop.drop_block_2d(x, 0.2, 7, 1.0,
                                 generator=torch.Generator().manual_seed(s))
            for s in (3, 3, 4)]
    assert torch.equal(draw[0], draw[1])
    assert not torch.equal(draw[0], draw[2])
    with pytest.raises(ValueError, match="torch.Generator"):
        t_drop.drop_block_2d(x, 0.2)
    noisy = t_drop.drop_block_2d(x, 0.2, 7, 1.0, with_noise=True,
                                 generator=torch.Generator().manual_seed(3))
    kept = draw[0] != 0
    assert torch.equal(noisy[kept], x[kept]) and (noisy[~kept] != 0).all()
    block = DropBlock2d(0.2, 7)
    assert block.eval()(x) is x
    assert torch.equal(block.train()(x, torch.Generator().manual_seed(3)),
                       draw[0])


def test_drop_block_sits_in_layers_three_and_four():
    """As the JAX ResNet: every block of layers 3–4 takes DropBlocks (gamma
    scale 0.25 on layer 3, 1.0 on layer 4), none before; res2net's and the
    SK blocks take none."""
    model = create_model("resnet50d", drop_block_rate=0.1, device="cpu")
    for li, gamma in ((1, None), (2, None), (3, 0.25), (4, 1.0)):
        for block in getattr(model, f"layer{li}"):
            dbs = [getattr(block, f"db{i}") for i in (1, 2, 3)]
            if gamma is None:
                assert dbs == [None] * 3
            else:
                assert [(d.drop_prob, d.block_size, d.gamma_scale)
                        for d in dbs] == [(0.1, 7, gamma)] * 3
    basic = create_model("resnet18", drop_block_rate=0.1, device="cpu")
    assert basic.layer3[0].db2.gamma_scale == 0.25
    for name in ("res2net50_26w_4s", "skresnet18"):
        model = create_model(name, drop_block_rate=0.1, device="cpu")
        assert not any(isinstance(m, DropBlock2d) for m in model.modules())


def test_drop_block_rate_reaches_the_families_and_warns_elsewhere(caplog):
    """The factory's rule, as the JAX one: ``drop_block_rate`` reaches the
    resnet, gluon_resnet, res2net and sknet families and is dropped with
    the JAX warning for every other (senet among them); ``bn_eps`` is
    dropped for all five."""
    caplog.set_level(logging.WARNING)
    for name in ("resnet26d", "gluon_resnet18_v1b", "seresnet18"):
        jm = j_create_model(name, drop_block_rate=0.1, bn_eps=1e-3)
        tm = create_model(name, drop_block_rate=0.1, bn_eps=1e-3,
                          device="cpu")
        dbs = [m for m in tm.modules() if isinstance(m, DropBlock2d)]
        assert bool(dbs) == (getattr(jm, "drop_block_rate", 0.0) == 0.1)
        assert getattr(jm, "bn_eps") == 1e-5
        assert {m.eps for m in tm.modules() if hasattr(m, "eps")} == {1e-5}
    msgs = [r.getMessage() for r in caplog.records
            if "drop_block_rate" in r.getMessage()]
    assert len(msgs) == 2 and msgs[0] == msgs[1] and "seresnet18" in msgs[0]

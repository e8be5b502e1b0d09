"""PyTorch port, ops layer: each op against the JAX package's op on CPU.

The same seeded numpy inputs go through ``deepfake_detection_tpu.ops`` and
``deepfake_detection_tpu_torch.ops``; f32, ≤ 1e-5 absolute at unit-scale
inputs.  The port's ``fused_depthwise`` on a CPU tensor is its plain
version, held against the XLA composition of the same function
(grouped ``lax.conv_general_dilated`` + affine + act), which is also the
reference ``tests/test_depthwise_pallas.py`` holds the Pallas kernel to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import deepfake_detection_tpu.ops as jops
from deepfake_detection_tpu.models import efficientnet_blocks as jblocks
from deepfake_detection_tpu_torch import ops as tops
from deepfake_detection_tpu_torch.models import efficientnet_blocks as tblocks

torch.set_num_threads(2)

ATOL = 1e-5


def _nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy → NCHW tensor view in channels_last memory (no copy)."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("padding,k,d,s", [
    ("", 3, 1, 1), ("", 3, 1, 2), ("", 5, 1, 2), ("", (3, 5), 2, (2, 1)),
    ("same", 3, 1, 2), ("valid", 5, 1, 1), (2, 3, 1, 1)])
def test_resolve_padding_matches_jax(padding, k, d, s):
    assert tops.resolve_padding(padding, k, d, s) == \
        jops.resolve_padding(padding, k, d, s)


@pytest.mark.parametrize("n", [15, 16])
@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_conv2d_matches_jax(k, s, n):
    rng = np.random.default_rng(100 * k + 10 * s + n)
    x = rng.standard_normal((2, n, n, 6)).astype(np.float32)
    w = (rng.standard_normal((k, k, 6, 8)) * 0.1).astype(np.float32)
    ref = jops.Conv2d(8, k, stride=s, padding="").apply(
        {"params": {"conv": {"kernel": jnp.asarray(w)}}}, jnp.asarray(x))
    conv = tops.Conv2d(6, 8, k, stride=s, padding="")
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        got = _nhwc(conv(_nchw(x)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("padding", ["", "same"])
def test_depthwise_conv2d_matches_jax(padding):
    """``create_conv2d(depthwise=True)`` and TF SAME (asymmetric at even
    input + stride 2)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 1, 8)) * 0.3).astype(np.float32)
    ref = jops.create_conv2d(8, 3, stride=2, padding=padding,
                             depthwise=True).apply(
        {"params": {"conv": {"kernel": jnp.asarray(w)}}}, jnp.asarray(x))
    conv = tops.create_conv2d(8, 8, 3, stride=2, padding=padding,
                              depthwise=True)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        got = _nhwc(conv(_nchw(x)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=ATOL)


def _bn_vars(rng, c):
    return {"params": {"bn": {
                "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": rng.uniform(-0.5, 0.5, c).astype(np.float32)}},
            "batch_stats": {"bn": {
                "mean": rng.uniform(-0.5, 0.5, c).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}}}


def _load_bn(bn: tops.BatchNorm2d, v) -> None:
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(v["params"]["bn"]["scale"]))
        bn.bias.copy_(torch.from_numpy(v["params"]["bn"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(v["batch_stats"]["bn"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(v["batch_stats"]["bn"]["var"]))


def test_batchnorm_eval_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 7, 16)).astype(np.float32)
    v = _bn_vars(rng, 16)
    ref = jops.BatchNorm2d().apply(v, jnp.asarray(x), training=False)
    bn = tops.BatchNorm2d(16).eval()
    _load_bn(bn, v)
    with torch.no_grad():
        got = _nhwc(bn(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=ATOL)


def test_batchnorm_train_matches_flax_stats_and_update():
    """Train mode: batch statistics with the BIASED variance and flax's
    running update (torch-convention momentum 0.3 → flax 0.7)."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((4, 6, 5, 16)) * 2 + 1).astype(np.float32)
    v = _bn_vars(rng, 16)
    ref, upd = jops.BatchNorm2d(momentum=0.3).apply(
        v, jnp.asarray(x), training=True, mutable=["batch_stats"])
    bn = tops.BatchNorm2d(16, momentum=0.3).train()
    _load_bn(bn, v)
    with torch.no_grad():
        got = _nhwc(bn(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=ATOL)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["bn"]["mean"]),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["bn"]["var"]),
                               rtol=0, atol=ATOL)
    assert int(bn.num_batches_tracked) == 1


@pytest.mark.parametrize("name", sorted(k for k in jops.ACT_FNS if k))
def test_activation_matches_jax(name):
    x = np.linspace(-6, 6, 97, dtype=np.float32)
    ref = np.asarray(jops.get_act_fn(name)(jnp.asarray(x)))
    got = tops.get_act_fn(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("pool_type", ["avg", "max", "avgmax", "catavgmax"])
def test_select_adaptive_pool_matches_jax(pool_type):
    x = np.random.default_rng(5).standard_normal((2, 7, 6, 10)).astype(
        np.float32)
    ref = jops.SelectAdaptivePool2d(pool_type).apply({}, jnp.asarray(x))
    pool = tops.SelectAdaptivePool2d(pool_type)
    got = pool(_nchw(x)).numpy()
    assert pool.feat_mult() == jops.adaptive_pool_feat_mult(pool_type)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=ATOL)


def test_squeeze_excite_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 6, 6, 32)).astype(np.float32)
    jse = jblocks.SqueezeExcite(0.25, reduced_base_chs=16, act="swish")
    v = jse.init(jax.random.PRNGKey(0), jnp.asarray(x))
    p = jax.tree.map(np.array, v["params"])
    for name in ("conv_reduce", "conv_expand"):     # non-zero biases
        p[name]["conv"]["bias"] = rng.uniform(
            -0.5, 0.5, p[name]["conv"]["bias"].shape).astype(np.float32)
    ref = jse.apply({"params": p}, jnp.asarray(x))
    tse = tblocks.SqueezeExcite(32, 0.25, reduced_base_chs=16, act="swish")
    with torch.no_grad():
        for name in ("conv_reduce", "conv_expand"):
            conv = getattr(tse, name)
            conv.weight.copy_(torch.from_numpy(
                p[name]["conv"]["kernel"].transpose(3, 2, 0, 1)))
            conv.bias.copy_(torch.from_numpy(p[name]["conv"]["bias"]))
        got = _nhwc(tse(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=ATOL)


def test_drop_path_identity_in_eval_and_seeded_in_train():
    x = torch.ones(8, 3, 2, 2)
    dp = tops.DropPath(0.5).eval()
    assert dp(x) is x
    dp.train()
    a = dp(x, torch.Generator().manual_seed(1))
    b = dp(x, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    per_sample = a.flatten(1)
    assert set(per_sample.unique().tolist()) <= {0.0, 2.0}
    assert (per_sample == per_sample[:, :1]).all()
    with pytest.raises(ValueError, match="Generator"):
        dp(x)


# ---------------------------------------------------------------------------
# fused depthwise: the port's op (plain version on CPU) vs the XLA composition
# ---------------------------------------------------------------------------

_JACTS = {"none": lambda u: u, "relu": lambda u: jnp.maximum(u, 0.0),
          "silu": jax.nn.silu}


def _xla_composition(x, w, scale, bias, stride, pad, act):
    k, c = w.shape[0], w.shape[-1]
    t, b, l, r = tops.explicit_padding(pad, (k, k), 1, stride, x.shape[1],
                                       x.shape[2])
    z = lax.conv_general_dilated(
        jnp.asarray(x, jnp.float32), jnp.asarray(w).reshape(k, k, 1, c),
        (stride, stride), [(t, b), (l, r)], feature_group_count=c,
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    u = z * scale + bias
    return np.asarray(_JACTS[act](u).astype(x.dtype))


@pytest.mark.parametrize("shape", [(2, 13, 11, 13), (2, 16, 16, 24)])
@pytest.mark.parametrize("act", ["none", "silu", "relu"])
@pytest.mark.parametrize("pad", ["", "same", 1])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [3, 5])
def test_fused_depthwise_matches_xla(k, stride, pad, act, shape):
    """Odd H/W and C = 13 in the first shape; ''/'same' differ at the
    second's even size with stride 2."""
    rng = np.random.default_rng(k * 1000 + stride * 100 + shape[1])
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((k, k, c)) * 0.2).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.uniform(-0.2, 0.2, c).astype(np.float32)
    ref = _xla_composition(x, w, scale, bias, stride, pad, act)
    got = tops.fused_depthwise(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(scale),
                               torch.from_numpy(bias), stride=stride,
                               padding=pad, act=act).numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_fused_depthwise_identity_affine_and_hwio_kernel():
    """scale/bias None mean identity; an HWIO (k, k, 1, C) kernel is taken
    as (k, k, C)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 9, 10, 8)).astype(np.float32)
    w = (rng.standard_normal((5, 5, 1, 8)) * 0.2).astype(np.float32)
    ref = _xla_composition(x, w.reshape(5, 5, 8), np.float32(1.0),
                           np.float32(0.0), 2, "same", "none")
    got = tops.fused_depthwise(torch.from_numpy(x), torch.from_numpy(w),
                               stride=2, padding="same", act="none").numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_fused_depthwise_bf16_input_matches_xla():
    """bf16 in and out, f32 accumulation: the two agree up to one bf16
    rounding of the output (2^-8 relative)."""
    rng = np.random.default_rng(12)
    x32 = rng.standard_normal((2, 9, 9, 16)).astype(np.float32)
    xb = torch.from_numpy(x32).to(torch.bfloat16)
    w = (rng.standard_normal((3, 3, 16)) * 0.2).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.uniform(-0.2, 0.2, 16).astype(np.float32)
    ref = _xla_composition(jnp.asarray(xb.float().numpy(), jnp.bfloat16), w,
                           scale, bias, 1, "", "silu").astype(np.float32)
    got = tops.fused_depthwise(xb, torch.from_numpy(w),
                               torch.from_numpy(scale),
                               torch.from_numpy(bias)).float().numpy()
    assert tops.fused_depthwise(xb, torch.from_numpy(w)).dtype == \
        torch.bfloat16
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -7, atol=2.0 ** -9)


def test_fused_depthwise_cpu_does_not_count_launches():
    before = tops.fused_depthwise.launches
    tops.fused_depthwise(torch.zeros(1, 4, 4, 4), torch.zeros(3, 3, 4))
    assert tops.fused_depthwise.launches == before


def test_fused_depthwise_rejects_unknown_act():
    with pytest.raises(ValueError, match="act"):
        tops.fused_depthwise(torch.zeros(1, 4, 4, 4), torch.zeros(3, 3, 4),
                             act="gelu")

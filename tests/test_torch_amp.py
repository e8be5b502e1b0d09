"""PyTorch port, the bf16 compute policy on CPU against the JAX package.

The JAX runner computes in bf16 (``--amp``, or its default
``--compute-dtype bfloat16``): flax's ``dtype=`` on every module, f32
parameters.  The port follows the same cast points
(``models.helpers.set_compute_dtype``, ``ops.conv.cast_compute``); these
tests hold it against the JAX package, module by module and as a whole:

* the prologue's bf16 normalize, bitwise against the JAX loader's compiled
  expression, and a bf16 batch of each loader from one clip tree;
* Conv2d, BatchNorm (train and eval), LayerNorm and SqueezeExcite;
* an InvertedResidual block, whose depthwise stage is the fused op (train
  and eval), against the JAX block's XLA composition (``fused_depthwise
  ="off"``: the Pallas depthwise cannot be traced by this jax);
* the dw gradient of a bf16 input equals that of the input widened to f32
  (the widening is exact; the JAX backward widens first);
* the reduced flagship's eval logits and 1 and 3 train steps
  (``make_train_step`` of both packages), and the reduced TimeSformer with
  flash attention (the JAX kernels in interpret mode), the same;
* no bf16 tensor enters the optimizer, EMA or guard state.

Tolerance method.  bf16 against bf16 across two backends is not bitwise:
the packages round at different points (XLA fuses elementwise chains and
keeps them in f32, the port rounds after each op that outputs bf16; the
port's depthwise kernel reads f32 weights where XLA's conv rounds them to
bf16).  So every quantity is also computed in f32 from the same weights
(the JAX package, which the f32 tests hold the port to at 1e-5 / 1e-4),
and two bounds hold.  For a module's output, with ``scale`` the f32
output's max |·|:

* ``max|port_bf16 − f32| ≤ 2·max|jax_bf16 − f32| + 2⁻⁸·scale``: the port
  is no further from f32 than twice the JAX package's own bf16 error;
* ``max|port_bf16 − jax_bf16| ≤ DIRECT·scale``, with the DIRECT bound of
  each quantity beside its measured value in ``DIRECT`` below.

For a whole model (logits, the per-step losses, the update of all
parameters), each quantity is one vector and ``|·|`` its 2-norm, ``scale``
the f32 quantity's norm.  A fresh model's bf16 step is noisy: each
package's flagship update is about 6–10% of its norm off the f32 update,
and its worst leaf over 50% (the same in both packages), so two more
bounds make the holds able to fail:

* ``|port_bf16 − f32| ≥ ¼·|jax_bf16 − f32|``: the port computed in bf16
  (an f32 port is 1e-5 off f32; measured ≥ 0.49 of the JAX error);
* every parameter's own update points where the f32 update points and has
  its size: cosine and norm ratio within ``LEAF`` (twice the measured
  deviation), and a parameter whose f32 update is zero (a BN bias in
  front of a training-mode BN, whose gradient cancels) moves by no more
  than 2⁻⁸ of the largest update.

``test_model_holds_reject_a_planted_fault`` checks that an unchanged state
and the f32 step in the bf16 step's place both fail them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfake_detection_tpu import config as j_config
from deepfake_detection_tpu import losses as j_losses
from deepfake_detection_tpu.data import loader as j_loader
from deepfake_detection_tpu.data import mixup as j_mixup
from deepfake_detection_tpu.models import create_model as j_create_model
from deepfake_detection_tpu.models import init_model as j_init_model
from deepfake_detection_tpu.models import efficientnet_blocks as j_blocks
from deepfake_detection_tpu.models.timesformer import (
    TimeSformer as JTimeSformer)
from deepfake_detection_tpu.ops import conv as j_conv
from deepfake_detection_tpu.ops import norm as j_norm
from deepfake_detection_tpu.optim import create_optimizer as j_create_opt
from deepfake_detection_tpu.runners import train as j_runner
from deepfake_detection_tpu.train import create_train_state as j_state
from deepfake_detection_tpu.train import make_train_step as j_make_step
from deepfake_detection_tpu_torch import losses as t_losses
from deepfake_detection_tpu_torch.convert import state_dict_from_flax
from deepfake_detection_tpu_torch.data.loader import Prologue
from deepfake_detection_tpu_torch.models import (TimeSformer, create_model,
                                                 init_model)
from deepfake_detection_tpu_torch.models import efficientnet_blocks as blocks
from deepfake_detection_tpu_torch.models.helpers import set_compute_dtype
from deepfake_detection_tpu_torch.ops import depthwise as dw
from deepfake_detection_tpu_torch.ops.conv import Conv2d
from deepfake_detection_tpu_torch.ops.norm import BatchNorm2d, LayerNorm
from deepfake_detection_tpu_torch.optim import create_optimizer
from deepfake_detection_tpu_torch.runners import train as runner
from deepfake_detection_tpu_torch.train.state import create_train_state
from deepfake_detection_tpu_torch.train.steps import make_train_step
from test_torch_data import make_clip_tree

torch.set_num_threads(2)

BF16 = torch.bfloat16
SLACK = 2.0 ** -8
# DIRECT bound on max|port_bf16 - jax_bf16| / scale, per quantity: about
# twice the value measured on this CPU (beside it), and one bf16 rounding
# (2^-8) where the two packages agreed bitwise
DIRECT = {
    "conv": 2.0 ** -8,          # measured 0 (one f32 accumulation, one
    "bn_eval": 2.0 ** -8,       # measured 0      rounding, in both)
    "bn_train": 2.0 ** -8,      # measured 1.24e-6
    "layer_norm": 2.0 ** -8,    # measured 0
    "se": 1.5e-2,               # measured 7.46e-3
    "block_eval": 1.5e-2,       # measured 7.69e-3
    "block_train": 1.7e-2,      # measured 8.24e-3
    "flagship_bn": 3.4e-2,      # measured 1.66e-2
    # whole models, in norm (each package's flagship logits are 5-8% of
    # their norm off the f32 logits, in different directions)
    "flagship_logits": 0.27,    # measured 0.133
    "flagship_loss": 1.1e-2,    # measured 5.46e-3
    "flagship_update": 0.27,    # measured 0.131 (after 1), 0.087 (after 3)
    "tsf_logits": 2.9e-2,       # measured 1.45e-2
    "tsf_loss": 4.4e-3,         # measured 2.16e-3
    "tsf_update": 9e-3,         # measured 4.52e-3 (after 1), 3.32e-3
}
# each parameter's update: (least cosine with the f32 update, norm ratio
# range), twice the measured deviation from 1
LEAF = {
    "flagship": (0.6, 0.3, 1.5),    # measured 0.8135, [0.6565, 1.2450]
    "tsf": (0.9997, 0.994, 1.004),  # measured 0.99987, [0.9974, 1.0017]
}


def _f(a):
    return np.asarray(a, np.float64)


def _hold(name, port_bf16, jax_bf16, f32, scale=None):
    """Both bounds of the module docstring."""
    port_bf16, jax_bf16, f32 = _f(port_bf16), _f(jax_bf16), _f(f32)
    scale = np.abs(f32).max() if scale is None else scale
    e_port = np.abs(port_bf16 - f32).max()
    e_jax = np.abs(jax_bf16 - f32).max()
    assert np.all(np.isfinite(port_bf16)), name
    assert e_port <= 2 * e_jax + SLACK * scale, (name, e_port, e_jax, scale)
    direct = np.abs(port_bf16 - jax_bf16).max() / scale
    assert direct <= DIRECT[name.split(":")[0]], (name, direct)


def _bf16_np(shape, seed, scale=1.0, shift=0.0):
    """Seeded values that bf16 represents exactly, as f32 numpy."""
    x = np.random.default_rng(seed).standard_normal(shape) * scale + shift
    return torch.from_numpy(x.astype(np.float32)).to(BF16).float().numpy()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------------------
# the prologue and the loaders
# ---------------------------------------------------------------------------

def test_prologue_normalize_in_bf16_is_bitwise_the_jax_loaders():
    """x, mean and std rounded to bf16 (0.485·255 = 123.675 → 123.5), the
    difference rounded before the division: what XLA compiles on the CPU
    for the JAX DeviceLoader's ``(x.astype(bf16) - mean.astype(bf16)) /
    std.astype(bf16)``."""
    pro = Prologue("cpu", img_num=4, dtype=BF16)
    mean = pro.mean.float().numpy()
    assert mean[0] == 123.5
    rng = np.random.default_rng(0)
    jmean = np.tile(np.asarray([0.485, 0.456, 0.406], np.float32) * 255, 4)
    jstd = np.tile(np.asarray([0.229, 0.224, 0.225], np.float32) * 255, 4)
    f = jax.jit(lambda x: (x.astype(jnp.bfloat16)
                           - jnp.asarray(jmean).astype(jnp.bfloat16))
                / jnp.asarray(jstd).astype(jnp.bfloat16))
    for frac in (False, True):
        x = rng.integers(0, 256, (3, 16, 16, 12)).astype(np.float32)
        if frac:            # after jitter and the mixup blend
            x = (0.7 * x + 60 * rng.random(x.shape)).astype(np.float32)
        got = pro.normalize(torch.from_numpy(x))
        assert got.dtype == BF16
        want = np.asarray(f(jnp.asarray(x)).astype(jnp.float32))
        np.testing.assert_array_equal(got.float().numpy(), want)
    # f32 stays as it was: the multiply by the f32 reciprocal of std
    p32 = Prologue("cpu", img_num=4)
    x = torch.from_numpy(x)
    assert torch.equal(p32.normalize(x), (x - p32.mean) * p32.inv_std)


TREE_ARGS = ["--model", "efficientnet_b0", "--model-version", "",
             "--input-size-v2", "12,48,48", "-b", "3", "--label-balance",
             "--rotate-range", "5", "--blur-prob", "0.5", "--mixup", "0.1",
             "--workers", "2", "--color-jitter", "0", "--reprob", "0",
             "--seed", "4"]


def test_loader_batches_in_bf16_match_jax(tmp_path):
    """The first batches of both runners' train loaders from one clip tree
    at the default compute dtype (bf16): labels and soft targets bitwise,
    images equal but where the JAX warp's FMA moved a value by one grey
    level before the cast (``test_torch_train_cli.py``), which bf16 then
    shows as at most one grey level plus one bf16 rounding."""
    root = make_clip_tree(str(tmp_path), n_real=4, n_fake=8, hw=(52, 52))
    argv = TREE_ARGS + ["--data", root]
    jcfg = j_config.TrainConfig.from_args(argv + ["--augment-device", "on"])
    assert jcfg.compute_dtype == "bfloat16"
    jtrain, _ = j_runner.build_datasets(jcfg, (12, 48, 48))
    jl = j_loader.create_deepfake_loader_v3(
        jtrain, (12, 48, 48), 3, is_training=True,
        collate_mixup=j_mixup.FastCollateMixup(0.1, 0.1, 2),
        color_jitter=0.0, rotate_range=5, blur_radius=1, blur_prob=0.5,
        augment_device=True, dtype=jnp.bfloat16, num_workers=2, seed=4)
    jl.set_epoch(0)
    cfg = runner.parse_args(argv + ["--device", "cpu", "--augment-device",
                                    "on"])
    tl, _ = runner.build_loaders(cfg, torch.device("cpu"),
                                 *runner.build_datasets(cfg))
    tl.set_epoch(0)
    std = np.tile(np.asarray([0.229, 0.224, 0.225]) * 255.0, 4)
    n = 0
    for (xj, yj), (xt, yt) in zip(jl, tl):
        assert xt.dtype == BF16 and xj.dtype == jnp.bfloat16
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        xt, xj = _nhwc(xt), _f(np.asarray(xj, np.float32))
        d = np.abs(xt - xj) * std                          # grey levels
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(xj), 1e-30))) - 7)
        assert (d > 1e-3).mean() <= 1e-3, (d > 1e-3).mean()
        assert np.all(d <= 1.0 + ulp * std + 1e-6), d.max()
        n += 1
        if n == 2:
            break
    assert n == 2


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def _jax_apply(module, variables, x, training=False):
    if training:
        y, upd = module.apply(variables, jnp.asarray(x), training=True,
                              mutable=["batch_stats"])
        return np.asarray(y, np.float32), upd["batch_stats"]
    kw = {"training": False} if "batch_stats" in variables else {}
    return np.asarray(module.apply(variables, jnp.asarray(x), **kw),
                      np.float32), None


def test_conv2d_in_bf16_matches_jax():
    x = _bf16_np((2, 17, 17, 24), 0)
    w = _bf16_np((3, 3, 24, 40), 1, 0.2)
    out = {}
    for dtype in (None, jnp.bfloat16):
        jc = j_conv.Conv2d(40, 3, stride=2, dtype=dtype)
        out[dtype] = _jax_apply(jc, {"params": {"conv": {"kernel": w}}},
                                x)[0]
    conv = Conv2d(24, 40, 3, stride=2)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
    conv.compute_dtype = BF16
    got = conv(_nchw(x))
    assert got.dtype == BF16 and conv.weight.dtype == torch.float32
    _hold("conv", _nhwc(got), out[jnp.bfloat16], out[None])


def _bn_vars(c, seed):
    rng = np.random.default_rng(seed)
    return {"params": {"bn": {
        "scale": (1 + 0.2 * rng.standard_normal(c)).astype(np.float32),
        "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}},
        "batch_stats": {"bn": {
            "mean": (0.3 * rng.standard_normal(c)).astype(np.float32),
            "var": (1 + rng.random(c)).astype(np.float32)}}}


@pytest.mark.parametrize("training", [False, True])
def test_batch_norm_in_bf16_matches_flax(training):
    """f32 statistics of the bf16 input, f32 normalization, a bf16 output;
    in training the running stats update in f32 from the same statistics
    (within f32 rounding of flax's)."""
    c = 32
    x = _bf16_np((4, 9, 9, c), 2, 2.0, 0.5)
    v = _bn_vars(c, 3)
    out = {}
    for dtype in (None, jnp.bfloat16):
        jb = j_norm.BatchNorm2d(momentum=0.1, eps=1e-3, dtype=dtype)
        out[dtype] = _jax_apply(jb, v, x, training)
    bn = BatchNorm2d(c, momentum=0.1, eps=1e-3)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(v["params"]["bn"]["scale"]))
        bn.bias.copy_(torch.from_numpy(v["params"]["bn"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(v["batch_stats"]["bn"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(v["batch_stats"]["bn"]["var"]))
    bn.train(training)
    got = bn(_nchw(x).to(BF16))
    assert got.dtype == BF16
    _hold("bn_train" if training else "bn_eval", _nhwc(got),
          out[jnp.bfloat16][0], out[None][0])
    if training:
        for leaf, t in (("mean", bn.running_mean), ("var", bn.running_var)):
            want = np.asarray(out[jnp.bfloat16][1]["bn"][leaf])
            assert t.dtype == torch.float32
            np.testing.assert_allclose(t.numpy(), want, rtol=1e-6,
                                       atol=1e-7)


def test_layer_norm_in_bf16_matches_flax():
    import flax.linen as fnn
    x = _bf16_np((2, 7, 48), 4, 3.0, 1.0)
    rng = np.random.default_rng(5)
    p = {"scale": (1 + 0.2 * rng.standard_normal(48)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(48)).astype(np.float32)}
    out = {d: np.asarray(fnn.LayerNorm(epsilon=1e-5, dtype=d).apply(
        {"params": p}, jnp.asarray(x)), np.float32)
        for d in (None, jnp.bfloat16)}
    ln = LayerNorm(48, eps=1e-5)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(p["scale"]))
        ln.bias.copy_(torch.from_numpy(p["bias"]))
    ln.compute_dtype = BF16
    got = ln(torch.from_numpy(x).to(BF16))
    assert got.dtype == BF16
    _hold("layer_norm", got.detach().float().numpy(), out[jnp.bfloat16],
          out[None])


def _block_sd(jvars):
    """A JAX block's variables → the port block's state dict, through the
    model converter (as block 0 of stage 0)."""
    sd = state_dict_from_flax({k: {"blocks_0_0": v}
                               for k, v in jvars.items()})
    return {k[len("blocks.0.0."):]: v for k, v in sd.items()}


def _perturbed(variables, seed):
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.array(a, np.float32)
        if path[-1].key == "var":
            return a + rng.random(a.shape).astype(np.float32)
        return a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(f, variables)


def test_squeeze_excite_in_bf16_matches_jax():
    x = _bf16_np((2, 6, 6, 32), 6, 1.0, 0.2)
    jse = j_blocks.SqueezeExcite(0.25, reduced_base_chs=16, act="swish")
    v = _perturbed(_np_tree(jse.init(jax.random.PRNGKey(0),
                                     jnp.asarray(x))), 7)
    out = {}
    for dtype in (None, jnp.bfloat16):
        m = j_blocks.SqueezeExcite(0.25, reduced_base_chs=16, act="swish",
                                   dtype=dtype)
        out[dtype] = _jax_apply(m, v, x)[0]
    se = blocks.SqueezeExcite(32, 0.25, reduced_base_chs=16, act="swish")
    p = v["params"]
    with torch.no_grad():
        for name in ("conv_reduce", "conv_expand"):
            conv = getattr(se, name)
            conv.weight.copy_(torch.from_numpy(
                p[name]["conv"]["kernel"]).permute(3, 2, 0, 1))
            conv.bias.copy_(torch.from_numpy(p[name]["conv"]["bias"]))
    set_compute_dtype(se, BF16)
    got = se(_nchw(x).to(BF16).contiguous(memory_format=torch.channels_last))
    assert got.dtype == BF16
    _hold("se", _nhwc(got), out[jnp.bfloat16], out[None])


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


@pytest.mark.parametrize("training", [False, True])
def test_inverted_residual_with_the_fused_depthwise_stage_in_bf16(training):
    """An MBConv block (k5, stride 2, SE, Swish) whose depthwise stage is
    the port's fused op: the dw conv reads bf16 x with f32 weights and
    gives y (eval, the BN folded in) or z (train) in bf16, and the f32 BN
    statistics then normalize z, as JAX ``_fused_dw_bn_act`` does."""
    kw = dict(dw_kernel_size=5, stride=2, act="swish", exp_ratio=6.0,
              se_ratio=0.25, bn_momentum=0.1, bn_eps=1e-3)
    x = _bf16_np((3, 14, 14, 16), 8)
    jb = j_blocks.InvertedResidual(24, **kw)
    v = _perturbed(_np_tree(jb.init(jax.random.PRNGKey(1), jnp.asarray(x))),
                   9)
    out = {}
    for dtype in (None, jnp.bfloat16):
        m = j_blocks.InvertedResidual(24, dtype=dtype, **kw)
        out[dtype] = _jax_apply(m, v, x, training)
    port = blocks.InvertedResidual(16, 24, **kw)
    port.load_state_dict(_block_sd(v), strict=True)
    set_compute_dtype(port, BF16)
    port.train(training)
    got = port(_nchw(x).to(BF16).contiguous(
        memory_format=torch.channels_last))
    assert got.dtype == BF16
    name = "block_train" if training else "block_eval"
    _hold(name, _nhwc(got), out[jnp.bfloat16][0], out[None][0])
    if training:
        for bn, leaf in (("bn2", "running_var"), ("bn3", "running_mean")):
            f32 = _block_sd({"params": v["params"],
                             "batch_stats": out[None][1]})[f"{bn}.{leaf}"]
            jbf = _block_sd({"params": v["params"], "batch_stats":
                             out[jnp.bfloat16][1]})[f"{bn}.{leaf}"]
            _hold(f"{name}:{bn}.{leaf}", getattr(port, bn).__getattr__(
                leaf).numpy(), jbf.numpy(), f32.numpy())


def test_dw_gradient_of_bf16_x_equals_that_of_x_widened():
    """The port's dw gradient reads bf16 x as it is; the JAX backward
    widens x to f32 first (``depthwise_pallas.py:404``).  Widening bf16 is
    exact, so the two are equal, bitwise, through the op's autograd and
    through ``depthwise_dwgrad`` itself."""
    g = torch.Generator().manual_seed(10)
    x = torch.randn(3, 13, 13, 40, generator=g).to(BF16)
    w = torch.randn(5, 5, 40, generator=g) * 0.2
    pads = (2, 2, 2, 2)
    dz = torch.randn(3, 7, 7, 40, generator=g)
    assert torch.equal(dw.depthwise_dwgrad(x, dz, 5, 2, pads),
                       dw.depthwise_dwgrad(x.float(), dz, 5, 2, pads))
    grads, gy = [], dz.to(BF16)       # one cotangent, bf16 as y's
    for xi in (x, x.float()):
        wi = w.clone().requires_grad_()
        y = dw.fused_depthwise(xi, wi, None, None, 2, "", "none")
        grads.append(torch.autograd.grad(y, wi, gy.to(y.dtype))[0])
    assert torch.equal(grads[0], grads[1])


@pytest.mark.card
def test_dw_gradient_kernel_of_bf16_x_equals_that_of_x_widened():
    """The same on the card, through ``csrc/depthwise_dwgrad.cu``'s bf16
    and f32 instantiations."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(10)
    x = torch.randn(3, 75, 75, 96, generator=g, device="cuda").to(BF16)
    dz = torch.randn(3, 38, 38, 96, generator=g, device="cuda")
    for k, pads in ((3, (0, 1, 0, 1)), (5, (1, 2, 1, 2))):
        assert torch.equal(dw.depthwise_dwgrad(x, dz, k, 2, pads),
                           dw.depthwise_dwgrad(x.float(), dz, k, 2, pads))


# ---------------------------------------------------------------------------
# the reduced flagship and the reduced TimeSformer
# ---------------------------------------------------------------------------

MODEL = "efficientnet_deepfake_v4"
KW = dict(num_classes=2, in_chans=12, channel_multiplier=0.25,
          depth_multiplier=0.34)
SHAPE = (4, 48, 48, 12)
LR, CLIP, EMA_DECAY, STEPS = 0.02, 0.5, 0.9, 3


def _opt_cfg():
    import types
    return types.SimpleNamespace(opt="rmsproptf", opt_eps=1e-8, momentum=0.9,
                                 weight_decay=1e-2)


def _batches(seed, shape):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(STEPS):
        x = rng.standard_normal(shape).astype(np.float32)
        y = j_mixup.mixup_target_np(rng.integers(0, 2, shape[0]), 2,
                                    0.6 + 0.1 * i, 0.1).astype(np.float32)
        out.append((x, y))
    return out


def _run_jax(jm, variables, batches):
    """Eval logits of the first batch, then the guarded steps: per step the
    loss and a port-named snapshot of the model."""
    logits = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, training=False))(
        variables, jnp.asarray(batches[0][0])), np.float32)
    tx = j_create_opt(_opt_cfg(), learning_rate=LR)
    step = j_make_step(jm, tx, j_losses.soft_target_cross_entropy,
                       ema_decay=EMA_DECAY, clip_grad=CLIP,
                       nonfinite_guard=True, donate=False)
    js = j_state(jax.tree.map(jnp.asarray, variables), tx, with_ema=True,
                 donate=False)
    losses, snaps = [], []
    for x, y in batches:
        js, m = step(js, jnp.asarray(x), jnp.asarray(y),
                     jax.random.PRNGKey(0))
        assert float(m["nonfinite"]) == 0.0
        losses.append(float(m["loss"]))
        tree = {"params": js.params}
        if "batch_stats" in variables:
            tree["batch_stats"] = js.batch_stats
        snaps.append(tree)
    return logits, losses, snaps


def _run_port(model, batches):
    with torch.no_grad():
        logits = model.eval()(_nchw(batches[0][0])).float().numpy()
    state = create_train_state(model, create_optimizer(_opt_cfg(), model,
                                                       LR),
                               with_ema=True, ema_decay=EMA_DECAY)
    step = make_train_step(t_losses.soft_target_cross_entropy,
                           clip_grad=CLIP, nonfinite_guard=True)
    losses, snaps = [], []
    for x, y in batches:
        m = step(state, _nchw(x).contiguous(
            memory_format=torch.channels_last), torch.from_numpy(y))
        assert float(m["nonfinite"]) == 0.0
        losses.append(float(m["loss"]))
        snaps.append({k: v.detach().float().numpy().copy()
                      for k, v in state.model.state_dict().items()})
    return logits, losses, snaps, state


def _hold_model(name, port_bf16, jax_bf16, f32):
    """The whole-model bounds of the module docstring on one quantity."""
    p, j, f = (np.concatenate([_f(a).ravel() for a in q])
               for q in (port_bf16, jax_bf16, f32))
    norm = np.linalg.norm
    e_port, e_jax, scale = norm(p - f), norm(j - f), norm(f)
    assert np.all(np.isfinite(p)), name
    assert e_port <= 2 * e_jax + SLACK * scale, (name, e_port, e_jax, scale)
    assert e_port >= e_jax / 4, (name, "not a bf16 result", e_port, e_jax)
    direct = norm(p - j) / scale
    assert direct <= DIRECT[name], (name, direct)


def _hold_leaves(prefix, port, f32):
    """Each parameter's update against its own f32 update (``LEAF``)."""
    norm = np.linalg.norm
    cos_min, lo, hi = LEAF[prefix]
    largest = max(norm(u) for u in f32.values())
    for k, uf in f32.items():
        up = port[k].ravel()
        if norm(uf) <= 1e-6 * largest:          # a gradient that cancels
            assert norm(up) <= SLACK * largest, (k, norm(up) / largest)
            continue
        uf = uf.ravel()
        cos = up @ uf / (norm(up) * norm(uf)) if norm(up) else 0.0
        ratio = norm(up) / norm(uf)
        assert cos >= cos_min and lo <= ratio <= hi, (k, cos, ratio)


def _updates(snap, init):
    """Every parameter's change (BN statistics and counters left out)."""
    stats = ("running_mean", "running_var", "num_batches_tracked")
    return {k: _f(w) - init[k] for k, w in snap.items()
            if not k.endswith(stats)}


def _hold_run(prefix, port, jax_bf16, jax_f32, to_sd, init):
    """Logits, the losses of the steps and, after 1 and 3 steps, the whole
    update and each parameter's, and every BN statistic."""
    _hold_model(f"{prefix}_logits", [port[0]], [jax_bf16[0]], [jax_f32[0]])
    _hold_model(f"{prefix}_loss", [port[1]], [jax_bf16[1]], [jax_f32[1]])
    for after in (1, STEPS):
        want = to_sd(jax_f32[2][after - 1])
        jbf = to_sd(jax_bf16[2][after - 1])
        got = port[2][after - 1]
        uf, uj, up = (_updates(sd, init) for sd in (want, jbf, got))
        keys = sorted(uf)
        _hold_model(f"{prefix}_update", [up[k] for k in keys],
                    [uj[k] for k in keys], [uf[k] for k in keys])
        _hold_leaves(prefix, up, uf)
        for k, w in want.items():
            if k.endswith(("running_mean", "running_var")):
                # a mean against the channel spread, a var against var
                # (test_torch_train.py's rule for BN statistics)
                var = _f(want[k.rsplit(".", 1)[0] + ".running_var"]).max()
                _hold(f"{prefix}_bn:{k}", got[k], jbf[k], w,
                      scale=var if k.endswith("var") else np.sqrt(var))


def _no_bf16_state(state):
    flats = state.flat_buffers()
    assert set(flats) == {torch.float32, torch.int64}, set(flats)
    assert all(t.dtype != BF16 for t in state.tensors())


@pytest.fixture(scope="module")
def flagship_runs():
    """The reduced flagship's runs from one set of weights, BN calibrated
    on a batch: JAX in bf16 and f32, the port in bf16 and, for the planted
    fault, in f32."""
    jcal = j_create_model(MODEL, bn_momentum=1.0, **KW)
    v0 = _np_tree(j_init_model(jcal, jax.random.PRNGKey(2), SHAPE))
    xcal = np.random.default_rng(2).standard_normal(SHAPE).astype(np.float32)
    _, upd = jax.jit(lambda v, x: jcal.apply(
        v, x, training=True, mutable=["batch_stats"]))(v0, jnp.asarray(xcal))
    variables = _np_tree({"params": v0["params"],
                          "batch_stats": upd["batch_stats"]})
    batches = _batches(3, SHAPE)
    runs = {d: _run_jax(j_create_model(MODEL, bn_momentum=0.1, dtype=d,
                                       **KW), variables, batches)
            for d in (None, jnp.bfloat16)}
    sd = state_dict_from_flax(variables)
    ports = {}
    for dtype in (BF16, torch.float32):
        model = create_model(MODEL, device="cpu", bn_momentum=0.1,
                             dtype=dtype, **KW)
        model.load_state_dict(sd, strict=True)
        ports[dtype] = _run_port(model, batches)

    def to_sd(tree):
        return {k: v.numpy() for k, v in state_dict_from_flax(
            _np_tree(tree)).items()}
    return dict(ports=ports, jax_bf16=runs[jnp.bfloat16], jax_f32=runs[None],
                to_sd=to_sd, init={k: v.numpy() for k, v in sd.items()})


def test_reduced_flagship_in_bf16_matches_jax(flagship_runs):
    r = flagship_runs
    port = r["ports"][BF16]
    _no_bf16_state(port[3])
    _hold_run("flagship", port[:3], r["jax_bf16"], r["jax_f32"], r["to_sd"],
              r["init"])


TSF = dict(patch_size=8, embed_dim=192, depth=2, num_heads=3, num_classes=2,
           in_chans=12)


@pytest.fixture(scope="module")
def tsf_runs():
    """bf16 q, k, v into the flash kernels (the JAX ones interpreted, the
    port's plain versions on CPU tensors, which widen bf16 as the kernels
    do); Dense, LayerNorm and the embeddings as the JAX model casts them.
    The runs as ``flagship_runs``'."""
    shape = (2, 32, 32, 12)
    v0 = _np_tree(j_init_model(JTimeSformer(**TSF), jax.random.PRNGKey(3),
                               (1,) + shape[1:]))
    rng = np.random.default_rng(3)
    variables = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(
        a.shape)).astype(np.float32), v0)
    batches = _batches(4, shape)
    runs = {d: _run_jax(JTimeSformer(attn_impl="flash", dtype=d, **TSF),
                        variables, batches)
            for d in (None, jnp.bfloat16)}
    sd = state_dict_from_flax(variables, num_heads=3)
    ports = {}
    for dtype in (BF16, torch.float32):
        model = init_model(TimeSformer(img_size=32, attn_impl="flash", **TSF),
                           seed=0, device="cpu")
        model.load_state_dict(sd, strict=True)
        set_compute_dtype(model, dtype)
        ports[dtype] = _run_port(model, batches)

    def to_sd(tree):
        return {k: v.numpy() for k, v in state_dict_from_flax(
            _np_tree(tree), num_heads=3).items()}
    return dict(ports=ports, jax_bf16=runs[jnp.bfloat16], jax_f32=runs[None],
                to_sd=to_sd, init={k: v.numpy() for k, v in sd.items()})


def test_reduced_timesformer_with_flash_in_bf16_matches_jax(tsf_runs):
    r = tsf_runs
    port = r["ports"][BF16]
    _no_bf16_state(port[3])
    _hold_run("tsf", port[:3], r["jax_bf16"], r["jax_f32"], r["to_sd"],
              r["init"])


@pytest.mark.parametrize("fault", ["unchanged", "f32_step"])
@pytest.mark.parametrize("prefix", ["flagship", "tsf"])
def test_model_holds_reject_a_planted_fault(prefix, fault, request):
    """The whole-model holds fail a port whose state did not move (each
    step a no-op) and one whose step ran in f32: the update's and each
    leaf's holds for the first, the logits', the losses' and the update's
    for the second."""
    r = request.getfixturevalue(f"{prefix}_runs")
    port = r["ports"][BF16 if fault == "unchanged" else torch.float32]
    logits, losses, snaps = port[:3]
    if fault == "unchanged":
        init = {k: v.astype(np.float32) for k, v in r["init"].items()}
        snaps = [init] * len(snaps)
    want, jbf = (r["to_sd"](run[2][0]) for run in (r["jax_f32"],
                                                   r["jax_bf16"]))
    uf, uj, up = (_updates(sd, r["init"]) for sd in (want, jbf, snaps[0]))
    keys = sorted(uf)
    holds = [lambda: _hold_model(f"{prefix}_update", [up[k] for k in keys],
                                 [uj[k] for k in keys],
                                 [uf[k] for k in keys])]
    if fault == "unchanged":
        holds.append(lambda: _hold_leaves(prefix, up, uf))
    else:
        holds += [lambda: _hold_model(f"{prefix}_logits", [logits],
                                      [r["jax_bf16"][0]], [r["jax_f32"][0]]),
                  lambda: _hold_model(f"{prefix}_loss", [losses],
                                      [r["jax_bf16"][1]], [r["jax_f32"][1]])]
    for hold in holds:
        with pytest.raises(AssertionError):
            hold()

"""PyTorch port, the device augment chain on CPU against the JAX package.

The JAX functions are ``deepfake_detection_tpu/data/device_augment.py``
and ``random_erasing.py`` (the JAX package's ``--augment-device on``);
the port's are ``deepfake_detection_tpu_torch/data/device_augment.py`` and
``random_erasing.py``.  Inputs are seeded numpy: 4-frame clips of 40×48
source frames, crops of 32.

Bitwise:

* ``fused_geometric_params`` and the blur coins for 100 seeds, and the
  generator's position after them;
* the warp at integer coefficients (flips, crops, pads; scale 1);
* ``device_mixup_blend`` for 50 lambdas of the collate's stream, against
  the JAX blend and the numpy host blend, with one and two blocks;
* erasing in the three modes, with the JAX draws replayed through the
  port's ``apply_random_erasing``.

At stated tolerances (the reasons in the comments):

* the warp at fractional coefficients (rotation ±5°, scale 2/3 to 3/2) and
  the blur, against the JAX functions jitted as its loader runs them: at
  most ``WARP_FRAC`` of the values differ, by at most ``WARP_MAX`` grey
  level;
* colour jitter with the JAX draws replayed: ``JITTER_ATOL`` on 0–255
  (contrast's mean luma is a reduction summed in another order).

Statistics of the port's own draws over 10⁴ samples: the erase rate and
the flicker rate within 3σ of their probabilities, every box inside its
frame and its area within the drawn fraction up to rounding, and all six
orders of the jitter ops drawn.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfake_detection_tpu.data import device_augment as J
from deepfake_detection_tpu.data import transforms as j_tf
from deepfake_detection_tpu_torch.data import device_augment as T
from deepfake_detection_tpu_torch.data import mixup as t_mixup
from deepfake_detection_tpu_torch.data import random_erasing as t_erase
from deepfake_detection_tpu_torch.data import transforms as t_tf

# the JAX package's data/__init__ re-exports the function under the
# module's name
j_erase = importlib.import_module("deepfake_detection_tpu.data.random_erasing")

B, HS, WS, F = 6, 40, 48, 4
CROP = (32, 32)
# fractional warp and blur against the JAX package jitted, as its loader
# runs them: fraction of values that differ, and by how much.  XLA fuses
# A·x + B·y + C into FMAs where torch rounds each product, and one ulp then
# flips a rounding at .5: one grey level, in a small share of the values
# (more at larger crops); eager JAX is bitwise
WARP_FRAC, WARP_MAX = 1e-3, 1.0
# jitter, absolute on 0..255 (contrast's per-frame mean luma is a float32
# reduction in another order)
JITTER_ATOL = 1e-3


def _clips(seed=0, b=B, h=HS, w=WS):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, 3 * F),
                                                dtype=np.uint8)


def _specs(**kw):
    return (J.DeviceAugmentSpec(size=CROP, img_num=F, **kw),
            T.DeviceAugmentSpec(size=CROP, img_num=F, **kw))


def test_geometric_params_and_blur_coins_match_jax_for_100_seeds():
    for seed in range(100):
        for rot in (0, 5):
            g_j = np.random.default_rng(np.random.SeedSequence([seed, 1, 7]))
            g_t = np.random.default_rng(np.random.SeedSequence([seed, 1, 7]))
            size = (32, 32) if seed % 2 else (44, 52)     # pads when larger
            pj = j_tf.fused_geometric_params(WS, HS, size, rot,
                                             (2 / 3, 1.5), 0.5, g_j)
            pt = t_tf.fused_geometric_params(WS, HS, size, rot,
                                             (2 / 3, 1.5), 0.5, g_t)
            assert pj == pt
            assert j_tf.blur_mask_draws(F, 0.3, g_j) == \
                t_tf.blur_mask_draws(F, 0.3, g_t)
            assert g_j.random() == g_t.random()      # same stream position
    sj, st = _specs(rotate_range=5, blur_prob=0.3)
    for epoch in range(3):
        cj, bj = J.derive_geometric_batch(sj, range(10), 3, epoch, (HS, WS))
        ct, bt = T.derive_geometric_batch(st, range(10), 3, epoch, (HS, WS))
        np.testing.assert_array_equal(cj, ct)
        np.testing.assert_array_equal(bj, bt)


@pytest.mark.parametrize("size", [(32, 32), (40, 48), (44, 52)])
def test_integer_warp_is_bitwise(size):
    """Scale 1, no rotation: the coefficients are integers (±1, 0 and
    whole offsets, flips included, pads where the crop exceeds the
    source), so every product is exact on both sides."""
    sj = J.DeviceAugmentSpec(size=size, scale=(1.0, 1.0), img_num=F)
    st = T.DeviceAugmentSpec(size=size, scale=(1.0, 1.0), img_num=F)
    x = _clips(1)
    coeffs, _ = T.derive_geometric_batch(st, range(B), 5, 0, (HS, WS))
    assert np.all(coeffs == np.round(coeffs)) and np.any(coeffs[:, 0] < 0)
    want = np.asarray(jax.jit(J.make_device_geometric(sj))(
        jnp.asarray(x), jnp.asarray(coeffs)))
    got = T.device_geometric(torch.from_numpy(x), torch.from_numpy(coeffs),
                             size).numpy()
    np.testing.assert_array_equal(got, want)


def _frac_max(got, want):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return float((d > 0).mean()), float(d.max())


def test_fractional_warp_and_blur_within_tolerance():
    sj, st = _specs(rotate_range=5, blur_prob=0.5, blur_radius=1.0)
    warp = jax.jit(J.make_device_geometric(sj))
    blur = jax.jit(J.make_device_blur(sj))
    x = _clips(2)
    for epoch in range(5):
        coeffs, mask = T.derive_geometric_batch(st, range(epoch * B,
                                                          (epoch + 1) * B),
                                                3, epoch, (HS, WS))
        assert np.any(coeffs != np.round(coeffs))
        wj = np.asarray(warp(jnp.asarray(x), jnp.asarray(coeffs)))
        wt = T.device_geometric(torch.from_numpy(x),
                                torch.from_numpy(coeffs), CROP).numpy()
        frac, mx = _frac_max(wt, wj)
        assert frac <= WARP_FRAC and mx <= WARP_MAX, (epoch, frac, mx)
        assert np.all(wt == np.round(wt)) and wt.min() >= 0 \
            and wt.max() <= 255
        # the blur on the same input, only where the coin fired
        bj = np.asarray(blur(jnp.asarray(wj), jnp.asarray(mask)))
        frames = [tuple(v) for v in np.argwhere(mask).tolist()]
        assert frames
        bt = T.device_blur(torch.from_numpy(wj.copy()), frames, 1.0).numpy()
        frac, mx = _frac_max(bt, bj)
        assert frac <= WARP_FRAC and mx <= WARP_MAX, (epoch, frac, mx)
        keep = np.repeat(~mask, 3, axis=-1)[:, None, None, :]
        np.testing.assert_array_equal(np.where(keep, bt, 0),
                                      np.where(keep, wj, 0))


def test_gaussian_taps_and_split_match_jax():
    for r in (0.5, 1.0, 2.0):
        np.testing.assert_array_equal(T.gaussian_taps(r),
                                      J._gaussian_taps(r))
    for lam in np.random.default_rng(0).random(50).astype(np.float32):
        hi, lo = J._split_f32(jnp.float32(lam))
        assert T.split_f32(lam) == (float(hi), float(lo))


@pytest.mark.parametrize("blocks", [1, 2])
def test_mixup_blend_is_bitwise_for_50_lambdas(blocks):
    x = _clips(3).astype(np.float32)
    for bi in range(50):
        lam, om = J.derive_mixup_lam(11, 0, bi, 0.1, True)
        assert (lam, om) == T.derive_mixup_lam(11, 0, bi, 0.1, True)
        want = np.asarray(J.device_mixup_blend(jnp.asarray(x), lam, om,
                                               blocks))
        got = T.device_mixup_blend(torch.from_numpy(x), lam, om,
                                   blocks).numpy()
        np.testing.assert_array_equal(got, want)
        if blocks == 1:       # and the host collate's uint8 blend
            mixer = t_mixup.FastCollateMixup(0.1, 0.1, 2)
            host, _ = mixer(x.astype(np.uint8), np.zeros(B, np.int64),
                            np.random.default_rng(np.random.SeedSequence(
                                [11, 0, bi, 0x77])))
            np.testing.assert_array_equal(got.astype(np.uint8), host)


def _jitter_replay(key, b, flicker, cj):
    """The draws of the JAX ``make_device_color_jitter`` for ``key``, in
    the port's parameter form."""
    jb, jc, js = cj
    keys = jax.random.split(key, b)
    out = {"b": [], "c": [], "s": [], "order": [], "drop": []}
    for k in keys:
        kb, kc, ks, kord, kfl = jax.random.split(k, 5)
        for name, kk, j in (("b", kb, jb), ("c", kc, jc), ("s", ks, js)):
            out[name].append(float(jax.random.uniform(
                kk, (), minval=max(0.0, 1 - j), maxval=1 + j)))
        out["order"].append(np.asarray(jax.random.permutation(kord, 3)))
        out["drop"].append(np.asarray(
            jax.random.uniform(kfl, (F,)) < flicker))
    return {"b": torch.tensor(out["b"]), "c": torch.tensor(out["c"]),
            "s": torch.tensor(out["s"]),
            "order": torch.from_numpy(np.stack(out["order"])),
            "drop": torch.from_numpy(np.stack(out["drop"]))}


def test_color_jitter_with_replayed_draws_matches_jax():
    cj, flicker = (0.4, 0.4, 0.4), 0.3
    fn = J.make_device_color_jitter(cj, flicker, F)
    worst = 0.0
    orders = set()
    for seed in range(6):
        x = _clips(10 + seed).astype(np.float32)
        key = jax.random.PRNGKey(seed)
        want = np.asarray(fn(jnp.asarray(x), key))
        params = _jitter_replay(key, B, flicker, cj)
        orders |= {tuple(o) for o in params["order"].tolist()}
        got = T.apply_color_jitter(torch.from_numpy(x.copy()), params,
                                   F).numpy()
        worst = max(worst, float(np.abs(got - want).max()))
        # flickered frames are exactly zero in both
        for i, f in params["drop"].nonzero().tolist():
            assert not got[i, :, :, 3 * f:3 * f + 3].any()
    assert worst <= JITTER_ATOL, worst
    assert len(orders) >= 4, orders          # the test covers the orders


def _erase_replay(key, b, h, w, c, *, probability, min_area, max_area,
                  min_aspect, mode, min_count, max_count, num_splits):
    """The draws of the JAX ``random_erasing`` for ``key`` (its
    ``_one_erase`` key structure), as the port's boxes."""
    max_aspect = 1.0 / min_aspect
    la_min, la_max = math.log(min_aspect), math.log(max_aspect)
    cpf = c // F
    area = h * w
    start = b // num_splits if num_splits > 1 else 0
    keys = jax.random.split(key, b * F).reshape(b, F, 2)
    boxes = []
    for c_ in range(max_count):
        for bi in range(b):
            for f in range(F):
                k_gate, k_count, k_boxes, k_fill = jax.random.split(
                    keys[bi, f], 4)
                do = bool(jax.random.uniform(k_gate) < probability) \
                    and bi >= start
                count = int(jax.random.randint(k_count, (), min_count,
                                               max_count + 1))
                ka, kr, kt, kl = jax.random.split(
                    jax.random.fold_in(k_boxes, c_), 4)
                ta = jax.random.uniform(ka, (10,), minval=min_area,
                                        maxval=max_area) * area / count
                asp = jnp.exp(jax.random.uniform(kr, (10,), minval=la_min,
                                                 maxval=la_max))
                hh = jnp.round(jnp.sqrt(ta * asp)).astype(jnp.int32)
                ww = jnp.round(jnp.sqrt(ta / asp)).astype(jnp.int32)
                valid = np.asarray((ww < w) & (hh < h))
                pick = int(np.argmax(valid))
                bh, bw = int(hh[pick]), int(ww[pick])
                if not (valid[pick] and c_ < count and do):
                    continue
                top = int(jnp.floor(jax.random.uniform(kt) * (h - bh + 1)))
                left = int(jnp.floor(jax.random.uniform(kl) * (w - bw + 1)))
                k_f = jax.random.fold_in(k_fill, c_)
                if mode == "pixel":
                    fill = torch.from_numpy(np.asarray(jax.random.normal(
                        k_f, (h, w, cpf), jnp.float32))[
                            top:top + bh, left:left + bw].copy())
                elif mode == "rand":
                    fill = torch.from_numpy(np.array(jax.random.normal(
                        k_f, (1, 1, cpf), jnp.float32)).reshape(cpf))
                else:
                    fill = None
                boxes.append(t_erase.EraseBox(bi, f, top, left, bh, bw,
                                              fill))
    return boxes


@pytest.mark.parametrize("mode,max_count,num_splits",
                         [("const", 1, 0), ("rand", 2, 0), ("pixel", 2, 2)])
def test_random_erasing_with_replayed_draws_is_bitwise(mode, max_count,
                                                       num_splits):
    kw = dict(probability=0.7, min_area=0.02, max_area=0.3, min_aspect=0.3,
              mode=mode, min_count=1, max_count=max_count,
              num_splits=num_splits)
    x = np.random.default_rng(4).standard_normal(
        (4, 24, 20, 3 * F)).astype(np.float32)
    n_boxes = 0
    for seed in range(3):
        key = jax.random.PRNGKey(100 + seed)
        want = np.asarray(j_erase.random_erasing(key, jnp.asarray(x),
                                                 img_num=F, **kw))
        boxes = _erase_replay(key, *x.shape, **kw)
        n_boxes += len(boxes)
        got = t_erase.apply_random_erasing(torch.from_numpy(x.copy()),
                                           boxes, F).numpy()
        np.testing.assert_array_equal(got, want)
    assert n_boxes >= 8


def test_port_draw_statistics_over_10k_samples():
    g = torch.Generator().manual_seed(0)
    n, h, w = 10_000, 40, 48
    p, amin, amax = 0.2, 0.02, 0.05
    boxes = t_erase.draw_random_erasing(g, n, h, w, 3, probability=p,
                                        min_area=amin, max_area=amax,
                                        img_num=1)
    sigma = math.sqrt(p * (1 - p) / n)
    assert abs(len(boxes) / n - p) <= 3 * sigma, len(boxes) / n
    assert len({bx.b for bx in boxes}) == len(boxes)   # one box a frame
    for bx in boxes:
        assert 0 <= bx.top and bx.top + bx.h <= h, bx
        assert 0 <= bx.left and bx.left + bx.w <= w, bx
        # the drawn fraction is in [amin, amax]; rounding each side to an
        # integer moves the area by at most (h + w)/2 + 1/4
        slack = (bx.h + bx.w) / 2 + 0.25
        assert amin * h * w - slack <= bx.h * bx.w <= amax * h * w + slack
    params = T.draw_color_jitter(torch.Generator().manual_seed(1), n, F,
                                 (0.4, 0.4, 0.4), 0.05)
    orders = {tuple(o) for o in params["order"].tolist()}
    assert len(orders) == 6, orders
    for k in "bcs":
        assert 0.6 <= float(params[k].min()) and \
            float(params[k].max()) <= 1.4
    rate = float(params["drop"].float().mean())
    sigma = math.sqrt(0.05 * 0.95 / (n * F))
    assert abs(rate - 0.05) <= 3 * sigma, rate

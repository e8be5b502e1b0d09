"""PyTorch port, AugMix's data path on CPU against Pillow and JAX.

The JAX package's ``data/auto_augment.py`` runs timm's op pool through
Pillow 12.  The port computes the same bytes without Pillow
(``data/imaging.py`` over ``native/imaging.cc``, ``data/auto_augment.py``).
Inputs are seeded numpy.  Everything here is bitwise:

* the table ops (``ImageOps.posterize`` at every bit count, ``solarize``
  at every threshold, timm's ``solarize_add`` at every addend the level
  maps give, ``invert``) over all 2²⁴ colours;
* ``ImageOps.autocontrast`` and ``equalize`` over
  seeded frames of odd and even sizes and frames that take their special
  branches (a constant band, one occupied value, equalize's step 0 and its
  table past 255);
* ``ImageEnhance.Sharpness`` (the ``SMOOTH`` filter, border copied) at
  factors below, at and above 1, on frames down to 1 × 1, and read in
  place from a packed clip;
* ``Image.transform(AFFINE)`` and ``Image.rotate`` with ``BILINEAR`` and
  ``BICUBIC``, over sweeps of angles, shears and translations, with the
  policies' fill, a black fill and no fill;
* ``Image.blend`` at float alphas;
* ``AugMixAugment``, ``RandAugment`` and ``AutoAugment`` against the JAX
  ones with the same generator (and the generator's state after);
* ``AugMixDataset.__getitem__`` against the JAX one;
* one epoch of the train loader's host batches (uint8 before normalize)
  with ``num_aug_splits=3`` and ``re_split``, split-major, against the JAX
  loader's, RandomErasing leaving the clean split alone in both packages;
* the committed digests (``tests/data/augmix/digests.json``, which
  ``chip_smoke.py`` holds the card's host to): recomputed from Pillow and
  JAX, and from the port.
"""

import ast
import os
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageEnhance, ImageOps

from deepfake_detection_tpu.data import auto_augment as ja
from deepfake_detection_tpu.data import dataset as j_ds
from deepfake_detection_tpu.data import loader as j_loader
from deepfake_detection_tpu.data import transforms_factory as j_tff
from deepfake_detection_tpu_torch.data import auto_augment as ta
from deepfake_detection_tpu_torch.data import dataset as t_ds
from deepfake_detection_tpu_torch.data import imaging
from deepfake_detection_tpu_torch.data import loader as t_loader
from deepfake_detection_tpu_torch.data import transforms_factory as t_tff

import torch_augmix_fixtures as fx
import torch_host_augment_fixtures as hx

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent


def _same(got, want, msg=""):
    """Bitwise equality, fast on 48 MiB arrays; numpy's report on a
    mismatch."""
    got, want = np.asarray(got), np.asarray(want)
    if not (got.shape == want.shape and np.array_equal(got, want)):
        np.testing.assert_array_equal(got, want, err_msg=str(msg))


@pytest.fixture(scope="module")
def colours():
    rgb = hx.all_colours()
    return rgb, Image.fromarray(rgb)


# ---------------------------------------------------------------------------
# the table ops over every colour
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", list(range(9)))
def test_posterize_over_all_colours_is_bitwise_pillow(colours, bits):
    rgb, pil = colours
    _same(imaging.posterize(rgb, bits), ImageOps.posterize(pil, bits))


@pytest.mark.parametrize("first", list(range(0, 257, 32)))
def test_solarize_over_all_colours_is_bitwise_pillow(colours, first):
    """Every threshold 0..256, 32 a test."""
    rgb, pil = colours
    for t in range(first, min(first + 32, 257)):
        _same(imaging.solarize(rgb, t), ImageOps.solarize(pil, t), t)


@pytest.mark.parametrize("first", list(range(0, 111, 28)))
def test_solarize_add_over_all_colours_is_bitwise_the_jax_op(colours, first):
    """Every addend the level maps give (0..110), below threshold 128."""
    rgb, pil = colours
    for add in range(first, min(first + 28, 111)):
        _same(ta.solarize_add(rgb, add, None),
              ja.solarize_add(pil, add, None), add)


def test_invert_over_all_colours_is_bitwise_pillow(colours):
    rgb, pil = colours
    _same(imaging.invert(rgb), ImageOps.invert(pil))


def test_point_clips_its_table_as_pillow_stores_it():
    a = hx.photo(1, 9, 11)
    lut = [(i * 7) % 400 - 60 for i in range(768)]
    np.testing.assert_array_equal(imaging.point(a, lut),
                                  np.asarray(Image.fromarray(a).point(lut)))
    with pytest.raises(ValueError, match="256 or 768"):
        imaging.point(a, list(range(100)))


# ---------------------------------------------------------------------------
# the histogram ops, the filter, the blend
# ---------------------------------------------------------------------------

SIZES = [(1, 1), (1, 7), (2, 5), (3, 3), (37, 23), (64, 96), (101, 80),
         (48, 48)]


@pytest.mark.parametrize("size", SIZES)
def test_histogram_ops_are_bitwise_pillow(size):
    for seed in range(3):
        a = hx.photo(seed, *size) if seed else np.random.default_rng(
            size[0]).integers(0, 256, size + (3,), dtype=np.uint8)
        pil = Image.fromarray(a)
        np.testing.assert_array_equal(imaging.autocontrast(a),
                                      np.asarray(ImageOps.autocontrast(pil)))
        np.testing.assert_array_equal(imaging.equalize(a),
                                      np.asarray(ImageOps.equalize(pil)))


@pytest.mark.parametrize("kind", fx.DEGENERATE)
def test_histogram_ops_take_pillows_special_branches(kind):
    a = fx.degenerate(kind)
    pil = Image.fromarray(a)
    np.testing.assert_array_equal(imaging.autocontrast(a),
                                  np.asarray(ImageOps.autocontrast(pil)))
    np.testing.assert_array_equal(imaging.equalize(a),
                                  np.asarray(ImageOps.equalize(pil)))


def _last_bin_entry(band: np.ndarray) -> int:
    """Pillow's equalize table entry at a band's last occupied value."""
    h = np.bincount(band.ravel(), minlength=256)
    occupied = h[h > 0]
    step = int(occupied.sum() - occupied[-1]) // 255
    last = int(np.flatnonzero(h)[-1])
    return (step // 2 + int(h[:last].sum())) // step if step else last


def test_equalize_table_past_255_is_clipped_as_pillow():
    """A band whose last occupied value holds many pixels: ``n // step``
    passes 255 there, and Pillow's point stores 255."""
    rng = np.random.default_rng(2)
    past = 0
    for n in (256, 300, 400, 509, 700):
        a = np.full((1, n, 3), 255, np.uint8)
        a[0, :n - 40] = rng.integers(0, 255, (n - 40, 3))
        past += _last_bin_entry(a[..., 0]) > 255
        np.testing.assert_array_equal(imaging.equalize(a),
                                      np.asarray(ImageOps.equalize(
                                          Image.fromarray(a))))
    assert past >= 2


@pytest.mark.parametrize("factor", [-0.3, 0.0, 0.1, 0.55, 1.0, 1.45, 1.9,
                                    2.5])
def test_sharpness_is_bitwise_pillow(factor):
    for h, w in SIZES:
        a = hx.photo(h * w, h, w)
        np.testing.assert_array_equal(
            imaging.sharpness(a, factor),
            np.asarray(ImageEnhance.Sharpness(Image.fromarray(a)).enhance(
                factor)), err_msg=str((h, w)))


def test_sharpness_over_all_colours_is_bitwise_pillow(colours):
    rgb, pil = colours
    _same(imaging.sharpness(rgb, 1.7),
          ImageEnhance.Sharpness(pil).enhance(1.7))


@pytest.mark.parametrize("alpha", [0.0, 0.1, 0.25, 0.5, 0.6180339887,
                                   0.999, 1.0, np.float32(0.3137)])
def test_blend_is_bitwise_pillow(alpha):
    for h, w in SIZES:
        a, b = hx.photo(1, h, w), hx.photo(2, h, w)
        np.testing.assert_array_equal(
            imaging.blend(a, b, alpha),
            np.asarray(Image.blend(Image.fromarray(a), Image.fromarray(b),
                                   alpha)))


def test_ops_read_a_packed_clips_frames_in_place():
    base = np.random.default_rng(3).integers(0, 256, (20, 30, 12),
                                             dtype=np.uint8)
    for i in range(4):
        view = base[..., 3 * i:3 * i + 3]
        pil = Image.fromarray(np.ascontiguousarray(view))
        np.testing.assert_array_equal(
            imaging.sharpness(view, 1.6),
            np.asarray(ImageEnhance.Sharpness(pil).enhance(1.6)))
        np.testing.assert_array_equal(imaging.equalize(view),
                                      np.asarray(ImageOps.equalize(pil)))
        np.testing.assert_array_equal(
            imaging.rotate_fill(view, 7.5, imaging.BICUBIC, fx.FILL),
            np.asarray(pil.rotate(7.5, resample=Image.BICUBIC,
                                  fillcolor=fx.FILL)))
        np.testing.assert_array_equal(
            imaging.blend(view, base[..., :3], 0.4),
            np.asarray(Image.blend(pil, Image.fromarray(
                np.ascontiguousarray(base[..., :3])), 0.4)))


# ---------------------------------------------------------------------------
# the affine
# ---------------------------------------------------------------------------

AFFINE_SIZES = [(1, 1), (2, 5), (37, 23), (64, 96), (48, 48)]
RESAMPLERS = [Image.BILINEAR, Image.BICUBIC]


@pytest.mark.parametrize("resample", RESAMPLERS)
@pytest.mark.parametrize("deg", [-30.0, -29.0, -9.5, -1.0, -0.3, 0.0, 0.7,
                                 5.0, 12.25, 29.9, 45.0, 90.0, 180.0,
                                 270.0, -90.0, 360.0])
def test_rotate_is_bitwise_pillow(resample, deg):
    """No expand, the frame's centre; 90° and 270° of a non-square frame
    go through the transform, of a square one through the transpose."""
    for h, w in AFFINE_SIZES:
        a = hx.photo(int(abs(deg) * 10) + h, h, w)
        pil = Image.fromarray(a)
        for fill in (fx.FILL, (0, 0, 0), None, (255, 17, 3)):
            np.testing.assert_array_equal(
                imaging.rotate_fill(a, deg, resample, fill),
                np.asarray(pil.rotate(deg, resample=resample,
                                      fillcolor=fill)),
                err_msg=str((h, w, fill)))


@pytest.mark.parametrize("resample", RESAMPLERS)
@pytest.mark.parametrize("op", ["shear_x", "shear_y", "translate_x",
                                "translate_y"])
def test_affine_sweep_is_bitwise_pillow(resample, op):
    rng = np.random.default_rng(len(op) + resample)
    for h, w in AFFINE_SIZES:
        a = hx.photo(h + w, h, w)
        pil = Image.fromarray(a)
        if op.startswith("shear"):
            args = list(fx.SHEARS) + list(rng.uniform(-0.3, 0.3, 12))
        else:
            ext = w if op == "translate_x" else h
            args = ([p * ext for p in fx.TRANSLATES] + list(fx.TRANSLATES_ABS)
                    + list(rng.uniform(-0.45, 0.45, 12) * ext))
        for arg in args:
            m = fx._MATRIX[op](arg)
            np.testing.assert_array_equal(
                imaging.affine(a, m, resample, fx.FILL),
                np.asarray(pil.transform(pil.size, Image.AFFINE, m,
                                         resample=resample,
                                         fillcolor=fx.FILL)),
                err_msg=str((h, w, arg)))


@pytest.mark.parametrize("resample", RESAMPLERS)
def test_general_affine_is_bitwise_pillow(resample):
    """Matrices beyond the policies' (scale, both shears, far offsets)."""
    rng = np.random.default_rng(resample)
    a = hx.photo(8, 41, 30)
    pil = Image.fromarray(a)
    for _ in range(40):
        m = tuple(rng.normal(0, 1.2, 6))
        m = (m[0], m[1], rng.uniform(-20, 60), m[3], m[4],
             rng.uniform(-20, 60))
        np.testing.assert_array_equal(
            imaging.affine(a, m, resample, (9, 99, 199)),
            np.asarray(pil.transform(pil.size, Image.AFFINE, m,
                                     resample=resample,
                                     fillcolor=(9, 99, 199))))


def test_affine_refuses_what_it_does_not_compute():
    a = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(ValueError, match="NEAREST"):
        imaging.affine(a, (1, 0, 0, 0, 1, 0), imaging.NEAREST)
    with pytest.raises(ValueError, match="6 values"):
        imaging.affine(a, (1, 0, 0), imaging.BILINEAR)
    with pytest.raises(ValueError, match="fill"):
        imaging.affine(a, (1, 0, 0, 0, 1, 0), imaging.BILINEAR, (1, 2))


# ---------------------------------------------------------------------------
# the policies
# ---------------------------------------------------------------------------

POLICY_CONFIGS = {
    "augmix": ("augmix-m3-w3", "augment_and_mix_transform", None),
    "augmix_m5_w4_d2": ("augmix-m5-w4-d2-mstd0.5",
                        "augment_and_mix_transform", None),
    "augmix_a0.5_b1": ("augmix-m3-w2-a0.5-b1", "augment_and_mix_transform",
                       None),
    "augmix_bicubic": ("augmix-m3-w3", "augment_and_mix_transform",
                       {"interpolation": "bicubic"}),
    "rand": ("rand-m9-mstd0.5", "rand_augment_transform", None),
    "rand_inc": ("rand-m9-mstd0.5-inc1", "rand_augment_transform", None),
    "rand_weighted": ("rand-m9-n3-w0-mstd101", "rand_augment_transform",
                      None),
    "rand_mmax": ("rand-m7-mmax8-n1", "rand_augment_transform",
                  {"img_mean": (10, 20, 30), "translate_const": 100}),
    "aa_v0": ("v0", "auto_augment_transform", None),
    "aa_original": ("original-mstd0.5", "auto_augment_transform", None),
    "aa_originalr": ("originalr", "auto_augment_transform", None),
}


@pytest.mark.parametrize("name", sorted(POLICY_CONFIGS))
def test_policy_is_bitwise_the_jax_policy(name):
    cfg, ctor, hp = POLICY_CONFIGS[name]
    jp = getattr(ja, ctor)(cfg, hp)
    tp = getattr(ta, ctor)(cfg, hp)
    for seed in range(30):
        h, w = SIZES[3 + seed % 5]
        a = hx.photo(seed, h, w)
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        want = np.asarray(jp(Image.fromarray(a), rj))
        got = np.asarray(tp(a, rt))
        np.testing.assert_array_equal(got, want, err_msg=str(seed))
        assert rj.random() == rt.random(), seed


def test_augmix_on_a_600_frame_is_bitwise_the_jax_augmix():
    jp = ja.augment_and_mix_transform("augmix-m3-w3")
    tp = ta.augment_and_mix_transform("augmix-m3-w3")
    for seed in range(2):
        a = hx.photo(90 + seed, 600, 600)
        view = np.concatenate([a, a[::-1]], -1)[..., 3:]   # a strided frame
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(
            tp(view, rt), np.asarray(jp(Image.fromarray(
                np.ascontiguousarray(view)), rj)))


def test_op_tables_and_quirks_match_the_jax_module():
    assert sorted(ta.NAME_TO_OP) == sorted(ja.NAME_TO_OP)
    assert sorted(ta.LEVEL_TO_ARG) == sorted(ja.LEVEL_TO_ARG)
    assert ta._AUGMIX_TRANSFORMS == ja._AUGMIX_TRANSFORMS
    assert ta._RAND_TRANSFORMS == ja._RAND_TRANSFORMS
    assert ta._RAND_INCREASING_TRANSFORMS == ja._RAND_INCREASING_TRANSFORMS
    assert ta._RAND_CHOICE_WEIGHTS_0 == ja._RAND_CHOICE_WEIGHTS_0
    for policy in ("v0", "original", "originalr"):
        assert ta._POLICIES[policy]() == ja._POLICIES[policy]()
    # every level map draws as the JAX one
    for name, fn in ta.LEVEL_TO_ARG.items():
        for level in (0.0, 1.7, 3.0, 10.0):
            rj, rt = np.random.default_rng(5), np.random.default_rng(5)
            assert fn(level, rt, {}) == ja.LEVEL_TO_ARG[name](level, rj, {})
            assert rj.random() == rt.random()
    # 'blended' is parsed and never used
    t = ta.augment_and_mix_transform("augmix-m3-w3-b1")
    assert t.blended is True
    a = hx.photo(3, 20, 20)
    np.testing.assert_array_equal(
        t(a, np.random.default_rng(0)),
        ta.augment_and_mix_transform("augmix-m3-w3")(
            a, np.random.default_rng(0)))
    with pytest.raises(ValueError, match="augmix"):
        ta.augment_and_mix_transform("rand-m9")


# ---------------------------------------------------------------------------
# the dataset and the loader
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return hx.make_tree(str(tmp_path_factory.mktemp("augmix_tree")))


@pytest.fixture
def npy_frames(monkeypatch):
    """The JAX dataset decodes the listed ``<i>.jpg``; the tree holds each
    frame as the ``<i>.npy`` beside that path, which the port reads."""
    monkeypatch.setattr(j_ds, "_load_images", lambda paths: [
        Image.fromarray(np.load(os.path.splitext(p)[0] + ".npy"))
        for p in paths])


@pytest.mark.parametrize("splits", [2, 3])
def test_augmix_dataset_getitem_is_bitwise_jax(tree, npy_frames, splits):
    kw = dict(img_size=64, color_jitter=(0.4, 0.4, 0.4), flicker=0.2,
              rotate_range=5, blur_radius=1, blur_prob=0.5)
    jd = j_ds.AugMixDataset(j_ds.DeepFakeClipDataset(tree, label_balance=True),
                            num_splits=splits)
    td = t_ds.AugMixDataset(t_ds.DeepFakeClipDataset(tree, label_balance=True),
                            num_splits=splits)
    jd.set_transform(j_tff.transforms_deepfake_train_v3(**kw))
    td.set_transform(t_tff.transforms_deepfake_train_v3(**kw))
    assert len(jd) == len(td)
    for epoch in (0, 1):
        jd.set_epoch(epoch)
        td.set_epoch(epoch)
        for i in range(len(td)):
            rj = np.random.default_rng(np.random.SeedSequence([42, epoch, i]))
            rt = np.random.default_rng(np.random.SeedSequence([42, epoch, i]))
            (xj, yj), (xt, yt) = jd.__getitem__(i, rng=rj), \
                td.__getitem__(i, rng=rt)
            assert xt.shape == (splits, 64, 64, 12) and xt.dtype == np.uint8
            np.testing.assert_array_equal(xt, xj)
            assert yt == yj
            assert rj.random() == rt.random()
    # with no generator: the JAX default SeedSequence([epoch, index])
    np.testing.assert_array_equal(td[3][0], jd[3][0])
    with pytest.raises(ValueError, match="num_splits"):
        t_ds.AugMixDataset(td.dataset, num_splits=1)


LOADER_KW = dict(is_training=True, re_prob=0.5, re_max=0.05, re_split=True,
                 flicker=0.2, rotate_range=5, blur_radius=1, blur_prob=0.5,
                 num_workers=2, seed=42, color_jitter=0.4, num_aug_splits=3)


def test_loader_epoch_host_batches_are_bitwise_jax(tree, npy_frames):
    """A whole epoch, split-major: rows [s·B, (s+1)·B) are view s of the
    batch's samples, the labels tiled; no device jitter (the views share
    the host chain's draw)."""
    jl = j_loader.create_deepfake_loader_v3(
        j_ds.DeepFakeClipDataset(tree, label_balance=True), hx.TREE_INPUT,
        3, dtype=jnp.float32, **LOADER_KW)
    tl = t_loader.create_deepfake_loader_v3(
        t_ds.DeepFakeClipDataset(tree, label_balance=True), hx.TREE_INPUT,
        3, device="cpu", **LOADER_KW)
    assert tl.color_jitter is None and tl.flicker == 0.0
    assert tl.prologue.spec is None
    jl.set_epoch(1)
    tl.set_epoch(1)
    n = 0
    for (xj, yj), hb in zip(jl.loader, tl.loader):
        x = hb.images.numpy()
        assert x.shape == (9, 128, 128, 12)
        np.testing.assert_array_equal(x, np.asarray(xj))
        np.testing.assert_array_equal(hb.targets.numpy(), np.asarray(yj))
        np.testing.assert_array_equal(hb.targets.numpy()[:3],
                                      hb.targets.numpy()[3:6])
        # the clean split is the base chain's clip, AugMix views differ
        assert not np.array_equal(x[:3], x[3:6])
        n += 1
    assert n == len(tl) == len(jl.loader) > 0


def test_erasing_leaves_the_clean_split_alone(tree, npy_frames):
    """``re_split`` with three aug splits: no erase box lands in the first
    third of the rows, and the prologue's clean rows are the plain
    normalize of the host rows, in the port and in the JAX loader; the
    other rows do get erased."""
    jl = j_loader.create_deepfake_loader_v3(
        j_ds.DeepFakeClipDataset(tree, label_balance=True), hx.TREE_INPUT,
        3, dtype=jnp.float32, **LOADER_KW)
    tl = t_loader.create_deepfake_loader_v3(
        t_ds.DeepFakeClipDataset(tree, label_balance=True), hx.TREE_INPUT,
        3, device="cpu", **LOADER_KW)
    assert tl.erasing["num_splits"] == 3
    jl.set_epoch(0)
    tl.set_epoch(0)
    erased = 0
    for (xj, _), hb in zip(jl, tl.loader):
        boxes = hb.params["erase"]
        assert all(bx.b >= 3 for bx in boxes)
        erased += len(boxes)
        plain = tl.prologue.normalize(hb.images).numpy()
        got = tl.prologue(hb.images.clone(), hb.params).permute(
            0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(got[:3], plain[:3])
        assert np.abs(np.asarray(xj)[:3] - plain[:3]).max() <= 1e-6
    assert erased > 0


def test_loader_factories_route_aug_splits_as_jax(tree, caplog):
    ds = t_ds.DeepFakeClipDataset(tree)
    with caplog.at_level("INFO"):
        tl = t_loader.create_deepfake_loader_v3(
            ds, hx.TREE_INPUT, 3, device="cpu", augment_device=True,
            **LOADER_KW)
    assert tl.prologue.spec is None        # the host chain, with a log line
    assert "device augmentation falls back to the host chain" in caplog.text
    assert "color jitter stays on host" in caplog.text
    assert isinstance(tl.loader.dataset, t_ds.AugMixDataset)
    # eval takes one view
    el = t_loader.create_deepfake_loader_v3(
        ds, hx.TREE_INPUT, 3, device="cpu", num_aug_splits=3)
    assert not isinstance(el.loader.dataset, t_ds.AugMixDataset)
    # without aug splits, re_split leaves the first half alone
    assert t_loader._erasing(0.5, "const", 1, True, 0.05)["num_splits"] == 2
    assert t_loader._erasing(0.5, "const", 1, False, 0.05,
                             3)["num_splits"] == 0


def test_synthetic_loader_stacks_augmix_views_split_major():
    ds = t_ds.SyntheticDataset(8, (16, 16, 12), 2, seed=1)
    tl = t_loader.create_loader(ds, 2, True, "cpu", img_num=4,
                                num_aug_splits=3)
    tl.set_epoch(0)
    hb = next(iter(tl.loader))
    x = hb.images.numpy()
    assert x.shape == (6, 16, 16, 12)
    for b, i in enumerate(hb.indices):
        np.testing.assert_array_equal(x[b], ds[i][0])
    np.testing.assert_array_equal(hb.targets.numpy(),
                                  np.tile(hb.targets.numpy()[:2], 3))


# ---------------------------------------------------------------------------
# the digests, and no Pillow
# ---------------------------------------------------------------------------

def test_digests_hold_for_the_port(tree):
    d = fx.load_digests()
    assert sorted(d["cases"]) == sorted(fx.CASES)
    bad = [n for n in fx.CASES if fx.sha(fx.port_case(n)) != d["cases"][n]]
    assert not bad, bad
    assert fx.port_batches(tree) == d["loaders"]["augmix_resplit"]


def test_digests_are_pillows_and_the_jax_packages(tree, npy_frames):
    """The committed file, regenerated from Pillow (the version recorded)
    and the JAX package, is the file."""
    assert fx.reference_digests(tree) == fx.load_digests()


def test_augmix_path_imports_no_pillow():
    for name in ("data/auto_augment.py", "data/imaging.py",
                 "data/loader.py", "ops/norm.py", "runners/train.py"):
        path = REPO / "deepfake_detection_tpu_torch" / name
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            assert not any(n.split(".")[0] == "PIL" for n in names), path


def test_augmix_runs_with_pillow_absent(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    ds = t_ds.AugMixDataset(t_ds.SyntheticDataset(4, (24, 20, 12)), 3)
    x, _ = ds.__getitem__(1, rng=np.random.default_rng(0))
    assert x.shape == (3, 24, 20, 12)
    for cfg, ctor in (("rand-m9-mstd0.5", "rand_augment_transform"),
                      ("original", "auto_augment_transform")):
        assert getattr(ta, ctor)(cfg)(hx.photo(1, 20, 20),
                                      np.random.default_rng(0)).shape == \
            (20, 20, 3)

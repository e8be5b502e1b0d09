"""PyTorch port, the host augment chain on CPU against Pillow and JAX.

The JAX package's ``--augment-device off`` (its default, and what
``scripts/train.sh`` trains with) runs the train chain on the host through
Pillow 12 and its native warp.  The port computes the same bytes with
neither (``data/imaging.py`` over ``native/imaging.cc``,
``data/native.py`` ``warp_affine_batch``).  Inputs are seeded numpy.

Bitwise:

* the warp against the JAX ``native.warp_affine_batch``, by hypothesis over
  flips, out-of-bounds taps, 1-pixel sources, packed and strided sources
  and outputs;
* each per-pixel op over all 2²⁴ RGB values in one array:
  ``convert("L")``, RGB → HSV and HSV → RGB, ``ImageEnhance.Brightness``,
  ``Contrast`` and ``Color`` at factors below and above 1, the hue step;
* ``GaussianBlur`` at radii 0.5 to 3 over odd, 1 × 1 and box-wider-than-
  the-frame sizes; ``rotate(expand=True)``, ``FLIP_LEFT_RIGHT`` and the
  bilinear ``resize``;
* ``transforms_deepfake_train_v3`` against the JAX one on one clip and one
  generator seed (``fused_geom`` True and False, blur 1, hue on and off,
  flicker 0.5 and 1, list and packed input), and the generator's position
  after it;
* the train loader's first host batches (uint8 images, f32 soft targets)
  against the JAX loader's, under ``scripts/train.sh``'s flags with and
  without ``--host-geom``, without mixup (warp and blur on the host,
  jitter on the device in both) and with hue jitter (all on the host);
* the committed digests (``tests/data/host_augment/digests.json``, which
  ``chip_smoke.py`` holds the card's host to): recomputed from Pillow and
  JAX, and from the port.

At a stated tolerance: the loaders' normalised output (the prologue after
the host chain, ``--reprob 0``: erasing draws from ``jax.random`` in one
package and from a torch generator in the other) within 1e-6, and three
steps of the reduced flagship from the tree through both runners' loaders
at ``tests/test_torch_train_cli.py``'s tolerance (``_close_change``).

No case needs a tolerance of a grey level: every op is bitwise.
"""

import ast
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image, ImageEnhance, ImageFilter

from deepfake_detection_tpu import config as j_config
from deepfake_detection_tpu import losses as j_losses
from deepfake_detection_tpu.data import dataset as j_ds
from deepfake_detection_tpu.data import loader as j_loader
from deepfake_detection_tpu.data import mixup as j_mixup
from deepfake_detection_tpu.data import native as j_native
from deepfake_detection_tpu.data import transforms as j_tf
from deepfake_detection_tpu.data import transforms_factory as j_tff
from deepfake_detection_tpu.models import create_model as j_create_model
from deepfake_detection_tpu.models import init_model as j_init_model
from deepfake_detection_tpu.optim import create_optimizer as j_create_opt
from deepfake_detection_tpu.runners import train as j_runner
from deepfake_detection_tpu.train import create_train_state as j_state
from deepfake_detection_tpu.train import make_train_step as j_make_step
from deepfake_detection_tpu_torch.convert import state_dict_from_flax
from deepfake_detection_tpu_torch.data import dataset as t_ds
from deepfake_detection_tpu_torch.data import imaging
from deepfake_detection_tpu_torch.data import loader as t_loader
from deepfake_detection_tpu_torch.data import mixup as t_mixup
from deepfake_detection_tpu_torch.data import native
from deepfake_detection_tpu_torch.data import transforms as t_tf
from deepfake_detection_tpu_torch.data import transforms_factory as t_tff
from deepfake_detection_tpu_torch.models import create_model
from deepfake_detection_tpu_torch.runners import train as runner
from test_torch_train_cli import _close_change

import torch_host_augment_fixtures as fx

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# the warp
# ---------------------------------------------------------------------------

@st.composite
def _warp_case(draw):
    h = draw(st.integers(1, 24))
    w = draw(st.integers(1, 24))
    n = draw(st.integers(1, 4))
    seed = draw(st.integers(0, 2 ** 32 - 1))
    kind = draw(st.sampled_from(["general", "flip", "scale", "far"]))
    rng = np.random.default_rng(seed)
    if kind == "flip":          # the chain's flip: A = −1/s
        s = rng.uniform(2 / 3, 3 / 2)
        coef = [-s, 0.0, w - 1 + rng.uniform(-3, 3), 0.0, s,
                rng.uniform(-3, 3)]
    elif kind == "scale":
        coef = [rng.uniform(0.3, 2), 0.0, rng.uniform(-4, 4), 0.0,
                rng.uniform(0.3, 2), rng.uniform(-4, 4)]
    elif kind == "far":         # every tap out of bounds, or on the border
        coef = [rng.uniform(-1, 1), rng.uniform(-1, 1),
                rng.choice([-1.0, 1.0]) * rng.uniform(w, 3 * w + 2),
                rng.uniform(-1, 1), rng.uniform(-1, 1),
                rng.choice([-1.0, 1.0]) * rng.uniform(h - 1, 2 * h + 2)]
    else:
        coef = list(rng.normal(0, 1.5, 6))
        coef[2] = rng.uniform(-5, w + 5)
        coef[5] = rng.uniform(-5, h + 5)
    out = (draw(st.integers(1, 30)), draw(st.integers(1, 30)))
    strided = draw(st.booleans())
    packed = draw(st.booleans())
    base = rng.integers(0, 256, (h, w, 3 * n), dtype=np.uint8)
    frames = [base[..., 3 * i:3 * i + 3] for i in range(n)]
    if not strided:
        frames = [np.ascontiguousarray(f) for f in frames]
    return frames, coef, out, packed


@settings(max_examples=300, deadline=None)
@given(_warp_case())
def test_warp_is_bitwise_the_jax_native_warp(case):
    frames, coef, out, packed = case
    want = j_native.warp_affine_batch(frames, coef, out, packed=packed)
    got = native.warp_affine_batch(frames, coef, out, packed=packed)
    if packed:
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert len(got) == len(want)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g, w_)


def test_warp_of_the_chain_at_640_is_bitwise_the_jax_warp():
    for seed in range(3):
        coeffs, frames = fx._warp_params(seed)
        np.testing.assert_array_equal(
            native.warp_affine_batch(frames, coeffs, (600, 600),
                                     packed=True),
            j_native.warp_affine_batch(frames, coeffs, (600, 600),
                                       packed=True))


# ---------------------------------------------------------------------------
# the per-pixel ops over every colour
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def colours():
    rgb = fx.all_colours()
    return rgb, Image.fromarray(rgb)


def test_luma_and_hsv_over_all_colours_are_bitwise_pillow(colours):
    rgb, pil = colours
    np.testing.assert_array_equal(imaging.luma(rgb),
                                  np.asarray(pil.convert("L")))
    np.testing.assert_array_equal(imaging.rgb_to_hsv(rgb),
                                  np.asarray(pil.convert("HSV")))
    # every byte triple read as HSV
    np.testing.assert_array_equal(
        imaging.hsv_to_rgb(rgb),
        np.asarray(Image.fromarray(rgb, "HSV").convert("RGB")))


ENHANCE = {"brightness": ImageEnhance.Brightness,
           "contrast": ImageEnhance.Contrast, "color": ImageEnhance.Color}


@pytest.mark.parametrize("op", sorted(ENHANCE))
@pytest.mark.parametrize("factor", [0.0, 0.3, 0.6, 0.97, 1.0, 1.03, 1.4,
                                    2.5])
def test_enhance_over_all_colours_is_bitwise_pillow(colours, op, factor):
    """Below 1 the blend truncates, above 1 it also clips (Pillow's two
    branches of ``ImagingBlend``, an f32 factor)."""
    rgb, pil = colours
    np.testing.assert_array_equal(
        getattr(imaging, op)(rgb, factor),
        np.asarray(ENHANCE[op](pil).enhance(factor)))


@pytest.mark.parametrize("h", [-0.5, -0.1, -0.013, 0.05, 0.2, 0.5])
def test_hue_step_over_all_colours_is_bitwise_the_jax_step(colours, h):
    rgb, pil = colours
    hsv = np.array(pil.convert("HSV"), dtype=np.int16)
    hsv[..., 0] = (hsv[..., 0] + int(h * 255)) % 256
    want = Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")
    np.testing.assert_array_equal(imaging.hue(rgb, h), np.asarray(want))


def test_contrast_mean_is_pillows_rounded_stat():
    from PIL import ImageStat
    for seed in range(20):
        a = fx.photo(seed, 17 + seed, 9 + 2 * seed)
        want = int(ImageStat.Stat(Image.fromarray(a).convert("L")).mean[0]
                   + 0.5)
        assert imaging.grey_mean(a) == want


# ---------------------------------------------------------------------------
# blur and the sequential geometry
# ---------------------------------------------------------------------------

BLUR_SIZES = [(1, 1), (1, 7), (9, 1), (2, 3), (5, 5), (7, 13), (33, 21),
              (64, 48)]


@pytest.mark.parametrize("radius", [0.0] + [round(r, 2) for r in
                                            np.arange(0.5, 3.01, 0.25)])
def test_gaussian_blur_is_bitwise_pillow(radius):
    """Odd sizes, a single pixel, and frames narrower than the box (the
    edge rule repeats the end pixels)."""
    rng = np.random.default_rng(int(radius * 100))
    for h, w in BLUR_SIZES:
        a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = Image.fromarray(a).filter(ImageFilter.GaussianBlur(radius))
        np.testing.assert_array_equal(imaging.gaussian_blur(a, radius),
                                      np.asarray(want), err_msg=str((h, w)))


@pytest.mark.parametrize("deg", [-5, -4, -1, 1, 2, 5, 17, -33, 90, 180, 270,
                                 -90, 0, 360, 45])
def test_rotate_expand_is_bitwise_pillow(deg):
    rng = np.random.default_rng(deg % 97)
    for h, w in ((1, 1), (7, 9), (40, 33), (64, 64), (3, 60)):
        a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = np.asarray(Image.fromarray(a).rotate(deg, expand=True))
        got = imaging.rotate(a, deg)
        assert got.shape == want.shape, (h, w)
        np.testing.assert_array_equal(got, want)
        if deg % 90:
            assert j_tf._rot_canvas(w, h, deg) == (got.shape[1],
                                                   got.shape[0])


def test_flip_and_resize_are_bitwise_pillow():
    rng = np.random.default_rng(7)
    for h, w in ((1, 1), (7, 9), (40, 33), (61, 64)):
        a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        pil = Image.fromarray(a)
        np.testing.assert_array_equal(
            imaging.flip_left_right(a),
            np.asarray(pil.transpose(Image.FLIP_LEFT_RIGHT)))
        for size in ((3, 3), (2 * w, h), (max(1, w // 2), 3 * h),
                     (w + 1, h + 1), (w, h),
                     (max(1, int(w * 0.7)), int(h * 1.4) + 1)):
            np.testing.assert_array_equal(
                imaging.resize_bilinear(a, size),
                np.asarray(pil.resize(size, Image.BILINEAR)))


def test_ops_read_a_packed_clips_frames_in_place():
    base = np.random.default_rng(3).integers(0, 256, (20, 30, 12),
                                             dtype=np.uint8)
    for i in range(4):
        view = base[..., 3 * i:3 * i + 3]
        pil = Image.fromarray(np.ascontiguousarray(view))
        np.testing.assert_array_equal(
            imaging.gaussian_blur(view, 1.0),
            np.asarray(pil.filter(ImageFilter.GaussianBlur(1.0))))
        np.testing.assert_array_equal(
            imaging.contrast(view, 1.3),
            np.asarray(ImageEnhance.Contrast(pil).enhance(1.3)))
        np.testing.assert_array_equal(
            imaging.rotate(view, 3), np.asarray(pil.rotate(3, expand=True)))


# ---------------------------------------------------------------------------
# the chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("hue,flicker", [(0.0, 0.5), (0.1, 0.5), (0.1, 1.0)])
@pytest.mark.parametrize("packed", [False, True])
def test_train_v3_is_bitwise_the_jax_chain(fused, hue, flicker, packed):
    rng0 = np.random.default_rng(int(fused) * 10 + int(hue * 10))
    kw = dict(img_size=64, color_jitter=(0.4, 0.4, 0.4, hue),
              flicker=flicker, rotate_range=5, blur_radius=1, blur_prob=1.0,
              fused_geom=fused)
    jt = j_tff.transforms_deepfake_train_v3(**kw)
    tt = t_tff.transforms_deepfake_train_v3(**kw)
    for seed in range(6):
        base = rng0.integers(0, 256, (70, 76, 12), dtype=np.uint8)
        views = [base[..., 3 * i:3 * i + 3] for i in range(4)]
        if packed:
            j_in = j_tf.PackedFrames(views, base)
            t_in = t_tf.PackedFrames(views, base)
        else:
            j_in = [np.ascontiguousarray(v) for v in views]
            t_in = list(j_in)
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        want = np.asarray(jt(j_in, rj))
        got = np.asarray(tt(t_in, rt))
        assert got.shape == want.shape == (64, 64, 12)
        np.testing.assert_array_equal(got, want)
        assert rj.random() == rt.random()


def test_packed_clip_stays_one_buffer_through_an_idle_chain():
    """No blur coin, no flicker, no jitter: the warp's packed clip is the
    batch's sample itself (no concatenation copy), as in the JAX chain."""
    tt = t_tff.transforms_deepfake_train_v3(
        img_size=32, color_jitter=None, blur_prob=1e-9, flicker=1e-9)
    frames = [np.zeros((40, 40, 3), np.uint8)] * 4
    out = tt(frames, np.random.default_rng(0))
    assert out.shape == (32, 32, 12) and out.flags.c_contiguous


# ---------------------------------------------------------------------------
# the loaders
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return fx.make_tree(str(tmp_path_factory.mktemp("host_tree")))


def _host_batches(host, n=3):
    out = []
    for item in host:
        if isinstance(item, t_loader.HostBatch):
            out.append((item.images.numpy().copy(),
                        item.targets.numpy().copy()))
        else:
            out.append((np.asarray(item[0]), np.asarray(item[1])))
        if len(out) == n:
            break
    return out


@pytest.fixture
def npy_frames(monkeypatch):
    """The JAX dataset decodes the listed ``<i>.jpg``; the tree holds each
    frame as the ``<i>.npy`` beside that path, which the port reads."""
    monkeypatch.setattr(j_ds, "_load_images", lambda paths: [
        Image.fromarray(np.load(os.path.splitext(p)[0] + ".npy"))
        for p in paths])


LOADER_CASES = {
    # scripts/train.sh: mixup, so jitter, flicker and the blend on the host
    "train_sh": dict(collate=True),
    "host_geom": dict(collate=True, fused_geom=False),
    # no mixup: warp and blur on the host, jitter and flicker on the device
    "no_mixup": dict(collate=False),
    # --host-color-jitter without mixup: jitter on the host
    "host_jitter": dict(collate=False, device_color_jitter=False),
    # hue jitter: augment_device falls back to the whole host chain
    "hue": dict(collate=True, color_jitter=(0.4, 0.4, 0.4, 0.1),
                augment_device=True),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_first_host_batches_are_bitwise_jax(tree, npy_frames, case):
    kw = dict(LOADER_CASES[case])
    collate = kw.pop("collate")
    common = dict(is_training=True, re_prob=0.2, re_max=0.05, flicker=0.2,
                  rotate_range=5, blur_radius=1, blur_prob=0.5,
                  num_workers=2, seed=42)
    common.setdefault("color_jitter", 0.4)
    common.update(kw)
    jl = j_loader.create_deepfake_loader_v3(
        j_ds.DeepFakeClipDataset(tree, label_balance=True),
        fx.TREE_INPUT, 3, dtype=jnp.float32,
        collate_mixup=j_mixup.FastCollateMixup(0.1, 0.1, 2)
        if collate else None, **common)
    tl = t_loader.create_deepfake_loader_v3(
        t_ds.DeepFakeClipDataset(tree, label_balance=True),
        fx.TREE_INPUT, 3, device="cpu",
        collate_mixup=t_mixup.FastCollateMixup(0.1, 0.1, 2)
        if collate else None, **common)
    assert tl.prologue.spec is None
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        want, got = _host_batches(jl.loader), _host_batches(tl.loader)
        assert len(got) == len(want) == 3
        for (xj, yj), (xt, yt) in zip(want, got):
            np.testing.assert_array_equal(xt, xj)
            np.testing.assert_array_equal(yt, yj)


def test_loader_prologue_output_matches_jax(tree, npy_frames):
    """The normalised batches (no erasing) within 1e-6 of the JAX
    prologue's."""
    argv = fx.TRAIN_SH_FLAGS + ["--data", tree, "--reprob", "0"]
    jcfg = j_config.TrainConfig.from_args(argv + ["--compute-dtype",
                                                  "float32"])
    jtrain, _ = j_runner.build_datasets(jcfg, fx.TREE_INPUT)
    jl = j_loader.create_deepfake_loader_v3(
        jtrain, fx.TREE_INPUT, 3, is_training=True,
        color_jitter=jcfg.color_jitter,
        collate_mixup=j_mixup.FastCollateMixup(0.1, 0.1, 2),
        flicker=jcfg.flicker, rotate_range=5, blur_radius=1,
        blur_prob=jcfg.blur_prob, dtype=jnp.float32, num_workers=2,
        seed=42)
    cfg = runner.parse_args(argv + ["--device", "cpu", "--compute-dtype",
                                    "float32"])
    tl, _ = runner.build_loaders(cfg, torch.device("cpu"),
                                 *runner.build_datasets(cfg))
    jl.set_epoch(0)
    tl.set_epoch(0)
    n = 0
    for (xj, yj), (xt, yt) in zip(jl, tl):
        xt = xt.permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        assert np.abs(xt - np.asarray(xj)).max() <= 1e-6
        n += 1
        if n == 2:
            break
    assert n == 2


def test_conflicting_loader_flags_raise_as_jax(tree):
    ds = t_ds.DeepFakeClipDataset(tree)
    kw = dict(is_training=True, device="cpu", augment_device=True)
    with pytest.raises(ValueError, match="fused_geom=False"):
        t_loader.create_deepfake_loader_v3(ds, fx.TREE_INPUT, 3,
                                           fused_geom=False, **kw)
    with pytest.raises(ValueError, match="host_color_jitter"):
        t_loader.create_deepfake_loader_v3(ds, fx.TREE_INPUT, 3,
                                           device_color_jitter=False, **kw)


def test_digests_hold_for_the_port(tree):
    """Every committed case and loader digest, recomputed by the port."""
    d = fx.load_digests()
    assert sorted(d["cases"]) == sorted(fx.CASES)
    bad = [n for n in fx.CASES if fx.sha(fx.port_case(n)) != d["cases"][n]]
    assert not bad, bad
    for name, extra in fx.LOADERS.items():
        assert fx.port_batches(tree, extra) == d["loaders"][name], name


def test_digests_are_pillows_and_the_jax_packages(tree):
    """The committed digests are the reference's: Pillow (the version
    recorded) and the JAX package, recomputed here."""
    import PIL
    d = fx.load_digests()
    assert d["pillow"] == PIL.__version__
    bad = [n for n in fx.CASES
           if fx.sha(fx.reference_case(n)) != d["cases"][n]]
    assert not bad, bad
    for name, extra in fx.LOADERS.items():
        assert fx.reference_batches(tree, extra) == d["loaders"][name], name


# ---------------------------------------------------------------------------
# no Pillow, no fallback
# ---------------------------------------------------------------------------

# the modules of the train path; the port's other Pillow imports are lazy
# ones for input formats its JPEG decoder declines (data/dataset.py,
# serving/http.py, streaming/ingest.py), which the card's inputs never take
TRAIN_PATH = ["data/imaging.py", "data/native.py", "data/transforms.py",
              "data/transforms_factory.py", "data/loader.py",
              "data/mixup.py", "data/device_augment.py",
              "data/random_erasing.py", "data/packed.py",
              "data/resample.py", "runners/train.py"]


def test_train_path_imports_no_pillow():
    for name in TRAIN_PATH:
        path = REPO / "deepfake_detection_tpu_torch" / name
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            assert not any(n.split(".")[0] == "PIL" for n in names), path


def test_chain_runs_with_pillow_absent(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    for fused in (True, False):
        t = t_tff.transforms_deepfake_train_v3(
            img_size=32, color_jitter=(0.4, 0.4, 0.4, 0.1), flicker=0.3,
            rotate_range=5, blur_radius=1, blur_prob=1.0, fused_geom=fused)
        frames = [fx.photo(i, 40, 44) for i in range(4)]
        assert t(frames, np.random.default_rng(0)).shape == (32, 32, 12)


#: what every decode and image op raises when the library cannot build
UNAVAILABLE = "native library .* is unavailable"


def test_missing_compiler_raises_and_nothing_falls_back(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "_default_pool", None)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-c++"))
    a = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(RuntimeError, match=UNAVAILABLE):
        imaging.brightness(a, 0.5)
    with pytest.raises(RuntimeError, match=UNAVAILABLE):
        native.warp_affine_batch([a], (1, 0, 0, 0, 1, 0), (4, 4))
    t = t_tff.transforms_deepfake_train_v3(img_size=4, color_jitter=None)
    with pytest.raises(RuntimeError, match=UNAVAILABLE):
        t([a] * 4, np.random.default_rng(0))
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_is_built_without_fp_contraction_into_build_native():
    info = native.build_info()
    lib = info["library"]
    assert os.path.dirname(lib).endswith(os.path.join("build", "native"))
    assert os.path.basename(lib) == native._target().name
    assert os.path.basename(lib).startswith("dfd_native-")
    assert [s.name for s in native._SRCS] == ["jpeg_decode.cc", "imaging.cc"]
    assert "-ffp-contract=off" in native._FLAGS
    assert not any("fast-math" in f or "march" in f for f in native._FLAGS)


# ---------------------------------------------------------------------------
# train steps through the host chain
# ---------------------------------------------------------------------------

MODEL = "efficientnet_deepfake_v4"
KW = dict(channel_multiplier=0.25, depth_multiplier=0.34)
STEP_ARGS = ["--model", MODEL, "--model-version", "v4", "--input-size-v2",
             "12,64,64", "-b", "3", "--opt", "rmsproptf", "--lr", "1e-2",
             "--clip-grad", "0.5", "--bn-momentum", "0.1", "--label-balance",
             "--rotate-range", "5", "--blur-prob", "0.5", "--flicker", "0.2",
             "--mixup", "0.1", "--workers", "2", "--reprob", "0",
             "--seed", "4", "--augment-device", "off", "--compute-dtype",
             "float32"]
STEPS = 3


@pytest.fixture(scope="module")
def host_steps(tmp_path_factory):
    """Three steps of the reduced flagship (a quarter width, 10 blocks) at
    12×64² from one tree, each runner fed by its own loader through the
    host chain, from the same weights."""
    root = fx.make_tree(str(tmp_path_factory.mktemp("steps_tree")))
    argv = STEP_ARGS + ["--data", root]
    jcfg = j_config.TrainConfig.from_args(argv)
    jm = j_create_model(MODEL, num_classes=2, in_chans=12, bn_momentum=0.1,
                        **KW)
    variables = jax.tree.map(
        lambda a: np.array(a, np.float32),
        j_init_model(jm, jax.random.PRNGKey(4), (1, 64, 64, 12),
                     training=True))
    load = j_ds._load_images
    j_ds._load_images = lambda paths: [
        Image.fromarray(np.load(os.path.splitext(p)[0] + ".npy"))
        for p in paths]
    try:
        jtrain, _ = j_runner.build_datasets(jcfg, (12, 64, 64))
        jl = j_loader.create_deepfake_loader_v3(
            jtrain, (12, 64, 64), 3, is_training=True,
            color_jitter=jcfg.color_jitter,
            collate_mixup=j_mixup.FastCollateMixup(jcfg.mixup,
                                                   jcfg.smoothing, 2),
            flicker=jcfg.flicker, rotate_range=jcfg.rotate_range,
            blur_radius=1, blur_prob=jcfg.blur_prob, augment_device=False,
            dtype=jnp.float32, num_workers=jcfg.workers, seed=jcfg.seed)
        jl.set_epoch(0)
        j_batches = []
        for x, y in jl:
            j_batches.append((np.asarray(x), np.asarray(y)))
            if len(j_batches) == STEPS:
                break
    finally:
        j_ds._load_images = load
    tx = j_create_opt(jcfg, learning_rate=jcfg.lr)
    jstep = j_make_step(jm, tx, j_losses.create_loss_fn(jcfg),
                        clip_grad=jcfg.clip_grad, nonfinite_guard=True,
                        donate=False)
    js = j_state(jax.tree.map(jnp.asarray, variables), tx, donate=False)
    cfg = runner.parse_args(argv + ["--device", "cpu"])
    init = state_dict_from_flax(variables)
    build = runner.build_model

    def build_cut(c, device):
        model = create_model(MODEL, num_classes=2, in_chans=12,
                             bn_momentum=0.1, device=device, **KW)
        model.load_state_dict(init, strict=True)
        return model
    runner.build_model = build_cut
    try:
        run = runner.setup(cfg)
    finally:
        runner.build_model = build
    run.train_loader.set_epoch(0)
    t_batches = []
    for x, y in run.train_loader:
        t_batches.append((x, y))
        if len(t_batches) == STEPS:
            break
    j_out, t_out = [], []
    for (xj, yj), (xt, yt) in zip(j_batches, t_batches):
        js, m = jstep(js, jnp.asarray(xj), jnp.asarray(yj),
                      jax.random.PRNGKey(0))
        j_out.append((float(m["loss"]), {
            k: v.numpy() for k, v in state_dict_from_flax(jax.tree.map(
                lambda a: np.array(a, np.float32),
                {"params": js.params,
                 "batch_stats": js.batch_stats})).items()}))
        m = run.train_step(run.state, xt, yt)
        t_out.append((float(m["loss"]), {
            k: v.detach().numpy().copy()
            for k, v in run.state.model.state_dict().items()}))
    return dict(j=j_out, t=t_out,
                init={k: v.numpy() for k, v in init.items()},
                j_batches=j_batches,
                t_batches=[(x.permute(0, 2, 3, 1).numpy(), y.numpy())
                           for x, y in t_batches])


def test_host_chain_batches_of_the_runners_match(host_steps):
    for (xj, yj), (xt, yt) in zip(host_steps["j_batches"],
                                  host_steps["t_batches"]):
        np.testing.assert_array_equal(yt, yj)
        assert np.abs(xt - xj).max() <= 1e-6


@pytest.mark.parametrize("after", [1, STEPS])
def test_flagship_steps_through_the_host_chain_match_jax(host_steps, after):
    for i in range(after):
        lt, lj = host_steps["t"][i][0], host_steps["j"][i][0]
        assert np.isfinite(lt) and abs(lt - lj) <= 1e-4 * abs(lj), (i, lt,
                                                                     lj)
    got, want = host_steps["t"][after - 1][1], host_steps["j"][after - 1][1]
    init = host_steps["init"]
    moved = 0
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var",
                       "num_batches_tracked")):
            continue
        _close_change(got[k], w, init[k], k, after)
        moved += bool(np.any(w != init[k]))
    assert moved > 50

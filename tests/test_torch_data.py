"""PyTorch port, the clip data path on CPU against the JAX package.

The tree, built in ``tmp_path`` by :func:`make_clip_tree`: ``real/`` and
``fake/`` clips of 40×48 frames, more fakes than reals, some clips shorter
than 4 frames, lists written by ``tools/make_lists.py``'s ``write_list``.
Each frame is a JPEG (the JAX package decodes it) with, beside it, the
``.npy`` that the JAX package's own ``_load_images`` decodes it to (the
port reads that), so both packages see the same pixels.

Bitwise against the JAX package:

* the lists, the seeded split, the label-balance buckets and
  ``sample_clip`` over three epochs, with ``frac`` and ``n`` subsetting;
* each sample's uint8 clip and label through the train passthrough (and
  the generator's position after it), with ``noise_fake``;
* the eval random and centre crops, with and without padding;
* the epoch batches of both samplers, and ``train_batches`` /
  ``eval_batches``;
* the collate mixup's lambda and soft targets with ``blend=False``;
* a port ``PackedDataset`` over a pack the JAX ``write_pack`` wrote,
  against the JAX ``PackedDataset`` and the port's frame path, and the
  port's ``write_pack`` writing the JAX pack's bytes;
* the whole train prologue: the port's loader against the JAX
  ``create_deepfake_loader_v3(..., augment_device=True, dtype=float32)``
  over two epochs with 1 and 4 workers (rotation, blur, mixup; jitter and
  erasing off, held through their replayed draws in
  ``test_torch_device_augment.py``), and the eval loader.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from deepfake_detection_tpu.data import dataset as j_ds
from deepfake_detection_tpu.data import loader as j_loader
from deepfake_detection_tpu.data import mixup as j_mixup
from deepfake_detection_tpu.data import packed as j_packed
from deepfake_detection_tpu.data import samplers as j_samplers
from deepfake_detection_tpu.data import transforms_factory as j_tff
from deepfake_detection_tpu_torch.data import dataset as t_ds
from deepfake_detection_tpu_torch.data import loader as t_loader
from deepfake_detection_tpu_torch.data import mixup as t_mixup
from deepfake_detection_tpu_torch.data import packed as t_packed
from deepfake_detection_tpu_torch.data import samplers as t_samplers
from deepfake_detection_tpu_torch.data import transforms_factory as t_tff
from deepfake_detection_tpu_torch.params import img_std
from tools.make_lists import scan_clips, write_list

torch.set_num_threads(2)

H, W, F = 40, 48, 4
CROP = 32


def make_clip_tree(root: str, n_real: int = 4, n_fake: int = 9,
                   hw=(H, W), seed: int = 0) -> str:
    """A seeded clip tree: JPEG frames, the JAX package's decode of each
    as ``.npy`` beside it, and the two list files."""
    rng = np.random.default_rng(seed)
    for kind, n in (("real", n_real), ("fake", n_fake)):
        for c in range(n):
            nf = (2, 3, 4, 5, 6)[c % 5]          # some clips shorter than 4
            d = os.path.join(root, kind, f"c{c:02d}")
            os.makedirs(d, exist_ok=True)
            paths = []
            for i in range(nf):
                # smooth content, so the JPEG keeps structure to warp
                base = rng.integers(0, 256, (hw[0] // 4, hw[1] // 4, 3),
                                    dtype=np.uint8)
                img = np.kron(base, np.ones((4, 4, 1), np.uint8))
                p = os.path.join(d, f"{i}.jpg")
                Image.fromarray(img).save(p, quality=90)
                paths.append(p)
            for p, a in zip(paths, j_ds._load_images(paths)):
                np.save(os.path.splitext(p)[0] + ".npy",
                        np.asarray(a, np.uint8))
        write_list(os.path.join(root, f"{kind}_list.txt"),
                   scan_clips(os.path.join(root, kind)))
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_clip_tree(str(tmp_path_factory.mktemp("clips")))


DS_CASES = [dict(label_balance=True),
            dict(label_balance=False, noise_fake=True),
            dict(train_split=True, train_ratio=0.7, is_training=True,
                 label_balance=True, split_seed=5),
            dict(train_split=True, train_ratio=0.7, is_training=False,
                 split_seed=5),
            dict(frac=0.6, split_seed=2, label_balance=True),
            dict(n=3, split_seed=2)]


@pytest.mark.parametrize("kw", DS_CASES)
def test_lists_split_buckets_and_sample_clip_match_jax(tree, kw):
    jd = j_ds.DeepFakeClipDataset(tree, frames_per_clip=F, **kw)
    td = t_ds.DeepFakeClipDataset(tree, frames_per_clip=F, **kw)
    assert t_ds.read_clip_list(os.path.join(tree, "fake_list.txt")) == \
        j_ds.read_clip_list(os.path.join(tree, "fake_list.txt"))
    assert td.real_clips == jd.real_clips
    assert td.fake_buckets == jd.fake_buckets
    assert len(td) == len(jd) > 0
    if kw.get("label_balance") and not kw.get("train_split"):
        assert len(td.fake_buckets) == len(td.real_clips)
    for epoch in range(3):
        for i in range(len(td)):
            assert td.sample_clip(i, epoch) == jd.sample_clip(i, epoch)
            assert td.sample_paths(i, epoch) == jd.sample_paths(i, epoch)


@pytest.mark.parametrize("noise_fake", [False, True])
def test_passthrough_samples_and_labels_are_bitwise(tree, noise_fake):
    kw = dict(frames_per_clip=F, label_balance=True, noise_fake=noise_fake)
    jd = j_ds.DeepFakeClipDataset(tree, **kw)
    td = t_ds.DeepFakeClipDataset(tree, **kw)
    jd.set_transform(j_tff.transforms_deepfake_train_passthrough(
        CROP, rotate_range=5, blur_prob=0.3))
    td.set_transform(t_tff.transforms_deepfake_train_passthrough(
        CROP, rotate_range=5, blur_prob=0.3))
    flipped = 0
    for epoch in range(3):
        jd.set_epoch(epoch)
        td.set_epoch(epoch)
        for i in range(len(td)):
            g_j = np.random.default_rng(np.random.SeedSequence([1, epoch, i]))
            g_t = np.random.default_rng(np.random.SeedSequence([1, epoch, i]))
            xj, yj = jd.__getitem__(i, rng=g_j)
            xt, yt = td.__getitem__(i, rng=g_t)
            assert xt.dtype == np.uint8 and xt.shape == (H, W, 3 * F)
            np.testing.assert_array_equal(xt, xj)
            assert yt == yj
            assert g_t.random() == g_j.random()
            flipped += jd.sample_clip(i)[2] != yt
    assert (flipped > 0) == noise_fake


@pytest.mark.parametrize("crop", ["random", "center"])
@pytest.mark.parametrize("size", [CROP, 44])          # 44 > 40: pads
def test_eval_crops_are_bitwise(tree, crop, size):
    jd = j_ds.DeepFakeClipDataset(tree, frames_per_clip=F)
    td = t_ds.DeepFakeClipDataset(tree, frames_per_clip=F)
    jd.set_transform(j_tff.transforms_deepfake_eval_v3(size, crop=crop))
    td.set_transform(t_tff.transforms_deepfake_eval_v3(size, crop=crop))
    for i in range(len(td)):
        xj, _ = jd.__getitem__(i, rng=np.random.default_rng(i))
        xt, _ = td.__getitem__(i, rng=np.random.default_rng(i))
        np.testing.assert_array_equal(xt, np.asarray(xj))


@pytest.mark.parametrize("n,batch", [(13, 3), (8, 2), (5, 4)])
def test_samplers_match_jax(n, batch):
    for shards, drop in ((1, True), (2, True), (2, False)):
        for si in range(shards):
            js = j_samplers.ShardedTrainSampler(n, shards, si, batch, 7, drop)
            ts = t_samplers.ShardedTrainSampler(n, shards, si, batch, 7, drop)
            for epoch in range(3):
                js.set_epoch(epoch)
                ts.set_epoch(epoch)
                assert t_samplers.epoch_batches(ts, batch) == \
                    j_samplers.epoch_batches(js, batch)
                assert len(ts) == len(js)
            je = j_samplers.OrderedShardedSampler(n, shards, si, batch)
            te = t_samplers.OrderedShardedSampler(n, shards, si, batch)
            (jb, jv), (tb, tv) = (j_samplers.epoch_batches(je, batch, True),
                                  t_samplers.epoch_batches(te, batch, True))
            assert tb == jb
            for a, b in zip(tv, jv):
                np.testing.assert_array_equal(a, b)
    js = j_samplers.ShardedTrainSampler(n, batch_size=batch, seed=7)
    js.set_epoch(2)
    want, _ = j_samplers.epoch_batches(js, batch)
    assert [b.tolist() for b in t_loader.train_batches(n, batch, 7, 2)] == \
        want
    je = j_samplers.OrderedShardedSampler(n, batch_size=batch)
    want, wv = j_samplers.epoch_batches(je, batch, True)
    got = t_loader.eval_batches(n, batch)
    assert [b.tolist() for b, _ in got] == want
    for (_, v), w in zip(got, wv):
        np.testing.assert_array_equal(v, w)


def test_mixup_lambda_and_targets_match_jax():
    labels = np.array([0, 1, 1, 0, 1, 0], np.int64)
    images = np.random.default_rng(0).integers(0, 256, (6, 4, 4, 12),
                                               dtype=np.uint8)
    jm = j_mixup.FastCollateMixup(0.1, 0.1, 2, blend=False)
    tm = t_mixup.FastCollateMixup(0.1, 0.1, 2, blend=False)
    for bi in range(20):
        seq = [3, 1, bi, 0x77]
        xj, yj = jm(images, labels,
                    np.random.default_rng(np.random.SeedSequence(seq)))
        xt, yt = tm(images, labels,
                    np.random.default_rng(np.random.SeedSequence(seq)))
        assert xt is images and xj is images          # targets only
        np.testing.assert_array_equal(yt, yj)
        assert yt.dtype == np.float32


@pytest.fixture(scope="module")
def jax_pack(tree, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pack"))
    j_packed.write_pack(tree, out, shard_size=4, workers=2)
    return out


@pytest.mark.parametrize("kw", [dict(label_balance=True),
                                dict(train_split=True, train_ratio=0.7,
                                     is_training=True, noise_fake=True)])
def test_port_reads_the_jax_pack_bitwise(tree, jax_pack, kw):
    assert t_packed.verify_pack(jax_pack) == []
    jp = j_packed.PackedDataset(jax_pack, roots=tree, frames_per_clip=F,
                                **kw)
    tp = t_packed.PackedDataset(jax_pack, roots=tree, frames_per_clip=F,
                                **kw)
    td = t_ds.DeepFakeClipDataset(tree, frames_per_clip=F, **kw)
    assert tp.packed_hw == jp.packed_hw == (H, W)
    assert tp.fake_buckets == jp.fake_buckets == td.fake_buckets
    tf = t_tff.transforms_deepfake_train_passthrough(CROP, rotate_range=5)
    tp.set_transform(tf)
    td.set_transform(tf)
    for epoch in range(2):
        for d in (jp, tp, td):
            d.set_epoch(epoch)
        for i in range(len(tp)):
            np.testing.assert_array_equal(tp.sample_array(i),
                                          jp.sample_array(i))
            seq = np.random.SeedSequence([2, epoch, i])
            xp, yp = tp.__getitem__(i, rng=np.random.default_rng(seq))
            xd, yd = td.__getitem__(i, rng=np.random.default_rng(seq))
            np.testing.assert_array_equal(xp, xd)
            assert yp == yd


def test_port_write_pack_writes_the_jax_pack(tree, jax_pack, tmp_path):
    out = str(tmp_path / "pack")
    index = t_packed.write_pack(tree, out, shard_size=4, workers=2)
    want = j_packed.load_index(jax_pack)
    assert index["fingerprint"] == want["fingerprint"]
    assert index["clips"] == want["clips"]
    assert index["shards"] == want["shards"]          # names, counts, sha256
    assert t_packed.write_pack(tree, out, shard_size=4) == \
        t_packed.load_index(out)                      # up to date: no-op
    with open(os.path.join(out, "shard-00000.bin"), "r+b") as f:
        f.truncate(10)
    with pytest.raises(t_packed.PackedShardCorrupt, match="shard-00000"):
        t_packed.PackedDataset(out)
    with open(os.path.join(tree, "real_list.txt")) as f:
        lines = f.read()
    try:
        with open(os.path.join(tree, "real_list.txt"), "w") as f:
            f.write(lines + "c99:4\n")
        with pytest.raises(t_packed.PackedCacheStale, match="changed"):
            t_packed.PackedDataset(jax_pack, roots=tree)
    finally:
        with open(os.path.join(tree, "real_list.txt"), "w") as f:
            f.write(lines)


def _batches(loader, epochs):
    out = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        out += [tuple(np.asarray(t) for t in b) for b in loader]
    return out


@pytest.mark.parametrize("workers", [1, 4])
def test_whole_train_prologue_matches_jax(tree, workers):
    """Two epochs of the train loader: rotation ±5°, blur 0.5, mixup 0.1,
    label balance.  Labels and soft targets bitwise; the images within the
    fractional warp's tolerance (the blend adds lam times a warp
    difference), at most 1e-4 of the values differing."""
    kw = dict(frames_per_clip=F, label_balance=True)
    jl = j_loader.create_deepfake_loader_v3(
        j_ds.DeepFakeClipDataset(tree, **kw), (3 * F, CROP, CROP), 2,
        is_training=True, collate_mixup=j_mixup.FastCollateMixup(0.1, 0.1, 2),
        rotate_range=5, blur_radius=1, blur_prob=0.5, color_jitter=None,
        augment_device=True, dtype=jnp.float32, num_workers=workers, seed=3)
    tl = t_loader.create_deepfake_loader_v3(
        t_ds.DeepFakeClipDataset(tree, **kw), (3 * F, CROP, CROP), 2,
        is_training=True, device="cpu",
        collate_mixup=t_mixup.FastCollateMixup(0.1, 0.1, 2),
        rotate_range=5, blur_radius=1, blur_prob=0.5, color_jitter=None,
        num_workers=workers, seed=3)
    want, got = _batches(jl, 2), _batches(tl, 2)
    assert len(got) == len(want) == 2 * (8 // 2)
    std = np.tile(img_std, F)
    for (xj, yj), (xt, yt) in zip(want, got):
        assert xt.shape == (2, 3 * F, CROP, CROP)
        xt = xt.transpose(0, 2, 3, 1)                 # NCHW view → NHWC
        np.testing.assert_array_equal(yt, yj)
        d = np.abs(xt - xj) * std                     # back to grey levels
        assert (d > 1e-3).mean() <= 1e-4 and d.max() <= 1.0 + 1e-3, \
            ((d > 1e-3).mean(), d.max())


@pytest.mark.parametrize("crop", ["random", "center"])
def test_eval_loader_matches_jax(tree, crop):
    kw = dict(frames_per_clip=F, train_split=True, train_ratio=0.5,
              is_training=False, split_seed=1)
    jl = j_loader.create_deepfake_loader_v3(
        j_ds.DeepFakeClipDataset(tree, **kw), (3 * F, CROP, CROP), 4,
        is_training=False, eval_crop=crop, dtype=jnp.float32, seed=3)
    tl = t_loader.create_deepfake_loader_v3(
        t_ds.DeepFakeClipDataset(tree, **kw), (3 * F, CROP, CROP), 4,
        is_training=False, device="cpu", eval_crop=crop, seed=3)
    want, got = _batches(jl, 1), _batches(tl, 1)
    assert len(got) == len(want) >= 2
    for (xj, yj, vj), (xt, yt, vt) in zip(want, got):
        np.testing.assert_array_equal(xt.transpose(0, 2, 3, 1), xj)
        np.testing.assert_array_equal(yt, yj)
        np.testing.assert_array_equal(vt, vj)
    assert not got[-1][2].all()                       # wrap padding masked


def test_mixed_frame_sizes_and_missing_pillow_raise(tree, tmp_path,
                                                     monkeypatch):
    root = make_clip_tree(str(tmp_path / "mixed"), n_real=1, n_fake=2)
    clip = os.path.join(root, "fake", "c01")
    np.save(os.path.join(clip, "1.npy"), np.zeros((36, W, 3), np.uint8))
    td = t_ds.DeepFakeClipDataset(root, frames_per_clip=F)
    td.set_transform(t_tff.transforms_deepfake_train_passthrough(CROP))
    with pytest.raises(ValueError, match="one source frame shape"):
        td.__getitem__(1, rng=np.random.default_rng(0))
    os.remove(os.path.join(clip, "0.npy"))
    monkeypatch.setitem(sys.modules, "PIL", None)
    # the JPEG frame decodes with the port's own decoder, no Pillow: the
    # clip still mixes sizes
    with pytest.raises(ValueError, match="one source frame shape"):
        td.__getitem__(1, rng=np.random.default_rng(0))
    png = os.path.join(clip, "0.png")
    monkeypatch.delitem(sys.modules, "PIL")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(png)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="needs Pillow"):
        t_ds.read_frame(png)

"""PyTorch port, the JPEG decoder on the CPU, and every entry point fed JPEG.

The decoder (``deepfake_detection_tpu_torch/native/jpeg_decode.cc`` through
``data/native.py``) against the JAX package's native pool
(``deepfake_detection_tpu/data/native.py``: libjpeg-turbo with ISLOW and
fancy upsampling) and against Pillow's ``convert("RGB")`` (its bundled
libjpeg-turbo), **bitwise**:

* a grid of subsampling × quality × progressive × optimize × restart
  markers, and gray, Adobe RGB, 4:4:0 and odd and tiny sizes;
* the committed fixtures (``tests/data/jpeg``, written by
  ``tests/torch_jpeg_fixtures.py``): the JAX pool's decode hashes to the
  committed digest and so does the port's; the CMYK fixture is declined by
  both;
* the declined set (4 components, 12-bit, arithmetic coding, lossless, a
  truncated progressive stream, not a JPEG) is None with its reason;
* truncations and bit flips (the committed sweeps, every single-bit flip
  of small files, and seeded multi-byte damage): a baseline stream decodes
  to the JAX pool's array wherever that pool returns one and is None where
  it is None; a progressive stream is the same or declined (libjpeg's
  block smoothing of an incomplete progression is not ported, nor is
  arithmetic coding, which a flipped SOF2 byte can select); never a crash;
* extreme coefficients (int16 range, 16-bit quantisers) in hand-built
  streams, where libjpeg-turbo's SIMD IDCT wraps and saturates;
* the pool against serial decodes at 1, 4 and 8 threads; a missing
  compiler raises, and nothing falls back to Pillow silently.

Then, with Pillow's import blocked on the port's side
(``sys.modules["PIL"] = None``): a ``.jpg``-only clip tree's samples are
the JAX ``DeepFakeClipDataset``'s; ``runners.train``'s first batches from
it are bitwise those from the ``.npy`` tree of its decodes; ``write_pack``
of it writes the JAX ``write_pack``'s shards; ``runners.test`` on ``.jpg``
files agrees with the JAX CLI within 1e-4 (``test_torch_cli.py``'s
tolerance); ``POST /score`` with multipart and ``frames_b64`` JPEGs answers
200 within 1e-5 of the JAX server and bitwise the port's ``.npy`` wire;
MJPEG, ``image/jpeg`` and concatenated-JPEG stream chunks give windows
bitwise those of the raw wire; a backfill of the JPEG tree writes the
verdicts of the ``.npy`` tree.
"""

import base64
import hashlib
import io
import itertools
import json
import os
import shutil
import struct
import sys
import urllib.error

import numpy as np
import pytest
import torch
from PIL import Image

import torch_jpeg_fixtures as fx
from deepfake_detection_tpu.data import dataset as j_ds
from deepfake_detection_tpu.data import native as j_native
from deepfake_detection_tpu.data import transforms_factory as j_tff
from deepfake_detection_tpu.data.packed import write_pack as j_write_pack
from deepfake_detection_tpu.models.helpers import save_model_checkpoint
from deepfake_detection_tpu.runners import test as j_cli
from deepfake_detection_tpu_torch.data import dataset as t_ds
from deepfake_detection_tpu_torch.data import native
from deepfake_detection_tpu_torch.data import transforms_factory as t_tff
from deepfake_detection_tpu_torch.data.packed import write_pack as t_write_pack
from deepfake_detection_tpu_torch.models import create_deepfake_model_v4
from deepfake_detection_tpu_torch.runners import test as t_cli
import test_torch_serving as ts
from test_torch_serving import jax_side, servers, state  # noqa: F401
from tools.convert_torch_checkpoint import convert_state_dict

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "jpeg")
DIGESTS = json.load(open(os.path.join(FIXTURES, "digests.json")))
SMOOTHING = "progressive stream truncated"
ARITHMETIC = "arithmetic coding"


def _fixture(name: str) -> bytes:
    with open(os.path.join(FIXTURES, f"{name}.jpg"), "rb") as f:
        return f.read()


def _port(data: bytes):
    reasons: list = []
    return native.decode_jpeg_bytes(data, reasons=reasons), reasons[0]


def _pil(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def _same(a, b) -> bool:
    return a is not None and b is not None and a.shape == b.shape \
        and np.array_equal(a, b)


@pytest.fixture(scope="module", autouse=True)
def jax_pool_built():
    assert j_native.available(), "the JAX native pool (libjpeg) must build"


# ---------------------------------------------------------------------------
# the decoder, bitwise
# ---------------------------------------------------------------------------

GRID = list(itertools.product((0, 1, 2), (50, 90, 100), (False, True),
                              (False, True), (0, 2)))


@pytest.mark.parametrize("sub,quality,progressive,optimize,restart", GRID)
def test_bitwise_jax_and_pillow_grid(sub, quality, progressive, optimize,
                                     restart):
    arr = fx.smooth_image(56, 72, seed=len(GRID) + sub * 7 + quality)
    kw = dict(quality=quality, subsampling=sub, progressive=progressive,
              optimize=optimize)
    if restart:
        kw["restart_marker_blocks"] = restart
    data = fx.encode(arr, **kw)
    got, why = _port(data)
    assert why is None
    assert _same(got, j_native.decode_jpeg_bytes(data))
    assert _same(got, _pil(data))


SPECIAL = {
    "gray": ((48, 40), True, dict(quality=90), None),
    "gray_progressive": ((48, 40), True, dict(quality=80, progressive=True),
                         None),
    "adobe_rgb": ((48, 40), False, dict(quality=90, keep_rgb=True), None),
    "adobe_rgb_progressive": ((48, 40), False,
                              dict(quality=90, keep_rgb=True,
                                   progressive=True), None),
    "s440": ((48, 40), False, dict(quality=85, subsampling=1), "440"),
    "odd_420": ((479, 601), False, dict(quality=90, subsampling=2), None),
    "odd_422": ((33, 50), False, dict(quality=90, subsampling=1), None),
    "tiny_420": ((9, 17), False, dict(quality=90, subsampling=2), None),
    "tiny_444": ((17, 9), False, dict(quality=90, subsampling=0), None),
    "tiny_progressive": ((9, 17), False,
                         dict(quality=90, subsampling=2, progressive=True),
                         None),
    "two_by_three": ((2, 3), False, dict(quality=90, subsampling=2), None),
    "one_420": ((1, 1), False, dict(quality=90, subsampling=2), None),
    "one_444": ((1, 1), False, dict(quality=75, subsampling=0), None),
    "noise_q100": ((64, 64), False, dict(quality=100, subsampling=2),
                   "noise"),
}


@pytest.mark.parametrize("name", sorted(SPECIAL))
def test_bitwise_special_streams(name):
    (h, w), gray, kw, extra = SPECIAL[name]
    if extra == "440":
        data = fx.to_440(fx.encode(fx.smooth_image(w, h, 5), **kw))
    elif extra == "noise":
        arr = np.random.default_rng(6).integers(0, 256, (h, w, 3), np.uint8)
        data = fx.encode(arr, **kw)
    else:
        data = fx.encode(fx.smooth_image(h, w, 7, gray), **kw)
    got, why = _port(data)
    assert why is None and got.shape == (h, w, 3)
    assert _same(got, j_native.decode_jpeg_bytes(data))
    assert _same(got, _pil(data))


@pytest.mark.parametrize("name", sorted(DIGESTS["fixtures"]))
def test_committed_fixture_digests(name):
    """The JAX pool's decode here hashes to the committed digest, and so
    does the port's; a declined fixture is None in both."""
    entry = DIGESTS["fixtures"][name]
    data = _fixture(name)
    want = j_native.decode_jpeg_bytes(data)
    got, why = _port(data)
    if entry["sha256"] == "declined":
        assert want is None and got is None
        assert why == "4 components (CMYK/YCCK)"
        return
    assert fx.sha(want) == entry["sha256"]
    assert list(got.shape) == entry["shape"]
    assert fx.sha(got) == entry["sha256"]
    assert fx.make(name) == data     # the script still writes this fixture


def _with_sof(data: bytes, marker=None, precision=None) -> bytes:
    b = bytearray(data)
    i = fx.segment(b, 0xC0)
    if marker is not None:
        b[i + 1] = marker
    if precision is not None:
        b[i + 4] = precision
    return bytes(b)


DECLINED = {
    "cmyk": (lambda: _fixture("cmyk"), "4 components"),
    "12bit": (lambda: _with_sof(_fixture("s444_q95"), precision=12),
              "precision"),
    "arithmetic": (lambda: _with_sof(_fixture("s444_q95"), marker=0xC9),
                   ARITHMETIC),
    "lossless": (lambda: _with_sof(_fixture("s444_q95"), marker=0xC3),
                 "lossless"),
    "progressive_truncated": (lambda: _fixture("prog420")[:2400], SMOOTHING),
    "not_a_jpeg": (lambda: b"\x89PNG\r\n\x1a\n" + bytes(64), "malformed"),
    "empty": (lambda: b"", "malformed"),
}


@pytest.mark.parametrize("case", sorted(DECLINED))
def test_declined_inputs_are_none_with_their_reason(case):
    """Declined where libjpeg rejects too, and also where libjpeg-turbo
    decodes what the port does not port (arithmetic coding, the block
    smoothing of a truncated progressive stream)."""
    make, reason = DECLINED[case]
    got, why = _port(make())
    assert got is None and reason in why


def _check_against_jax(data: bytes, progressive: bool):
    """One damaged stream: the port never crashes; a baseline stream is
    the JAX pool's array or None with it; a progressive one the same or
    declined for what is not ported."""
    got, why = _port(data)
    want = j_native.decode_jpeg_bytes(data)
    if want is None:
        assert got is None, "the port decodes what libjpeg rejects"
    elif got is None:
        assert progressive and (SMOOTHING in why or ARITHMETIC in why), why
    else:
        assert _same(got, want)
    return got


@pytest.mark.parametrize("name", sorted(DIGESTS["sweeps"]))
def test_committed_sweeps(name):
    """The sweeps ``chip_smoke.py`` replays: each case's port decode is its
    committed digest (or None) and holds against the JAX pool."""
    data = _fixture(name)
    progressive = DIGESTS["fixtures"][name]["params"].get("progressive",
                                                          False)
    rows = DIGESTS["sweeps"][name]
    assert [c for c, _ in fx.sweep_cases(data)] == [c for c, _ in rows]
    for case, digest in rows:
        got = _check_against_jax(fx.apply_case(data, case), progressive)
        assert (None if got is None else fx.sha(got)[:16]) == digest, case


EXHAUSTIVE = {
    "baseline_420": (dict(quality=90, subsampling=2), False),
    "baseline_444_restart": (dict(quality=90, subsampling=0,
                                  restart_marker_blocks=1), False),
    "baseline_gray_optimized": (dict(quality=80, optimize=True), False),
    "progressive_420": (dict(quality=85, subsampling=2, progressive=True),
                        True),
    "progressive_444_restart": (dict(quality=85, subsampling=0,
                                     progressive=True,
                                     restart_marker_blocks=1), True),
}


@pytest.mark.parametrize("name", sorted(EXHAUSTIVE))
def test_every_bit_flip_truncation_and_seeded_damage(name):
    kw, progressive = EXHAUSTIVE[name]
    gray = "gray" in name
    data = fx.encode(fx.smooth_image(24, 32, 3, gray), **kw)
    cases = [data[:n] for n in range(len(data))]
    for pos in range(len(data)):
        for bit in range(8):
            b = bytearray(data)
            b[pos] ^= 1 << bit
            cases.append(bytes(b))
    rng = np.random.default_rng(len(data))
    for _ in range(300):
        b = bytearray(data)
        for _ in range(int(rng.integers(1, 6))):
            b[int(rng.integers(len(b)))] = int(rng.integers(256))
        cases.append(bytes(b))
    decoded = sum(_check_against_jax(c, progressive) is not None
                  for c in cases)
    assert decoded > len(cases) // 2


ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26,
          33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56,
          57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38,
          31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]


def _gray_stream(blocks: np.ndarray, quant: np.ndarray, bw: int,
                 bh: int) -> bytes:
    """A baseline gray JPEG of ``bw`` x ``bh`` blocks with these natural-
    order coefficients and this 16-bit quantiser: DC categories 0-15 at 5
    bits, every AC (run, size) symbol at 8 bits."""
    def seg(m, payload):
        return b"\xff" + bytes([m]) + struct.pack(">H", len(payload) + 2) \
            + payload
    dc = list(range(16))
    ac = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 16)]
    bits, out = [], bytearray()

    def put(v, n):
        bits.extend((v >> i) & 1 for i in range(n - 1, -1, -1))

    def code(v):
        s = int(abs(v)).bit_length()
        return s, (v if v >= 0 else v + (1 << s) - 1)
    prev = 0
    for blk in blocks:
        diff = (int(blk[0]) - prev + 32768) % 65536 - 32768
        diff = max(diff, -32767)
        prev = (prev + diff + 32768) % 65536 - 32768
        s, v = code(diff)
        put(dc.index(s), 5)
        put(v, s)
        zz = [int(blk[ZIGZAG[k]]) for k in range(64)]
        last = max([k for k in range(1, 64) if zz[k]], default=0)
        run = 0
        for k in range(1, last + 1):
            if not zz[k]:
                run += 1
                continue
            while run > 15:
                put(ac.index(0xF0), 8)
                run -= 16
            s, v = code(max(-32767, min(32767, zz[k])))
            put(ac.index((run << 4) | s), 8)
            put(v, s)
            run = 0
        if last < 63:
            put(ac.index(0x00), 8)
    bits.extend([1] * (-len(bits) % 8))
    for i in range(0, len(bits), 8):
        byte = int("".join(map(str, bits[i:i + 8])), 2)
        out.append(byte)
        if byte == 0xFF:
            out.append(0)
    dqt = b"\x10" + b"".join(struct.pack(">H", int(quant[ZIGZAG[i]]))
                             for i in range(64))
    sof = bytes([8]) + struct.pack(">HH", bh * 8, bw * 8) + bytes(
        [1, 1, 0x11, 0])
    dht = (b"\x00" + bytes([0, 0, 0, 0, 16] + [0] * 11) + bytes(dc)
           + b"\x10" + bytes([0] * 7 + [len(ac)] + [0] * 8) + bytes(ac))
    return (b"\xff\xd8" + seg(0xDB, dqt) + seg(0xC0, sof) + seg(0xC4, dht)
            + seg(0xDA, bytes([1, 1, 0, 0, 63, 0])) + bytes(out)
            + b"\xff\xd9")


@pytest.mark.parametrize("mode", ["full_range", "sparse", "dc_and_row0",
                                  "moderate"])
def test_idct_extremes_match_jax(mode):
    """Coefficients anywhere in int16 and quantisers up to 65535: the port
    reproduces libjpeg-turbo's SIMD IDCT (16-bit products and sums that
    wrap, saturating packs; a block with only row 0 takes the 16-bit DC
    shortcut)."""
    rng = np.random.default_rng(["full_range", "sparse", "dc_and_row0",
                                 "moderate"].index(mode))
    for it in range(12):
        n = 16
        if mode == "full_range":
            blocks = rng.integers(-32767, 32768, (n, 64))
        elif mode == "sparse":
            blocks = rng.integers(-300, 300, (n, 64)) * (
                rng.random((n, 64)) < 0.2)
        elif mode == "dc_and_row0":
            blocks = np.zeros((n, 64), np.int64)
            blocks[:, 0] = rng.integers(-32767, 32768, n)
            blocks[:, 1:8] = rng.integers(-2000, 2000, (n, 7)) * (
                rng.random((n, 7)) < 0.5)
        else:
            blocks = rng.integers(-2048, 2048, (n, 64)) * (
                rng.random((n, 64)) < 0.3)
        quant = rng.integers(1, 65536 if it % 3 == 0 else 256, 64)
        data = _gray_stream(blocks, quant, 4, 4)
        got, why = _port(data)
        want = j_native.decode_jpeg_bytes(data)
        assert want is not None and _same(got, want), (it, why)


@pytest.mark.parametrize("threads", [1, 4, 8])
def test_pool_matches_serial_decodes(threads, tmp_path):
    names = sorted(DIGESTS["fixtures"])
    datas = [_fixture(n) for n in names]
    serial = [_port(d)[0] for d in datas]
    pool = native.DecodePool(threads)
    try:
        reasons: list = []
        by_buffer = pool.decode_buffers(datas, reasons=reasons)
        by_file = pool.decode_files([os.path.join(FIXTURES, f"{n}.jpg")
                                     for n in names])
    finally:
        pool.close()
    for name, s, b, f, why in zip(names, serial, by_buffer, by_file,
                                  reasons):
        if s is None:
            assert b is None and f is None and why, name
        else:
            assert _same(s, b) and _same(s, f) and why is None, name


def test_unreadable_paths_are_declined_not_fatal(tmp_path):
    """A directory named ``.jpg`` (it opens for reading), a missing file
    and an empty one are each declined with the I/O reason, alone and in
    a pool call beside a good file; nothing is allocated from a
    directory's size."""
    (tmp_path / "dir.jpg").mkdir()
    (tmp_path / "empty.jpg").write_bytes(b"")
    bad = [str(tmp_path / n) for n in ("dir.jpg", "missing.jpg",
                                       "empty.jpg")]
    for path in bad:
        reasons: list = []
        assert native.decode_jpeg_file(path, reasons=reasons) is None
        assert reasons == ["file unreadable or empty"], (path, reasons)
    good = os.path.join(FIXTURES, "gray.jpg")
    reasons = []
    out = native.default_pool().decode_files(bad + [good], reasons=reasons)
    assert out[:3] == [None] * 3 and reasons[:3] == \
        ["file unreadable or empty"] * 3
    assert _same(out[3], _port(_fixture("gray"))[0]) and reasons[3] is None


def test_scale_denom_other_than_one_raises():
    with pytest.raises(ValueError, match="scale_denom"):
        native.decode_jpeg_bytes(_fixture("gray"), scale_denom=2)
    with pytest.raises(ValueError, match="scale_denom"):
        native.default_pool().decode_files([], scale_denom=4)


def test_library_is_built_from_the_source_into_build_native():
    info = native.build_info()
    lib = info["library"]
    assert os.path.dirname(lib).endswith(os.path.join("build", "native"))
    digest = hashlib.sha256()
    for src in (*native._SRCS, *native._HEADERS):
        digest.update(open(src, "rb").read())
    digest.update(" ".join(native._FLAGS).encode())
    assert os.path.basename(lib) == \
        f"dfd_native-{digest.hexdigest()[:16]}.so"
    assert "-ljpeg" not in native._FLAGS


#: what every decode and image op raises when the library cannot build
UNAVAILABLE = "native library .* is unavailable"


def test_missing_compiler_raises_and_nothing_falls_back(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "_default_pool", None)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-c++"))
    assert native.available() is False
    with pytest.raises(RuntimeError, match=UNAVAILABLE):
        native.decode_jpeg_bytes(_fixture("gray"))
    jpg = tmp_path / "0.jpg"
    jpg.write_bytes(_fixture("gray"))
    fallbacks = t_ds.decode_fallbacks
    with pytest.raises(RuntimeError, match=UNAVAILABLE):
        t_ds.load_frames([str(jpg)])     # Pillow is here: still no fallback
    assert t_ds.decode_fallbacks == fallbacks
    assert not list((tmp_path / "build").glob("*.so"))


def test_declined_frame_goes_to_pillow_counted_or_raises(tmp_path,
                                                         monkeypatch):
    cmyk = tmp_path / "0.jpg"
    cmyk.write_bytes(_fixture("cmyk"))
    before = t_ds.decode_fallbacks
    got = t_ds.load_frames([str(cmyk)])[0]
    assert np.array_equal(got, _pil(_fixture("cmyk")))
    assert t_ds.decode_fallbacks == before + 1
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match=r"0\.jpg.*4 components"):
        t_ds.read_frame(str(cmyk))


# ---------------------------------------------------------------------------
# entry points from JPEG input, Pillow blocked on the port's side
# ---------------------------------------------------------------------------

def _jpeg_tree(root: str, seed: int = 0, n_real: int = 4, n_fake: int = 7,
               hw=(40, 48)) -> str:
    """A clip tree of ``.jpg`` frames only, the v3 lists beside it."""
    rng = np.random.default_rng(seed)
    for kind, n in (("real", n_real), ("fake", n_fake)):
        lines = []
        for c in range(n):
            nf = (2, 3, 4, 5)[c % 4]
            d = os.path.join(root, kind, f"c{c:02d}")
            os.makedirs(d, exist_ok=True)
            for i in range(nf):
                img = fx.smooth_image(hw[0], hw[1], int(rng.integers(1 << 30)))
                with open(os.path.join(d, f"{i}.jpg"), "wb") as f:
                    f.write(fx.encode(img, quality=90, subsampling=2))
            lines.append(f"c{c:02d}:{nf}\n")
        with open(os.path.join(root, f"{kind}_list.txt"), "w") as f:
            f.write("".join(lines))
    return root


def _npy_twin(root: str, dst: str) -> str:
    """The tree with each ``.jpg`` replaced by the JAX pool's decode as
    ``.npy`` (read first, so the port's decoder is not involved)."""
    shutil.copytree(root, dst)
    for d, _, files in os.walk(dst):
        for f in files:
            if f.endswith(".jpg"):
                p = os.path.join(d, f)
                np.save(p[:-4] + ".npy", j_native.decode_jpeg_file(p))
                os.remove(p)
    return dst


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("jpeg_trees")
    jpg = _jpeg_tree(str(base / "jpg"))
    return jpg, _npy_twin(jpg, str(base / "npy"))


def test_jpeg_tree_samples_match_the_jax_dataset(trees, monkeypatch):
    jpg, _ = trees
    jd = j_ds.DeepFakeClipDataset(jpg, frames_per_clip=4)
    jd.set_transform(j_tff.transforms_deepfake_train_passthrough(32))
    want = [jd.__getitem__(i, rng=np.random.default_rng(i))
            for i in range(len(jd))]
    monkeypatch.setitem(sys.modules, "PIL", None)
    before = t_ds.decode_fallbacks
    td = t_ds.DeepFakeClipDataset(jpg, frames_per_clip=4)
    td.set_transform(t_tff.transforms_deepfake_train_passthrough(32))
    assert len(td) == len(jd)
    for i, (x, y) in enumerate(want):
        got, label = td.__getitem__(i, rng=np.random.default_rng(i))
        assert label == y
        np.testing.assert_array_equal(np.asarray(got), np.asarray(x))
    assert t_ds.decode_fallbacks == before


def test_train_runner_batches_from_jpeg_equal_the_npy_tree(trees,
                                                           monkeypatch):
    from deepfake_detection_tpu_torch.runners import train as runner
    from test_torch_train_cli import TREE_ARGS

    def first_batches(root):
        cfg = runner.parse_args(TREE_ARGS + ["--data", root, "--device",
                                             "cpu", "--compute-dtype",
                                             "float32"])
        run = runner.setup(cfg)
        run.train_loader.set_epoch(0)
        return [(x.numpy().copy(), y.numpy().copy())
                for x, y in itertools.islice(run.train_loader, 2)]
    jpg, npy = trees
    want = first_batches(npy)
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = first_batches(jpg)
    assert len(got) == len(want) == 2
    for (xg, yg), (xw, yw) in zip(got, want):
        np.testing.assert_array_equal(xg, xw)
        np.testing.assert_array_equal(yg, yw)


def test_write_pack_from_jpeg_tree_writes_the_jax_shards(trees, tmp_path,
                                                         monkeypatch):
    jpg, _ = trees
    kw = dict(image_size=0, frames_per_clip=4, shard_size=4, workers=2)
    j_write_pack(jpg, str(tmp_path / "jax"), **kw)
    monkeypatch.setitem(sys.modules, "PIL", None)
    t_write_pack(jpg, str(tmp_path / "port"), **kw)
    shards = sorted(p.name for p in (tmp_path / "jax").glob("shard-*.bin"))
    assert shards and shards == sorted(
        p.name for p in (tmp_path / "port").glob("shard-*.bin"))
    for s in shards:
        assert (tmp_path / "jax" / s).read_bytes() == \
            (tmp_path / "port" / s).read_bytes(), s
    ji, ti = (json.loads((tmp_path / d / "index.json").read_text())
              for d in ("jax", "port"))
    assert ji["clips"] == ti["clips"] and ji["shards"] == ti["shards"]


def test_cli_on_jpg_files_matches_jax(tmp_path, monkeypatch):
    """``test_torch_cli.py``'s frames and calibration, the frames as JPEG:
    the port's preprocess of each is the JAX CLI's bitwise, and P(fake)
    agrees within its 1e-4."""
    from test_torch_cli import FRAME_HW, SIZE
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate(FRAME_HW):
        yy, xx = np.mgrid[0:h, 0:w]
        base = 127 + 100 * np.sin(xx[..., None] / (5 + i) + yy[..., None]
                                  / 7 + np.arange(3) * i)
        img = np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255)
        p = tmp_path / f"frame{i}.jpg"
        p.write_bytes(fx.encode(img.astype(np.uint8), quality=90,
                                subsampling=2))
        paths.append(str(p))
    model = create_deepfake_model_v4(bn_momentum=1.0, device="cpu")
    batch = np.concatenate([j_cli.preprocess(f, SIZE) for f in paths])
    calib = np.concatenate([batch] + [
        batch + 0.3 * rng.standard_normal(batch.shape).astype(np.float32)
        for _ in range(3)])
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(calib).permute(0, 3, 1, 2))
    sd = model.state_dict()
    torch.save(sd, tmp_path / "m.pth")
    save_model_checkpoint(str(tmp_path / "m.msgpack"), convert_state_dict(sd))
    want = {clip: np.asarray(j_cli.test_img(str(tmp_path / "m.msgpack"),
                                            paths, size=SIZE, clip=clip))
            for clip in (False, True)}
    pre = [j_cli.preprocess(f, SIZE) for f in paths]
    monkeypatch.setitem(sys.modules, "PIL", None)
    for f, p in zip(paths, pre):
        np.testing.assert_array_equal(t_cli.preprocess(f, SIZE), p)
    for clip in (False, True):
        got = np.asarray(t_cli.test_img(str(tmp_path / "m.pth"), paths,
                                        size=SIZE, clip=clip, device="cpu"))
        assert np.abs(want[clip] - 0.5).max() > 1e-3
        np.testing.assert_allclose(got, want[clip], rtol=0, atol=1e-4)


def _multipart(blobs, ctype="image/jpeg"):
    return b"".join(f"--clip\r\nContent-Type: {ctype}\r\n\r\n".encode() + b
                    + b"\r\n" for b in blobs) + b"--clip--\r\n"


def test_score_jpeg_bodies_match_jax_and_the_npy_wire(servers,
                                                       monkeypatch):
    """``test_torch_serving.py``'s servers: the JAX one answers first (it
    decodes with Pillow), then the port's with Pillow blocked."""
    port, ref = servers
    blobs = [fx.encode(fx.smooth_image(70 + 3 * i, 50 + 5 * i, 90 + i),
                       quality=90, subsampling=2) for i in range(4)]
    decoded = [j_native.decode_jpeg_bytes(b) for b in blobs]
    bodies = {
        "multipart": (_multipart(blobs), "multipart/form-data; boundary=clip"),
        "frames_b64": (json.dumps({"frames_b64": [
            base64.b64encode(b).decode() for b in blobs]}).encode(),
            "application/json"),
        "single": (blobs[0], "image/jpeg"),
    }
    npy = {
        "multipart": (_multipart([ts._npy(d) for d in decoded],
                                 "application/octet-stream"),
                      "multipart/form-data; boundary=clip"),
        "frames_b64": (json.dumps({"frames_b64": [
            base64.b64encode(ts._npy(d)).decode()
            for d in decoded]}).encode(), "application/json"),
        "single": (ts._npy(decoded[0]), "application/octet-stream"),
    }
    want = {k: ts._post(ref.port, "/score", *v)[1] for k, v in bodies.items()}
    monkeypatch.setitem(sys.modules, "PIL", None)
    for k, body in bodies.items():
        status, got = ts._post(port.port, "/score", *body)
        assert status == 200, got
        assert got["frames"] == want[k]["frames"]
        assert abs(got["fake_score"] - want[k]["fake_score"]) <= ts.TOL
        np.testing.assert_allclose(got["scores"], want[k]["scores"], rtol=0,
                                   atol=ts.TOL)
        _, wire = ts._post(port.port, "/score", *npy[k])
        assert got["scores"] == wire["scores"], k
    with pytest.raises(urllib.error.HTTPError) as ei:
        ts._post(port.port, "/score", _fixture("cmyk"), "image/jpeg")
    assert ei.value.code == 400
    assert "4 components" in json.loads(ei.value.read())["error"]


def test_stream_jpeg_chunks_give_the_raw_wire_windows(monkeypatch):
    """MJPEG multipart, ``image/jpeg`` and concatenated-JPEG chunks against
    the raw wire of their decodes, on one port stack at bucket 1 (a
    window's scores are then bitwise whatever its arrival time)."""
    from deepfake_detection_tpu_torch.serving.batcher import MicroBatcher
    from deepfake_detection_tpu_torch.serving.config import StreamConfig
    from deepfake_detection_tpu_torch.serving.engine import InferenceEngine
    from deepfake_detection_tpu_torch.serving.metrics import ServingMetrics
    from deepfake_detection_tpu_torch.streaming import ingest
    from deepfake_detection_tpu_torch.streaming.metrics import \
        StreamingMetrics
    from deepfake_detection_tpu_torch.streaming.windows import \
        WindowDispatcher
    from test_torch_streaming import (NUM, SIZE, _model, _raw, _req,
                                      calibrated_state)
    from test_torch_streaming_e2e import _Side
    sm = ServingMetrics()
    side = _Side(InferenceEngine(_model(calibrated_state()), image_size=SIZE,
                                 img_num=NUM, buckets=(1,), metrics=sm),
                 MicroBatcher(max_batch=1, deadline_ms=5.0, max_queue=64,
                              metrics=sm), sm,
                 StreamConfig(device="cpu", image_size=SIZE, img_num=NUM,
                              buckets=(1,), stream_ttl_s=0.0,
                              max_inflight_windows=16),
                 ingest, WindowDispatcher, StreamingMetrics)
    try:
        blobs = [fx.encode(fx.smooth_image(48, 40, 120 + i), quality=85,
                           subsampling=2) for i in range(4)]
        frames = [j_native.decode_jpeg_bytes(b) for b in blobs]
        chunks = {
            "mjpeg": ([(_multipart(blobs), {
                "Content-Type": "multipart/x-mixed-replace; boundary=clip"})]),
            "image_jpeg": [(b, {"Content-Type": "image/jpeg"})
                           for b in blobs],
            "concatenated": [(b"".join(blobs), {
                "Content-Type": "application/octet-stream"})],
        }
        monkeypatch.setitem(sys.modules, "PIL", None)

        def no_pillow_probe():
            raise AssertionError("an all-JPEG chunk asked for Pillow")
        monkeypatch.setattr(ingest, "_pillow_importable", no_pillow_probe)
        assert ingest.decoder_available()
        for kind, posts in chunks.items():
            for sid, bodies in ((f"j-{kind}", posts),
                                (f"r-{kind}", [_raw(frames)])):
                assert _req(side.port, "POST", "/streams",
                            json.dumps({"stream_id": sid}).encode())[0] == 201
                accepted = emitted = 0
                for body, headers in bodies:
                    st, ack = _req(side.port, "POST",
                                   f"/streams/{sid}/frames", body, headers)
                    assert st == 200 and ack["decode_errors"] == 0, ack
                    accepted += ack["frames_accepted"]
                    emitted += ack["windows_emitted"]
                assert accepted == 4 and emitted >= 1
                c = side.wait(sid, emitted).status()["counters"]
                assert c["windows_emitted"] == c["windows_scored"] \
                    == emitted, c
            got = {k[1:]: v for k, v in side.scores.items()
                   if k[0] == f"j-{kind}"}
            want = {k[1:]: v for k, v in side.scores.items()
                    if k[0] == f"r-{kind}"}
            assert got and got == want, (kind, got, want)
    finally:
        side.close()


def test_backfill_of_jpeg_tree_writes_the_npy_tree_verdicts(trees, tmp_path,
                                                            monkeypatch):
    from deepfake_detection_tpu_torch.backfill.manifest import (
        build_manifest_from_lists, save_manifest)
    from deepfake_detection_tpu_torch.backfill.writer import (read_verdicts,
                                                              verdict_path)
    from deepfake_detection_tpu_torch.models import create_model
    from deepfake_detection_tpu_torch.runners.backfill import (BackfillConfig,
                                                               run_backfill)
    sd = create_model("vit_tiny_patch16_224", num_classes=2, in_chans=12,
                      img_size=32, device="cpu", seed=3).state_dict()
    torch.save(sd, tmp_path / "vit.pth")

    def verdicts(root, name):
        manifest = build_manifest_from_lists(root, shard_clips=4)
        save_manifest(str(tmp_path / f"{name}.json"), manifest)
        out = tmp_path / f"run-{name}"
        books = run_backfill(BackfillConfig(
            manifest=str(tmp_path / f"{name}.json"), out=str(out), data=root,
            image_size=32, model="vit_tiny_patch16_224",
            model_path=str(tmp_path / "vit.pth"), batch_size=4, workers=2,
            device="cpu"))["books"]
        assert books["balanced"], books
        return [{k: r[k] for k in ("kind", "root", "clip", "label", "ok",
                                   "score")}
                for sh in manifest["shards"]
                for r in read_verdicts(verdict_path(str(out), sh["id"]))]
    jpg, npy = trees
    want = verdicts(npy, "npy")
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = verdicts(jpg, "jpg")
    assert len(got) == len(want) > 0 and got == want

"""The port's warm start (``serving/warmkey.py``, ``serving/warmstart.py``,
``csrc/build.py``'s store, the engine's golden-batch canary), on the CPU.

The JAX contracts of ``tests/test_warmstart.py`` stated directly: the key
is deterministic, sensitive to every field and refuses a partial dict;
arrays round-trip bitwise and files are written atomically; the port's
``store_key``, ``encode_array`` and ``decode_array`` agree bitwise with the
JAX module's.  The store: a miss, a save, a hit; corrupt bytes give
``payload-hash`` before any ``dlopen``; a foreign manifest gives
``key-mismatch``; an nvcc or driver skew is a clean miss; a crashed
writer's temp file is never read.  ``build()`` through its compiler seam
(there is no nvcc here; the seam's "libraries" are copies of a shared
object every Python has): a fresh build directory over a full store
compiles nothing, one corrupt entry compiles that source once, a library
the canary rejects is rebuilt and saved over.  The engine, with the
reduced flagship at 64²: miss → save → a fresh engine's hit with bitwise
scores; a tampered golden under the same fingerprint is a counted canary
reject, healed; a fingerprint skew passes and re-stamps the manifest.
"""

import _ctypes
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deepfake_detection_tpu.serving import warmkey as jwarmkey
from deepfake_detection_tpu_torch.csrc import build as kernels
from deepfake_detection_tpu_torch.models import create_deepfake_model_v4
from deepfake_detection_tpu_torch.serving import warmkey
from deepfake_detection_tpu_torch.serving import warmstart as ws
from deepfake_detection_tpu_torch.serving.engine import InferenceEngine
from deepfake_detection_tpu_torch.serving.metrics import ServingMetrics
from deepfake_detection_tpu_torch.serving.warmstart import (WarmstartMiss,
                                                            WarmStore)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
KW = dict(num_classes=2, in_chans=12, channel_multiplier=0.25,
          depth_multiplier=0.34)
SIZE = 64
BUCKETS = (1, 2)


def _fields(**over):
    f = warmkey.key_fields(device_kind="NVIDIA H100 80GB HBM3",
                           capability="9.0", program="p" * 64,
                           geometry={"image_size": 32, "img_num": 1},
                           bucket=4, chans=3, wire="float32", quant="f32")
    f.update(over)
    return f


# ---------------------------------------------------------------------------
# warmkey
# ---------------------------------------------------------------------------

def test_store_key_deterministic_and_sensitive_to_every_field():
    k = warmkey.store_key(_fields())
    assert k == warmkey.store_key(_fields()) and len(k) == 64
    other = {"schema": "x", "torch": "0", "cuda": "0", "nvcc": "0",
             "driver": "0", "device_kind": "NVIDIA H200",
             "capability": "8.0", "program": "q" * 64,
             "geometry": {"image_size": 64}, "bucket": 8, "chans": 12,
             "wire": "uint8", "quant": "int8", "sharding": "mesh"}
    assert set(other) == set(warmkey.KEY_FIELDS)
    for name, val in other.items():
        assert warmkey.store_key(_fields(**{name: val})) != k, name


@pytest.mark.parametrize("field", ["nvcc", "driver", "capability"])
def test_store_key_refuses_partial_fields(field):
    incomplete = _fields()
    del incomplete[field]
    with pytest.raises(ValueError, match=field):
        warmkey.store_key(incomplete)


def test_keys_and_arrays_agree_bitwise_with_the_jax_module():
    """The same field dict (both modules' fields present) hashes alike, and
    each module decodes the other's arrays bitwise."""
    fields = dict(_fields(), jax="0.4", jaxlib="0.4", backend="gpu")
    assert warmkey.store_key(fields) == jwarmkey.store_key(fields)
    rng = np.random.default_rng(7)
    for arr in (rng.standard_normal((4, 2)).astype(np.float32),
                rng.integers(0, 256, (3, 5), dtype=np.uint8),
                np.array([np.nan, np.inf, -0.0], dtype=np.float64)):
        enc = warmkey.encode_array(arr)
        assert enc == jwarmkey.encode_array(arr)
        for out in (warmkey.decode_array(jwarmkey.encode_array(arr)),
                    jwarmkey.decode_array(enc)):
            assert out.dtype == arr.dtype and out.shape == arr.shape
            assert np.array_equal(arr.view(np.uint8), out.view(np.uint8))


def test_write_atomic_replaces_whole_and_leaves_no_partials(tmp_path):
    p = str(tmp_path / "sub" / "blob.so")
    warmkey.write_atomic(p, b"payload")
    warmkey.write_atomic(p, b"replaced")
    assert open(p, "rb").read() == b"replaced"

    with pytest.raises(TypeError):                # the writer dies mid-way
        warmkey.write_atomic(p, object())
    assert open(p, "rb").read() == b"replaced"
    assert os.listdir(tmp_path / "sub") == ["blob.so"]


def test_runtime_versions_read_without_torch_or_a_context():
    """The runtime fields come from files and binaries: a fresh interpreter
    computes them, and imports the key and log modules, without loading
    torch."""
    probe = ("import json, sys\n"
             "from deepfake_detection_tpu_torch.serving import warmkey\n"
             "from deepfake_detection_tpu_torch.obs import events, EventLog\n"
             "v = warmkey.runtime_versions()\n"
             "print(json.dumps({'v': v, 'torch': 'torch' in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["torch"] is False
    assert set(got["v"]) == {"torch", "cuda", "nvcc", "driver"}
    assert got["v"]["cuda"] == (torch.version.cuda or "none")


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def _so_bytes(tag: str) -> bytes:
    """A loadable shared object (CPython's own ``_ctypes``) with a tag
    after its end, which the dynamic loader ignores."""
    return Path(_ctypes.__file__).read_bytes() + tag.encode()


def test_capture_manifest_miss_save_hit_and_restamp(tmp_path):
    store = WarmStore(str(tmp_path))
    f = _fields()
    with pytest.raises(WarmstartMiss) as e:
        store.load(f)
    assert e.value.reason == "absent"
    scores = np.array([[0.25, 0.75]], np.float32)
    assert store.save(f, golden_scores=scores, params_fingerprint="fp1")
    m = store.load(f)
    assert m["params_fingerprint"] == "fp1" and m["kind"] == "capture"
    assert np.array_equal(warmkey.decode_array(m["golden_scores"]), scores)
    store.refresh_manifest(f, golden_scores=scores + 1,
                           params_fingerprint="fp2")
    assert store.load(f)["params_fingerprint"] == "fp2"


def test_library_load_checks_the_hash_before_dlopen(tmp_path, monkeypatch):
    store = WarmStore(str(tmp_path / "store"))
    src = tmp_path / "built.so"
    src.write_bytes(_so_bytes("lib"))
    f = _fields(geometry={"library": "depthwise_fwd"})
    assert store.save_library(f, str(src), nvcc_version="release 12.4",
                              ptxas_log="ptxas info: 32 registers")
    dest = tmp_path / "build" / "depthwise_fwd-x.so"
    m = store.load_library(f, str(dest))
    assert dest.read_bytes() == src.read_bytes()
    assert m["nvcc_version"] == "release 12.4" and "registers" in \
        m["ptxas_log"]
    opened = []
    monkeypatch.setattr(ws.ctypes, "CDLL", lambda p: opened.append(p))
    lib = Path(store.library_path(m["key"]))
    blob = bytearray(lib.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    lib.write_bytes(bytes(blob))
    dest.unlink()
    with pytest.raises(WarmstartMiss) as e:
        store.load_library(f, str(dest))
    assert e.value.reason == "payload-hash"
    assert opened == [] and not dest.exists()


def test_foreign_manifest_is_key_mismatch(tmp_path):
    store = WarmStore(str(tmp_path))
    f = _fields()
    store.save(f, golden_scores=np.zeros((1, 2), np.float32),
               params_fingerprint="fp")
    path = Path(store.manifest_path(warmkey.store_key(f)))
    m = json.loads(path.read_text())
    m["fields"]["torch"] = "0.0-foreign"
    path.write_text(json.dumps(m))
    with pytest.raises(WarmstartMiss) as e:
        store.load(f)
    assert e.value.reason == "key-mismatch"
    path.write_text("{torn")
    with pytest.raises(WarmstartMiss) as e:
        store.load(f)
    assert e.value.reason == "manifest-unreadable"


@pytest.mark.parametrize("field", ["nvcc", "driver"])
def test_toolchain_skew_is_a_clean_miss(tmp_path, monkeypatch, field):
    store = WarmStore(str(tmp_path))
    f = _fields()
    store.save(f, golden_scores=np.zeros((1, 2), np.float32),
               params_fingerprint="fp")
    skewed = dict(warmkey.runtime_versions(), **{field: "other"})
    monkeypatch.setattr(warmkey, "_versions", skewed)
    with pytest.raises(WarmstartMiss) as e:
        store.load(_fields())
    assert e.value.reason == "absent"


def test_a_crashed_writers_temp_file_is_never_read(tmp_path):
    store = WarmStore(str(tmp_path))
    f = _fields()
    key = warmkey.store_key(f)
    # what a writer killed before its rename leaves: a temp file only
    (tmp_path / ".warm-abc.tmp").write_text(json.dumps(
        {"fields": f, "kind": "capture", "params_fingerprint": "fp",
         "golden_scores": warmkey.encode_array(np.zeros((1, 2)))}))
    with pytest.raises(WarmstartMiss) as e:
        store.load(f)
    assert e.value.reason == "absent"
    with pytest.raises(WarmstartMiss):
        store.load_library(f, str(tmp_path / "out.so"))
    assert not (tmp_path / f"{key}.json").exists()


# ---------------------------------------------------------------------------
# build() over a store, through the compiler seam
# ---------------------------------------------------------------------------

@pytest.fixture
def seam(tmp_path, monkeypatch):
    """build() into a fresh directory with a fake compiler that counts its
    sources; every count and cache of build.py reset around the test."""
    compiled = []

    def fake(todo):
        for name, path in todo.items():
            compiled.append(name)
            path.write_bytes(_so_bytes(name))
        return {name: f"ptxas info: {name}" for name in todo}

    monkeypatch.setattr(kernels, "_compile", fake)
    monkeypatch.setattr(kernels, "_BUILD_DIR", tmp_path / "build1")
    for name in ("_libs", "_fns", "_fn_lib", "_origin", "_rebuilt",
                 "_canaries"):
        monkeypatch.setattr(kernels, name, {})
    monkeypatch.setattr(kernels, "_counts",
                        {n: kernels.Counter() for n in kernels.SOURCES})
    kernels.set_store(WarmStore(str(tmp_path / "store")))
    yield compiled
    kernels.set_store(None)


def _books(key):
    return {n: c[key] for n, c in
            kernels.library_counts()["libraries"].items()}


def test_fresh_build_dir_over_a_full_store_compiles_nothing(
        seam, tmp_path, monkeypatch):
    first = kernels.build()
    assert sorted(seam) == sorted(kernels.SOURCES)
    assert set(_books("misses").values()) == {1}
    assert set(_books("serialized").values()) == {1}
    assert all(p.with_suffix(".log").read_text().startswith("ptxas")
               for p in first.values())
    seam.clear()
    monkeypatch.setattr(kernels, "_BUILD_DIR", tmp_path / "build2")
    second = kernels.build()
    assert seam == []                                 # no compile at all
    assert set(_books("hits").values()) == {1}
    assert all(second[n].read_bytes() == first[n].read_bytes()
               for n in kernels.SOURCES)
    assert all(second[n].with_suffix(".log").read_text() ==
               f"ptxas info: {n}" for n in kernels.SOURCES)


def test_one_corrupt_entry_compiles_that_source_once(seam, tmp_path,
                                                     monkeypatch):
    kernels.build()
    store = tmp_path / "store"
    for mpath in store.glob("*.json"):
        m = json.loads(mpath.read_text())
        if m["fields"]["geometry"]["library"] == "depthwise_dx":
            lib = store / f"{m['key']}.so"
            lib.write_bytes(lib.read_bytes()[:-1] + b"!")
    seam.clear()
    monkeypatch.setattr(kernels, "_BUILD_DIR", tmp_path / "build2")
    kernels.build()
    assert seam == ["depthwise_dx"]
    assert _books("fallbacks")["depthwise_dx"] == 1
    assert _books("serialized")["depthwise_dx"] == 2      # saved over
    assert sum(_books("hits").values()) == len(kernels.SOURCES) - 1
    seam.clear()
    monkeypatch.setattr(kernels, "_BUILD_DIR", tmp_path / "build3")
    kernels.build()                                       # healed
    assert seam == []


def test_canary_reject_rebuilds_under_a_new_name_and_saves_over(
        seam, tmp_path, monkeypatch):
    kernels.build()
    monkeypatch.setattr(kernels, "_BUILD_DIR", tmp_path / "build2")
    seam.clear()
    calls = []

    def canary():
        calls.append(1)
        kernels.kernel("flash_fwd", "PyInit__ctypes", [],
                       ctypes.c_void_p)           # re-entry hands it out
        return "O off the plain version"

    kernels.register_canary("flash_fwd", canary)
    fn = kernels.kernel("flash_fwd", "PyInit__ctypes", [], ctypes.c_void_p)
    assert calls == [1] and seam == ["flash_fwd"]
    books = kernels.library_counts()["libraries"]["flash_fwd"]
    # the first build's nvcc and save, then the hit, the reject, the
    # rebuild and its save over
    assert (books["hits"], books["canary_rejects"], books["nvcc"],
            books["serialized"], books["origin"]) == (1, 1, 2, 2, "nvcc")
    rebuilt = kernels.build()["flash_fwd"]
    assert rebuilt != kernels._target("flash_fwd") and rebuilt.is_file()
    assert rebuilt.read_bytes() == kernels._target("flash_fwd").read_bytes()
    assert kernels._fn_lib["PyInit__ctypes"] == "flash_fwd"
    assert fn is kernels.kernel("flash_fwd", "PyInit__ctypes", [],
                                ctypes.c_void_p)
    # the store library that passes its canary is verified and kept
    kernels.register_canary("depthwise_fwd", lambda: None)
    kernels.kernel("depthwise_fwd", "malloc", [ctypes.c_size_t],
                   ctypes.c_void_p)               # found in its dependencies
    assert kernels.library_counts()["libraries"]["depthwise_fwd"][
        "origin"] == "verified"
    assert kernels.rebuild_store_libraries() == ["depthwise_fwd"]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _model(seed: int = 0):
    """The reduced flagship with calibrated BN (one train-mode pass at
    momentum 1), so that its scores are not all 0.5."""
    m = create_deepfake_model_v4(device="cpu", seed=seed, bn_momentum=1.0,
                                 **KW)
    x = np.random.default_rng(seed).standard_normal(
        (32, 12, SIZE, SIZE)).astype(np.float32)
    m.train()
    with torch.no_grad():
        m(torch.from_numpy(x))
    return m.eval()


def _engine(store, model, metrics=None):
    return InferenceEngine(model, image_size=SIZE, img_num=4,
                           buckets=BUCKETS, metrics=metrics or
                           ServingMetrics(), warmstart=store)


def _golden_all(engine):
    entry = engine.entry()
    return [engine._run(entry, b, c, engine._warm_golden_input(entry, b, c))
            for (b, c) in sorted(entry.compiled)]


@pytest.fixture(scope="module")
def models():
    return _model(0), _model(1)


def test_engine_miss_save_then_hit_with_bitwise_scores(tmp_path, models):
    store = WarmStore(str(tmp_path))
    m1 = ServingMetrics()
    e1 = _engine(store, models[0], m1)
    n = len(BUCKETS)
    assert (m1.warmstart_misses_total.value, m1.warmstart_serialized_total
            .value, m1.warmstart_hits_total.value) == (n, n, 0)
    m2 = ServingMetrics()
    e2 = _engine(store, models[0], m2)
    assert (m2.warmstart_hits_total.value, m2.warmstart_misses_total.value,
            m2.warmstart_canary_rejects_total.value,
            m2.warmstart_serialized_total.value) == (n, 0, 0, 0)
    for a, b in zip(_golden_all(e1), _golden_all(e2)):
        assert np.array_equal(a, b)
    report = e2.warm_report()
    assert report["kernels"]["libraries"].keys() == set(kernels.SOURCES)
    assert sorted(report["capture_launches"]["default"]) == ["1x12", "2x12"]


def test_engine_tampered_golden_is_a_counted_canary_reject_and_heals(
        tmp_path, models):
    store = WarmStore(str(tmp_path))
    _engine(store, models[0])
    for p in tmp_path.glob("*.json"):
        m = json.loads(p.read_text())
        ref = warmkey.decode_array(m["golden_scores"])
        m["golden_scores"] = warmkey.encode_array(ref + 0.5)
        p.write_text(json.dumps(m))
    m2 = ServingMetrics()
    compiles0 = m2.compiles_total.value
    e2 = _engine(store, models[0], m2)
    n = len(BUCKETS)
    assert m2.warmstart_hits_total.value == n
    assert m2.warmstart_canary_rejects_total.value == n
    assert m2.warmstart_serialized_total.value == n       # saved over
    assert m2.compiles_total.value - compiles0 == 2 * n   # recaptured
    assert e2.ready
    m3 = ServingMetrics()
    _engine(store, models[0], m3)
    assert (m3.warmstart_hits_total.value,
            m3.warmstart_canary_rejects_total.value) == (n, 0)


def test_engine_fingerprint_skew_passes_and_restamps(tmp_path, models):
    store = WarmStore(str(tmp_path))
    e1 = _engine(store, models[0])
    m2 = ServingMetrics()
    e2 = _engine(store, models[1], m2)
    assert m2.warmstart_hits_total.value == len(BUCKETS)
    assert m2.warmstart_canary_rejects_total.value == 0
    fp1, fp2 = e1.model_fingerprint(), e2.model_fingerprint()
    assert fp1 != fp2
    stamped = {json.loads(p.read_text())["params_fingerprint"]
               for p in tmp_path.glob("*.json")}
    assert stamped == {fp2}

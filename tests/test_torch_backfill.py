"""PyTorch port, the backfill subsystem against the JAX package, on the CPU.

The port's ``backfill/`` (manifest, lease, writer, source) and
``runners/backfill.py`` against the JAX package's, on a seeded corpus of
13 two-frame clips at 32² (JPEG frames with, beside each, the ``.npy`` of
the JAX package's own decode of it) packed by the JAX ``write_pack``, with
``vit_tiny_patch16_224`` as the JAX tests' backfill model (its weights the
port's seeded init, crossing to JAX through
``tools/convert_torch_checkpoint.convert_state_dict``).  Batch 8: the JAX
runner's mesh takes the 8 virtual CPU devices of ``tests/conftest.py``.

On the CPU the port's score program runs eagerly (one program, no
capture); on the card it is one captured CUDA graph (``chip_smoke.py``'s
``backfill`` phase holds that).  Tolerances: manifests, books, verdict
keys, order, ``ok`` and labels equal to the JAX runner's, P(fake) within
1e-5 (f32 through the ViT, summed in other orders); inside the port, a
stopped and relaunched run bitwise the uninterrupted one.
"""

import json
import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from deepfake_detection_tpu import backfill as jbf
from deepfake_detection_tpu.backfill import source as jsource
from deepfake_detection_tpu.backfill.manifest import \
    save_manifest as j_save_manifest
from deepfake_detection_tpu.config import BackfillConfig as JBackfillConfig
from deepfake_detection_tpu.data.dataset import _load_images
from deepfake_detection_tpu.data.packed import write_pack as j_write_pack
from deepfake_detection_tpu.models.helpers import save_model_checkpoint
from deepfake_detection_tpu.runners.backfill import \
    run_backfill as j_run_backfill
from deepfake_detection_tpu_torch.backfill import (
    BackfillManifestStale, LeaseDir, ShardVerdictWriter,
    build_manifest_from_lists, build_manifest_from_pack, collect_books,
    load_manifest, read_verdicts, verify_manifest_source)
from deepfake_detection_tpu_torch.backfill import manifest as t_manifest
from deepfake_detection_tpu_torch.backfill.manifest import save_manifest
from deepfake_detection_tpu_torch.backfill.source import (PackSource,
                                                          TreeSource)
from deepfake_detection_tpu_torch.backfill.writer import verdict_path
from deepfake_detection_tpu_torch.models import create_model
from deepfake_detection_tpu_torch.runners import backfill as t_runner
from deepfake_detection_tpu_torch.runners.backfill import (BackfillConfig,
                                                           run_backfill)
from tools.convert_torch_checkpoint import convert_state_dict

torch.set_num_threads(2)

pytestmark = pytest.mark.backfill

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "vit_tiny_patch16_224"
HEADS = 3
TOL = 1e-5
EXIT_PREEMPTED = 75


def _write_tree(root, fake=7, real=6, frames=2, size=32, seed=0,
                copies=()):
    """JPEG frames, the JAX decode of each beside it as ``.npy``, and the
    v3 list files; ``copies`` duplicates clips byte for byte."""
    rng = np.random.default_rng(seed)
    for kind, n in (("fake", fake), ("real", real)):
        for c in range(n):
            d = os.path.join(root, kind, f"c{c}")
            os.makedirs(d, exist_ok=True)
            for i in range(frames):
                Image.fromarray(rng.integers(
                    0, 255, (size, size, 3), dtype=np.uint8)).save(
                    os.path.join(d, f"{i}.jpg"), quality=92)
    for src, dst in copies:
        shutil.rmtree(os.path.join(root, dst))
        shutil.copytree(os.path.join(root, src), os.path.join(root, dst))
    for kind, n in (("fake", fake), ("real", real)):
        for c in range(n):
            d = os.path.join(root, kind, f"c{c}")
            for i in range(frames):
                jpg = os.path.join(d, f"{i}.jpg")
                np.save(jpg[:-4] + ".npy",
                        np.asarray(_load_images([jpg])[0], np.uint8))
        with open(os.path.join(root, f"{kind}_list.txt"), "w") as f:
            f.write("".join(f"c{c}:{frames}\n" for c in range(n)))


def _corpus(td, **kw):
    root = str(td / "root")
    _write_tree(root, **kw)
    pack = str(td / "pack")
    j_write_pack(root, pack, image_size=0, frames_per_clip=2,
                 shard_size=8, workers=2)
    manifest = build_manifest_from_pack(pack, shard_clips=4)
    mpath = str(td / "manifest.json")
    save_manifest(mpath, manifest)
    return {"root": root, "pack": pack, "manifest_path": mpath,
            "manifest": manifest}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _corpus(tmp_path_factory.mktemp("tbf_corpus"))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """The port's seeded vit_tiny (6 channels, 32²) as a torch file and,
    bridged, as the JAX package's msgpack."""
    d = tmp_path_factory.mktemp("tbf_ckpt")
    model = create_model(MODEL, num_classes=2, in_chans=6, img_size=32,
                         device="cpu", seed=3)
    sd = model.state_dict()
    torch.save(sd, d / "vit.pth")
    save_model_checkpoint(str(d / "vit.msgpack"), convert_state_dict(
        {k: v.numpy() for k, v in sd.items()}, num_heads=HEADS))
    return str(d / "vit.pth"), str(d / "vit.msgpack")


def _cfg(corpus, out, ckpt, **kw):
    kw.setdefault("model", MODEL)
    kw.setdefault("batch_size", 8)
    kw.setdefault("workers", 2)
    kw.setdefault("device", "cpu")
    return BackfillConfig(manifest=corpus["manifest_path"], out=str(out),
                          data_packed=corpus["pack"], model_path=ckpt, **kw)


def _jcfg(corpus, out, ckpt, **kw):
    kw.setdefault("model", MODEL)
    kw.setdefault("batch_size", 8)
    kw.setdefault("workers", 2)
    return JBackfillConfig(manifest=corpus["manifest_path"], out=str(out),
                           data_packed=corpus["pack"], model_path=ckpt, **kw)


def _verdicts(run_dir, manifest):
    return [r for sh in manifest["shards"]
            for r in read_verdicts(verdict_path(str(run_dir), sh["id"]))]


# ---------------------------------------------------------------------------
# manifest
# ---------------------------------------------------------------------------

def test_manifests_equal_the_jax_ones(corpus, tmp_path):
    for shard_clips in (4, 5):
        assert build_manifest_from_pack(corpus["pack"], shard_clips) == \
            jbf.build_manifest_from_pack(corpus["pack"], shard_clips)
        assert build_manifest_from_lists(corpus["root"], shard_clips) == \
            jbf.build_manifest_from_lists(corpus["root"], shard_clips)
    m = corpus["manifest"]
    assert m["schema"] == "dfd.backfill.manifest.v1"
    assert m["num_clips"] == 13 and len(m["shards"]) == 4
    # either package reads the other's file; the CLI writes the same one
    jpath = str(tmp_path / "j.json")
    j_save_manifest(jpath, m)
    assert load_manifest(jpath) == jbf.load_manifest(
        corpus["manifest_path"]) == m
    out = str(tmp_path / "cli.json")
    assert t_manifest.main([corpus["root"], "--manifest", out,
                            "--packed", corpus["pack"],
                            "--shard-clips", "4"]) == 0
    assert load_manifest(out) == m


def test_manifest_validation_and_staleness(corpus, tmp_path):
    root = str(tmp_path / "r")
    os.makedirs(root)
    for kind, n in (("fake", 3), ("real", 2)):
        with open(os.path.join(root, f"{kind}_list.txt"), "w") as f:
            f.write("".join(f"c{c}:2\n" for c in range(n)))
    m = build_manifest_from_lists(root, shard_clips=2)
    path = str(tmp_path / "m.json")
    save_manifest(path, m)
    verify_manifest_source(load_manifest(path), roots=root)
    save_manifest(path, dict(m, num_clips=99))
    with pytest.raises(BackfillManifestStale, match="damaged"):
        load_manifest(path)
    dup = json.loads(json.dumps(m))
    dup["shards"][0]["clips"][0] = dup["shards"][-1]["clips"][-1]
    save_manifest(path, dup)
    with pytest.raises(BackfillManifestStale, match="twice"):
        load_manifest(path)
    with open(os.path.join(root, "fake_list.txt"), "a") as f:
        f.write("c99:2\n")
    with pytest.raises(BackfillManifestStale, match="changed"):
        verify_manifest_source(m, roots=root)
    with pytest.raises(BackfillManifestStale, match="fingerprint"):
        verify_manifest_source(m, pack_dir=corpus["pack"])


def test_sources_read_the_clips_the_jax_sources_read(corpus):
    pack, jpack = PackSource(corpus["pack"]), jsource.PackSource(
        corpus["pack"])
    tree = TreeSource(corpus["root"], frames_per_clip=2)
    jtree = jsource.TreeSource(corpus["root"], frames_per_clip=2)
    from deepfake_detection_tpu_torch.backfill import manifest_entries
    for entry in manifest_entries(corpus["manifest"]):
        a = pack.load(entry)
        np.testing.assert_array_equal(a, jpack.load(entry))
        np.testing.assert_array_equal(tree.load(entry), jtree.load(entry))
        np.testing.assert_array_equal(tree.load(entry), a)
    assert pack.sample_hw == tree.sample_hw == (32, 32)


# ---------------------------------------------------------------------------
# leases
# ---------------------------------------------------------------------------

def test_lease_contention_has_exactly_one_winner(tmp_path):
    owners = [LeaseDir(str(tmp_path), f"w{i}", ttl_s=30) for i in range(8)]
    barrier = threading.Barrier(8)
    results = []

    def race(ld):
        barrier.wait()
        results.append(ld.acquire("s0"))

    ts = [threading.Thread(target=race, args=(o,)) for o in owners]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert sum(results) == 1
    loser = owners[results.index(False)]
    assert loser.acquire("s1")


def test_lease_expiry_steal_and_heartbeat(tmp_path):
    a = LeaseDir(str(tmp_path), "dead-host", ttl_s=5)
    b = LeaseDir(str(tmp_path), "b", ttl_s=5)
    assert a.acquire("s0") and not b.acquire("s0")
    os.utime(a._lease_path("s0"), (1, 1))       # no heartbeat for ages
    assert b.acquire("s0")
    assert b.last_steal["owner"] == "dead-host"
    assert b.still_owner("s0") and not a.still_owner("s0")
    c = LeaseDir(str(tmp_path), "c", ttl_s=1.0)
    d = LeaseDir(str(tmp_path), "d", ttl_s=1.0)
    assert c.acquire("s1")
    time.sleep(0.6)
    c.heartbeat("s1")
    time.sleep(0.6)
    assert not d.acquire("s1")                  # beaten 0.6 s ago


def test_done_marker_final_and_lost_lease_refuses_commit(tmp_path):
    a = LeaseDir(str(tmp_path), "a", ttl_s=5)
    b = LeaseDir(str(tmp_path), "b", ttl_s=5)
    assert a.acquire("s0") and a.mark_done("s0", {"clips": 3})
    assert a.is_done("s0") and b.done_record("s0")["clips"] == 3
    assert not a.acquire("s0") and not b.acquire("s0")
    assert a.mark_done("s0", {"clips": 3})     # idempotent
    assert a.acquire("s1")
    os.utime(a._lease_path("s1"), (1, 1))
    assert b.acquire("s1")
    assert not a.mark_done("s1", {})           # the stealer owns it now
    assert b.mark_done("s1", {})
    assert b.pending_shards({"shards": [{"id": "s0"}, {"id": "s1"},
                                        {"id": "s2"}]}) == ["s2"]
    # the JAX package's lease layer sees the same state
    j = jbf.LeaseDir(str(tmp_path), "j", ttl_s=5)
    assert j.is_done("s0") and j.is_done("s1") and not j.acquire("s0")


# ---------------------------------------------------------------------------
# verdict writer and books
# ---------------------------------------------------------------------------

def test_torn_tail_repaired_and_resumed(tmp_path):
    run = str(tmp_path)
    w = ShardVerdictWriter(run, "s0")
    w.append_many([("fake", 0, "c0", 0, 0.9, ""),
                   ("fake", 0, "c1", 0, None, "IOError: boom")])
    w.tear()
    w.close()
    w2 = ShardVerdictWriter(run, "s0")
    assert w2.torn_bytes_dropped > 0
    assert w2.scored_keys == {("fake", 0, "c0"), ("fake", 0, "c1")}
    assert w2.records == 2 and w2.failed == 1
    w2.append("real", 0, "c0", 1, 0.1)
    book = w2.finalize()
    w2.close()
    assert book == {"clips": 3, "scored": 2, "failed": 1,
                    "skipped_dup": 0, "sha256": book["sha256"]}
    import hashlib
    with open(verdict_path(run, "s0"), "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == book["sha256"]
    recs = read_verdicts(verdict_path(run, "s0"))
    assert recs == jbf.read_verdicts(verdict_path(run, "s0"))
    assert [r["clip"] for r in recs] == ["c0", "c1", "c0"]


def test_books_name_their_discrepancies(tmp_path):
    run = str(tmp_path)
    root = str(tmp_path / "r")
    os.makedirs(root)
    for kind, n in (("fake", 2), ("real", 1)):
        with open(os.path.join(root, f"{kind}_list.txt"), "w") as f:
            f.write("".join(f"c{c}:2\n" for c in range(n)))
    m = build_manifest_from_lists(root, shard_clips=3)
    sid = m["shards"][0]["id"]
    lease = LeaseDir(run, "w", ttl_s=30)
    w = ShardVerdictWriter(run, sid)
    w.append("fake", 0, "c0", 0, 0.9)
    w.append("fake", 0, "c0", 0, 0.9)            # twice
    w.append("fake", 0, "alien", 0, 0.9)         # not in the manifest
    w.close()
    assert lease.acquire(sid) and lease.mark_done(sid, {})
    books = collect_books(run, m)
    assert books == jbf.collect_books(run, m)
    assert not books["balanced"] and books["complete"]
    assert books["duplicated"] == ["fake/0/c0"]
    assert books["alien"] == ["fake/0/alien"]
    assert books["missing"] == ["fake/0/c1", "real/0/c0"]


# ---------------------------------------------------------------------------
# the runner against the JAX runner
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_run(corpus, ckpts, tmp_path_factory):
    out = tmp_path_factory.mktemp("tbf_jrun") / "run"
    s = j_run_backfill(_jcfg(corpus, out, ckpts[1]))
    assert s["books"]["balanced"], s["books"]
    return out, s


@pytest.fixture(scope="module")
def port_run(corpus, ckpts, tmp_path_factory):
    out = tmp_path_factory.mktemp("tbf_trun") / "run"
    return out, run_backfill(_cfg(corpus, out, ckpts[0]))


def test_full_corpus_matches_the_jax_runner(corpus, jax_run, port_run):
    (jout, js), (out, s) = jax_run, port_run
    b = s["books"]
    assert b["balanced"], b
    assert b == js["books"]
    assert b["scored"] + b["failed"] + b["skipped_dup"] == \
        b["manifest_clips"] == 13
    # the one program runs eagerly on the CPU (the card captures it once):
    # no capture, none after warmup
    assert s["captures"] == 0 and s["capture_s"] >= 0
    assert s["steady_recompiles"] == 0 and s["clips_this_proc"] == 13
    assert s["replays"] == 4                    # 13 clips, 4 shards of <= 4
    got, want = _verdicts(out, corpus["manifest"]), \
        _verdicts(jout, corpus["manifest"])
    assert len(got) == len(want) == 13
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "score"} == \
            {k: v for k, v in w.items() if k != "score"}
        assert g["ok"] and abs(g["score"] - w["score"]) <= TOL
    scores = np.asarray([g["score"] for g in got])
    assert np.ptp(scores) > 1e-3, scores        # not degenerate


def test_relaunch_over_a_finished_corpus_is_a_no_op(corpus, ckpts,
                                                    port_run):
    out, _ = port_run
    s2 = run_backfill(_cfg(corpus, out, ckpts[0]))
    assert s2["shards_this_proc"] == 0 and s2["books"]["balanced"]
    import glob
    tele = glob.glob(str(out / "telemetry-*.jsonl"))
    assert len(tele) == 1, tele
    recs = [json.loads(line) for line in open(tele[0])]
    kinds = [r.get("event") or r["type"] for r in recs]
    assert kinds[0] == "run_start" and kinds.count("run_end") == 2
    shard_recs = [r for r in recs if r["type"] == "metrics"]
    assert {r["shard"] for r in shard_recs} == \
        {sh["id"] for sh in corpus["manifest"]["shards"]}
    assert all(r["backend_compiles"] == 0 for r in shard_recs)


def test_obs_report_renders_the_port_run_dir(port_run, capsys):
    out, _ = port_run
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import obs_report
    obs_report.main([str(out)])
    text = capsys.readouterr().out
    assert "backfill" in text and "BALANCED" in text
    assert "shard-00000" in text and "clips/s" in text


def test_dedup_books_skipped_dup_as_the_jax_runner(tmp_path, ckpts):
    dup = _corpus(tmp_path, fake=5, real=4, seed=3,
                  copies=(("fake/c0", "fake/c3"), ("fake/c0", "fake/c4"),
                          ("real/c1", "real/c2")))
    s = run_backfill(_cfg(dup, tmp_path / "run", ckpts[0], dedup=True))
    b = s["books"]
    assert b["balanced"], b
    assert b["skipped_dup"] == 3 and s["skipped_dup_this_proc"] == 3
    assert b["scored"] + b["failed"] + b["skipped_dup"] == 9
    recs = _verdicts(tmp_path / "run", dup["manifest"])
    skips = [r for r in recs if r.get("skipped_dup")]
    scored = {f"{r['kind']}/{r['root']}/{r['clip']}" for r in recs
              if r["ok"]}
    assert all(r["dup_of"] in scored and r["score"] is None
               and not r["ok"] for r in skips)
    assert sorted((r["clip"], r["dup_of"]) for r in skips) == \
        [("c2", "real/0/c1"), ("c3", "fake/0/c0"), ("c4", "fake/0/c0")]
    from deepfake_detection_tpu.runners.backfill import \
        _build_dup_map as j_dup_map
    assert t_runner._build_dup_map(PackSource(dup["pack"]),
                                   dup["manifest"]) == \
        j_dup_map(jsource.PackSource(dup["pack"]), dup["manifest"])


def test_failed_and_nonfinite_clips_are_booked(tmp_path, corpus, ckpts,
                                               monkeypatch):
    root = str(tmp_path / "root")
    _write_tree(root, fake=3, real=2, frames=2, size=32)
    m = build_manifest_from_lists(root, shard_clips=3)
    mpath = str(tmp_path / "m.json")
    save_manifest(mpath, m)
    os.remove(os.path.join(root, "fake", "c1", "1.npy"))
    os.remove(os.path.join(root, "fake", "c1", "1.jpg"))
    cfg = BackfillConfig(manifest=mpath, out=str(tmp_path / "run"),
                         data=root, frames=2, model=MODEL, batch_size=8,
                         workers=2, device="cpu", model_path=ckpts[0])
    s = run_backfill(cfg)
    assert s["books"]["balanced"] and s["books"]["failed"] == 1
    failed = [r for r in _verdicts(tmp_path / "run", m) if not r["ok"]]
    assert len(failed) == 1 and failed[0]["clip"] == "c1"
    assert "err" in failed[0] and failed[0]["score"] is None
    # a model emitting NaN costs failed book entries, not a crash
    real_dispatch = t_runner._Pipeline.dispatch

    def nan_dispatch(self, slot):
        real_dispatch(self, slot)
        slot.out_np[...] = np.nan

    monkeypatch.setattr(t_runner._Pipeline, "dispatch", nan_dispatch)
    s = run_backfill(_cfg(corpus, tmp_path / "nan", ckpts[0]))
    assert s["books"]["balanced"]
    assert s["books"]["failed"] == s["failed_this_proc"] == 13
    assert all(not r["ok"] and "NonFinite" in r["err"]
               for r in _verdicts(tmp_path / "nan", corpus["manifest"]))


def test_stale_source_refuses_to_run(tmp_path, corpus, ckpts):
    m = json.loads(json.dumps(corpus["manifest"]))
    m["source"]["fingerprint"] = "0" * 64
    mpath = str(tmp_path / "stale.json")
    save_manifest(mpath, m)
    cfg = _cfg(dict(corpus, manifest_path=mpath), tmp_path / "run",
               ckpts[0])
    with pytest.raises(BackfillManifestStale):
        run_backfill(cfg)


def test_lease_race_loses_cleanly_then_steals(tmp_path, corpus, ckpts,
                                             monkeypatch):
    monkeypatch.setenv("DFD_CHAOS", "backfill_lease_race@0")
    s = run_backfill(_cfg(corpus, tmp_path / "run", ckpts[0],
                          lease_ttl_s=1.0))
    assert s["books"]["balanced"], s["books"]
    assert s["lease_steals"] >= 1


def test_sigterm_stops_with_75_and_the_relaunch_is_exact(
        tmp_path, corpus, ckpts, port_run, monkeypatch):
    """``backfill_kill@1`` delivers a real SIGTERM at device batch 1: the
    handler stops at the batch boundary, main exits 75 with the shard in
    hand uncommitted; the relaunch balances the books and its verdict
    files equal the uninterrupted run's bitwise."""
    out = tmp_path / "run"
    argv = ["--manifest", corpus["manifest_path"], "--data-packed",
            corpus["pack"], "--out", str(out), "--model", MODEL,
            "--model-path", ckpts[0], "--batch-size", "8", "--workers", "2",
            "--device", "cpu", "--worker-name", "w"]
    monkeypatch.setenv("DFD_CHAOS", "backfill_kill@1")
    assert t_runner.main(argv) == EXIT_PREEMPTED
    first = collect_books(str(out), corpus["manifest"])
    assert not first["complete"] and first["shards_done"] >= 1
    monkeypatch.delenv("DFD_CHAOS")
    assert t_runner.main(argv) == 0
    books = collect_books(str(out), corpus["manifest"])
    assert books["balanced"], books
    ref, _ = port_run
    for sh in corpus["manifest"]["shards"]:
        with open(verdict_path(str(out), sh["id"]), "rb") as f, \
                open(verdict_path(str(ref), sh["id"]), "rb") as g:
            assert f.read() == g.read()


# ---------------------------------------------------------------------------
# the flags
# ---------------------------------------------------------------------------

def test_every_jax_backfill_flag_is_a_port_flag_with_its_default():
    from dataclasses import fields
    port = {f.name: f.default for f in fields(BackfillConfig)}
    for f in fields(JBackfillConfig):
        assert f.name in port and port[f.name] == f.default, f.name
    assert port["device"] == "cuda"
    cfg = BackfillConfig.from_args(["--manifest", "m.json", "--out", "o",
                                    "--data-packed", "p", "--dedup",
                                    "--batch-size", "4"])
    assert cfg.dedup and cfg.batch_size == 4 and cfg.lease_ttl_s == 600.0
    with pytest.raises(ValueError, match="exactly one"):
        BackfillConfig.from_args(["--manifest", "m", "--out", "o"])
    with pytest.raises(ValueError, match="--dedup needs"):
        BackfillConfig.from_args(["--manifest", "m", "--out", "o",
                                  "--data", "r", "--dedup"])


@pytest.mark.parametrize("argv,item", [
    (["--stem-s2d"], "item 12"),
    (["--warmstart-dir", "ws"], "item 10"),
    (["--compile-cache-dir", "cc"], "item 10"),
])
def test_unported_backfill_flags_raise_naming_their_item(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        BackfillConfig.from_args(["--manifest", "m", "--out", "o",
                                  "--data-packed", "p"] + argv)


def test_cuda_without_a_card_raises(tmp_path, corpus):
    if torch.cuda.is_available():
        pytest.skip("this box has a card: --device cuda scores")
    cfg = BackfillConfig(manifest=corpus["manifest_path"],
                         out=str(tmp_path / "run"),
                         data_packed=corpus["pack"], model=MODEL,
                         batch_size=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_backfill(cfg)

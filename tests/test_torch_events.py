"""PyTorch port, ``obs/events.py`` (the JSONL event/metrics log) against
the JAX package's copy, on the CPU.

The same records written by either package read back equal through
either reader; the torn-tail repair drops the same bytes; non-finite
floats become null (strict JSON); ``tools/obs_report.py`` reads a log the
port wrote.  All exact: the module is standard library only.
"""

import json
import math
import os
import sys
import threading

import numpy as np
import pytest

from deepfake_detection_tpu.obs import events as jev
from deepfake_detection_tpu_torch.obs import events as tev

pytestmark = pytest.mark.obs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _strip_t(recs):
    return [{k: v for k, v in r.items() if k != "t"} for r in recs]


def _write(mod, path):
    with mod.EventLog(path) as log:
        log.event("run_start", mode="backfill", num_clips=13,
                  shape=(2, 3), note="é")
        log.metrics(shard="shard-00000", clips=4, loss=float("nan"),
                    rate=np.float32(2.5), big=float("inf"),
                    nested={"a": [1.0, float("-inf")]})
        log.event("run_end", books={"balanced": True})
        return log.records_written


def test_records_equal_the_jax_log(tmp_path):
    tp, jp = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    assert _write(tev, tp) == _write(jev, jp) == 3
    got, want = tev.read_records(tp), jev.read_records(jp)
    assert _strip_t(got) == _strip_t(want)
    assert _strip_t(jev.read_records(tp)) == _strip_t(tev.read_records(jp))
    assert got[0]["v"] == tev.SCHEMA_VERSION == jev.SCHEMA_VERSION == 1
    assert got[1]["loss"] is None and got[1]["big"] is None
    assert got[1]["nested"] == {"a": [1.0, None]}
    assert got[1]["rate"] == 2.5 and got[0]["shape"] == [2, 3]
    for line in open(tp, encoding="utf-8"):
        json.loads(line, parse_constant=lambda c: pytest.fail(c))
    assert all(isinstance(r["t"], float) and math.isfinite(r["t"])
               for r in got)


@pytest.mark.parametrize("tail", [b'{"v":1,"type":"ev', b"x" * 5000, b""],
                         ids=["half_record", "long_garbage", "clean"])
def test_torn_tail_repair_matches_the_jax_repair(tmp_path, tail):
    paths = {}
    for name, mod in (("t", tev), ("j", jev)):
        p = str(tmp_path / f"{name}.jsonl")
        _write(mod, p)
        with open(p, "ab") as f:
            f.write(tail)
        paths[name] = p
    size = os.path.getsize(paths["t"])
    dropped = tev.repair_torn_tail(paths["t"])
    assert dropped == jev.repair_torn_tail(paths["j"]) == len(tail)
    assert os.path.getsize(paths["t"]) == size - len(tail)
    log = tev.EventLog(paths["t"])              # reopen: nothing more to drop
    assert log.torn_bytes_dropped == 0
    log.event("resumed")
    log.close()
    recs = tev.read_records(paths["t"])
    assert [r.get("event") or r["type"] for r in recs] == \
        ["run_start", "metrics", "run_end", "resumed"]


def test_reader_skips_corrupt_lines_and_old_schemas(tmp_path):
    p = str(tmp_path / "x.jsonl")
    with open(p, "w") as f:
        f.write('{"v":1,"type":"event","event":"a"}\n'
                "not json\n\n"
                '{"v":0,"type":"event","event":"old"}\n')
    assert [r["event"] for r in tev.iter_records(p)] == ["a", "old"]
    assert [r["event"] for r in tev.iter_records(p, strict_version=True)] \
        == ["a"] == [r["event"] for r in jev.iter_records(
            p, strict_version=True)]
    assert tev.repair_torn_tail(str(tmp_path / "absent.jsonl")) == 0


def test_concurrent_writers_keep_whole_lines(tmp_path):
    p = str(tmp_path / "c.jsonl")
    log = tev.EventLog(p)

    def writer(i):
        for j in range(50):
            log.metrics(worker=i, j=j, pad="x" * 200)

    ts = [threading.Thread(target=writer, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    log.close()
    log.event("after_close")                    # a no-op, never an error
    recs = tev.read_records(p)
    assert len(recs) == log.records_written == 200
    assert sorted((r["worker"], r["j"]) for r in recs) == \
        [(i, j) for i in range(4) for j in range(50)]


def test_obs_report_reads_a_port_log(tmp_path, capsys):
    run = tmp_path / "run"
    run.mkdir()
    with tev.EventLog(str(run / "telemetry-w.jsonl")) as log:
        log.event("run_start", mode="backfill", num_clips=4, shards_total=1,
                  fingerprint="ab" * 32, batch_size=4, worker="w")
        log.metrics(shard="shard-00000", clips=4, scored=4, failed=0,
                    resumed=0, clips_per_s=10.0, data_wait_s=0.1,
                    device_wait_s=0.2, host_s=0.01, backend_compiles=0)
        log.event("run_end", clips_this_proc=4, clips_per_s=10.0,
                  steady_recompiles=0,
                  books={"manifest_clips": 4, "scored": 4, "failed": 0,
                         "skipped_dup": 0, "balanced": True,
                         "complete": True, "shards_done": 1,
                         "shards_total": 1})
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import obs_report
    obs_report.main([str(run)])
    out = capsys.readouterr().out
    assert "backfill" in out and "BALANCED" in out and "shard-00000" in out

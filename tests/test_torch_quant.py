"""PyTorch port, weight-only PTQ (``serving/quant.py``) against the JAX
package, on the CPU.

The same seeded weights (the port's, calibrated as in
``tests/test_torch_serving.py``) cross to JAX through
``tools/convert_torch_checkpoint.convert_state_dict``; inputs are made from
a seed with numpy.  Models: the flagship ``efficientnet_deepfake_v4``
narrowed as in ``tests/test_torch_serving.py`` (``channel_multiplier``
0.25, ``depth_multiplier`` 0.34, so a depthwise stage is on the path) at a
64² canvas, and ``vit_tiny_patch16_224`` for the int8 set (its qkv columns
are reordered by the bridge; its ``pos_embed`` and ``cls_token`` are 3-d
parameters that are not kernels).

Tolerances: ``quantize_leaf`` bitwise; the quantized and realized tensors
bitwise the JAX ones once bridged; P(fake) port against JAX within 1e-5 at
f32, bf16 and int8 (both compute in f32 on the same realized weights, in
other orders); inside the port, padded rows and reloads bitwise; drift
from f32 within 0.02 (bf16) and 0.06 (int8), the JAX bounds
(``tests/test_serving_quant.py``, SERVE_BENCH.md).
"""

import numpy as np
import pytest
import torch

import deepfake_detection_tpu.runners.test as j_runner
from deepfake_detection_tpu.models import create_model as j_create_model
from deepfake_detection_tpu.models.helpers import save_model_checkpoint
from deepfake_detection_tpu.serving import quant as jq
from deepfake_detection_tpu.serving.engine import \
    InferenceEngine as JInferenceEngine
from deepfake_detection_tpu_torch.convert import flax_leaf
from deepfake_detection_tpu_torch.models import create_model
from deepfake_detection_tpu_torch.params import (normalize_replicate,
                                                 prepare_canvas)
from deepfake_detection_tpu_torch.runners import serve as serve_runner
from deepfake_detection_tpu_torch.runners import test as t_runner
from deepfake_detection_tpu_torch.serving import quant as tq
from deepfake_detection_tpu_torch.serving.config import (ServeConfig,
                                                         parse_model_spec)
from deepfake_detection_tpu_torch.serving.engine import InferenceEngine
from tools.convert_torch_checkpoint import convert_state_dict

torch.set_num_threads(2)

pytestmark = pytest.mark.quant

NAME = "efficientnet_deepfake_v4"
KW = dict(num_classes=2, in_chans=12, channel_multiplier=0.25,
          depth_multiplier=0.34)
SIZE = 64
BUCKETS = (1, 4)
TOL = 1e-5
DRIFT = {"bf16": 0.02, "int8": 0.06}
MODES = ("f32", "bf16", "int8")


def _frame(seed: int, hw=(90, 70)) -> np.ndarray:
    """Smooth content plus noise, uint8 (H, W, 3), not canvas-sized."""
    h, w = hw
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 127 + 100 * np.sin(xx[..., None] / (5 + seed % 7)
                              + yy[..., None] / 7 + np.arange(3) * seed)
    return np.clip(base + rng.normal(0, 20, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _payloads(n: int, seed: int = 0):
    return [normalize_replicate(prepare_canvas(
        _frame(seed + i, (60 + 7 * i, 90 - 5 * i)), SIZE), 4)
        for i in range(n)]


@pytest.fixture(scope="module")
def state():
    """The narrowed flagship, BN calibrated by one train-mode pass over 32
    seeded clips (running stats := the batch's)."""
    model = create_model(NAME, bn_momentum=1.0, device="cpu", **KW)
    batch = np.stack(_payloads(8, seed=100))
    rng = np.random.default_rng(1)
    calib = np.concatenate([batch] + [
        batch + 0.3 * rng.standard_normal(batch.shape).astype(np.float32)
        for _ in range(3)])
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(calib).permute(0, 3, 1, 2))
    return {k: v.clone() for k, v in model.eval().state_dict().items()}


def _port_model(sd):
    model = create_model(NAME, device="cpu", **KW)
    model.load_state_dict(sd)
    return model.eval()


@pytest.fixture(scope="module")
def jax_side(state):
    return j_create_model(NAME, **KW), convert_state_dict(
        {k: v.numpy() for k, v in state.items()})


# ---------------------------------------------------------------------------
# quantize_leaf and the quantized set
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hwio", [(3, 3, 8, 16), (5, 5, 1, 24), (32, 10),
                                  (1, 1, 12, 7)],
                         ids=["conv", "depthwise", "dense", "pointwise"])
def test_quantize_leaf_is_bitwise_jax(hwio):
    """Random weights with an all-zero output channel, a NaN one and an
    inf one: the port's int8 values and scales are the JAX function's,
    on flax's layout (axis -1) and on torch's (axis 0) after the
    transpose."""
    rng = np.random.default_rng(len(hwio) * 100 + hwio[-1])
    w = (rng.standard_normal(hwio) * rng.uniform(0.01, 3, hwio[-1])
         ).astype(np.float32)
    w[..., 0] = 0.0
    w[..., 1].flat[0] = np.nan
    w[..., 2].flat[-1] = np.inf
    jqv, js = jq.quantize_leaf(w)
    q, s = tq.quantize_leaf(w, axis=-1)
    np.testing.assert_array_equal(q, jqv)
    assert s.tobytes() == js.tobytes()               # NaN scales included
    torch_w = np.ascontiguousarray(np.moveaxis(w, -1, 0))
    q0, s0 = tq.quantize_leaf(torch_w)
    np.testing.assert_array_equal(q0, np.moveaxis(jqv, -1, 0))
    assert s0.tobytes() == js.tobytes()
    assert s[0] == 1.0 and np.isnan(s[1]) and np.isnan(s[2])
    assert np.all(q[..., 0] == 0)


def _bridged_store(sd, mode, num_heads=None):
    """The port's quantized store of ``sd`` (a module's state dict), and
    its tensors realized, each carried to flax's layout by the bridge."""
    model_params = {k for k in sd if flax_leaf(k) not in (
        "mean", "var", "num_batches_tracked")}
    bf16, int8 = tq.ptq_names(sd, model_params)
    store = tq.quantized_store(sd, mode, bf16_names=bf16, int8_names=int8)
    real = tq.realize(store)
    q = {k: (v.q.float() if isinstance(v, tq.Q8) else v.float()).numpy()
         for k, v in store.items()}
    return (store, convert_state_dict(q, num_heads=num_heads),
            convert_state_dict({k: v.numpy() for k, v in real.items()},
                               num_heads=num_heads))


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and not jq.is_quantized_leaf(v):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


@pytest.mark.parametrize("family", ["flagship", "vit_tiny"])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_quantized_set_equals_the_bridged_jax_set(state, family, mode):
    """The tensors the port quantizes are, once bridged, exactly the
    leaves the JAX package quantizes (by the bridge's naming: the ViT's
    pos_embed and cls_token stay f32), with bitwise-equal int8 values
    (after the qkv column reorder), bf16 values and realized weights."""
    if family == "flagship":
        sd, heads = {k: v.clone() for k, v in state.items()}, None
    else:
        sd = create_model("vit_tiny_patch16_224", num_classes=2, in_chans=12,
                          img_size=32, device="cpu").state_dict()
        heads = 3
    jvars = convert_state_dict({k: v.numpy() for k, v in sd.items()},
                               num_heads=heads)
    jtree = _flat(jq.quantize_tree(jvars, mode))
    jreal = _flat(jq.realize_tree(jq.quantize_tree(jvars, mode)))
    store, q_tree, real_tree = _bridged_store(sd, mode, heads)
    want = {p: v for p, v in jtree.items() if (
        jq.is_quantized_leaf(v) if mode == "int8"
        else np.asarray(v).dtype != np.float32)}
    got = _flat(q_tree["params"])
    real = _flat(real_tree["params"])
    assert {("params",) + p for p in got} == set(want), \
        sorted(set(want) ^ {("params",) + p for p in got})[:6]
    for p, v in got.items():
        j = want[("params",) + p]
        ref = j[jq._QKEY] if mode == "int8" else j
        np.testing.assert_array_equal(v, np.asarray(ref, np.float32))
        assert real[p].tobytes() == np.asarray(
            jreal[("params",) + p], np.float32).tobytes()
    if family == "vit_tiny":
        assert "blocks.0.attn.qkv.weight" in store
        assert ("pos_embed" in store) == ("cls_token" in store) == \
            (mode == "bf16")
    assert all((isinstance(v, tq.Q8) and v.q.dtype == torch.int8
                and v.scale.dtype == torch.float32) if mode == "int8"
               else v.dtype == torch.bfloat16 for v in store.values())


def test_f32_is_the_identity_and_adds_no_operation(state):
    sd = dict(state)
    assert tq.quantized_store(sd, "float32", bf16_names=sd,
                              int8_names=sd) is None
    model = _port_model(state)
    assert tq.module_forward(model, None) is model
    assert tq.quantize_module(model, "f32") is None
    assert all(p.device.type == "cpu" for p in model.parameters())
    with pytest.raises(ValueError, match="f32"):
        tq.canonical_mode("fp8")


# ---------------------------------------------------------------------------
# the CLI against the JAX CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    d = tmp_path_factory.mktemp("qframes")
    paths = []
    for i in range(4):
        path = d / f"f{i}.npy"
        np.save(path, _frame(20 + i, (70 + 9 * i, 60)))
        paths.append(str(path))
    return paths


@pytest.fixture(scope="module")
def ckpts(state, tmp_path_factory):
    d = tmp_path_factory.mktemp("qckpt")
    torch.save(state, d / "narrow.pth")
    save_model_checkpoint(str(d / "narrow.msgpack"), convert_state_dict(
        {k: v.numpy() for k, v in state.items()}))
    return str(d / "narrow.pth"), str(d / "narrow.msgpack")


@pytest.fixture
def narrowed_clis(monkeypatch):
    """Both CLIs build the narrowed flagship (their own code otherwise),
    and the JAX one reads ``.npy`` frames through the same uint8 array."""
    from PIL import Image
    monkeypatch.setattr(
        t_runner, "create_deepfake_model_v4",
        lambda name, num_classes, in_chans, device: create_model(
            NAME, device=device, **KW))
    monkeypatch.setattr(j_runner, "create_deepfake_model_v4",
                        lambda name, num_classes, in_chans: j_create_model(
                            NAME, **KW))
    real_open = Image.open
    monkeypatch.setattr(j_runner.Image, "open", lambda f: (
        Image.fromarray(np.load(f)) if str(f).endswith(".npy")
        else real_open(f)))


@pytest.mark.parametrize("dtype", MODES)
def test_cli_matches_the_jax_cli(narrowed_clis, frames, ckpts, dtype, capsys):
    pth, msgpack = ckpts
    got = np.asarray(t_runner.test_img(pth, frames, size=SIZE, dtype=dtype,
                                       device="cpu"))
    out = capsys.readouterr().out
    want = np.asarray(j_runner.test_img(msgpack, frames, size=SIZE,
                                        dtype=dtype))
    assert got.shape == want.shape == (4,)
    assert np.abs(want - 0.5).max() > 1e-3, want
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert ("Quantized weights to" in out) == (dtype != "f32")


def test_cli_main_takes_every_dtype(narrowed_clis, frames, ckpts, capsys):
    for dtype in MODES:
        t_runner.main([frames[0], "--model-path", ckpts[0], "--image-size",
                       str(SIZE), "--dtype", dtype, "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("fake score:") == 3
    assert "'quantized_leaves': 0, " in out and "'bf16_leaves': 0, " in out
    with pytest.raises(SystemExit):
        t_runner.main([frames[0], "--dtype", "fp8", "--device", "cpu"])


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines(state, jax_side):
    """Per dtype: (port engine, JAX engine), float32 wire, buckets 1, 4."""
    jm, jv = jax_side
    return {dtype: (InferenceEngine(_port_model(state), image_size=SIZE,
                                    img_num=4, buckets=BUCKETS, dtype=dtype,
                                    watchdog_timeout_s=0.0),
                    JInferenceEngine(jm, jv, image_size=SIZE, img_num=4,
                                     buckets=BUCKETS, dtype=dtype,
                                     watchdog_timeout_s=0.0))
            for dtype in MODES}


@pytest.mark.parametrize("dtype", MODES)
def test_engine_scores_match_jax(engines, dtype):
    port, ref = engines[dtype]
    for n in (1, 3):
        xs = _payloads(n, seed=7 * n)
        got, want = port.score_batch(xs), ref.score_batch(xs)
        assert got.shape == want.shape == (n, 2)
        assert np.abs(want[:, 0] - 0.5).max() > 1e-3, want
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_quantized_engine_padded_rows_and_drift(engines, dtype):
    port, _ = engines[dtype]
    xs = _payloads(4, seed=40)
    padded = port.score_batch(xs[:3])         # bucket 4, one pad row
    full = port.score_batch(xs)
    np.testing.assert_array_equal(padded, full[:3])
    f32 = engines["f32"][0].score_batch(xs)
    drift = float(np.abs(full[:, 0] - f32[:, 0]).max())
    assert 0.0 < drift <= DRIFT[dtype], drift
    # the JAX engine drifts from its own f32 as much
    jd = float(np.abs(engines[dtype][1].score_batch(xs)[:, 0]
                      - engines["f32"][1].score_batch(xs)[:, 0]).max())
    assert abs(drift - jd) <= TOL


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_resident_store_replaces_the_f32_copies(engines, state, dtype):
    port, _ = engines[dtype]
    entry = port.entry()
    assert entry.dtype == dtype
    assert port.readiness_detail()["models"][entry.model_id]["dtype"] == dtype
    stripped = {k for k, v in entry.model.state_dict().items()
                if v.device.type == "meta"}
    assert stripped == set(entry.store) and stripped
    f32_bytes = sum(v.numel() * v.element_size() for v in state.values())
    assert entry.resident_bytes() < f32_bytes
    if dtype == "int8":
        assert all(flax_leaf(k) == "kernel" for k in stripped)
        assert any(".conv_dw." in k for k in stripped)
    summary = tq.quant_summary(entry.store)
    key = "quantized_leaves" if dtype == "int8" else "bf16_leaves"
    assert summary[key] == len(entry.store)


def test_f32_engine_program_is_the_module_bitwise(engines, state):
    """At f32 the program inserts no operation: it is the module's forward,
    bitwise the plain model's scores."""
    port, _ = engines["f32"]
    assert port.entry().store is None
    xs = _payloads(4, seed=3)
    model = _port_model(state)
    with torch.no_grad():
        plain = torch.softmax(model(torch.from_numpy(np.stack(xs))
                                    .permute(0, 3, 1, 2)), -1).numpy()
    np.testing.assert_array_equal(port.score_batch(xs), plain)


def _perturbed(state, seed):
    g = torch.Generator().manual_seed(seed)
    return {k: (v * (1 + 0.02 * torch.randn(v.shape, generator=g))
                if v.dim() >= 2 else v.clone()) for k, v in state.items()}


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_quantized_reload_equals_a_fresh_quantization(state, dtype):
    eng = InferenceEngine(_port_model(state), image_size=SIZE, img_num=4,
                          buckets=(1,), dtype=dtype, watchdog_timeout_s=0.0)
    entry = eng.entry()
    ptrs = {k: [t.data_ptr() for t in (v if isinstance(v, tuple) else (v,))]
            for k, v in entry.store.items()}
    xs = _payloads(1, seed=5)
    before = eng.score_batch(xs)
    new = _perturbed(state, 11)
    eng.submit_reload(new, source="test")
    eng._maybe_apply_reload()
    assert eng.reload_count == 1
    got = eng.score_batch(xs)
    assert np.abs(got - before).max() > 0
    fresh = InferenceEngine(_port_model(new), image_size=SIZE, img_num=4,
                            buckets=(1,), dtype=dtype, watchdog_timeout_s=0.0)
    np.testing.assert_array_equal(got, fresh.score_batch(xs))
    assert entry.fingerprint == fresh.entry().fingerprint
    # the store was written in place, never rebound
    assert ptrs == {k: [t.data_ptr() for t in (v if isinstance(v, tuple)
                                               else (v,))]
                    for k, v in entry.store.items()}


def _nan_kernels(state):
    """NaN in one output channel of every conv kernel only: biases, BN
    and the classifier stay finite."""
    out = {k: v.clone() for k, v in state.items()}
    for k, v in out.items():
        if flax_leaf(k) == "kernel" and v.dim() == 4:
            v[0] = float("nan")
    return out


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("bad", ["all_nan", "nan_kernels"])
def test_canary_rejects_poisoned_checkpoints(state, dtype, bad):
    eng = InferenceEngine(_port_model(state), image_size=SIZE, img_num=4,
                          buckets=(1,), dtype=dtype, watchdog_timeout_s=0.0)
    xs = _payloads(1, seed=6)
    before = eng.score_batch(xs)
    poison = ({k: torch.full_like(v, float("nan"))
               if v.is_floating_point() else v for k, v in state.items()}
              if bad == "all_nan" else _nan_kernels(state))
    errors = eng.metrics.reload_errors_total.value
    eng.submit_reload(poison, source="poison")
    eng._maybe_apply_reload()
    assert eng.reload_count == 0
    assert eng.metrics.reload_errors_total.value == errors + 1
    assert eng.metrics.reload_canary_failures_total.value >= 1
    np.testing.assert_array_equal(eng.score_batch(xs), before)


# ---------------------------------------------------------------------------
# the flags
# ---------------------------------------------------------------------------

def test_dtype_flags_parse_and_build_a_quantized_table(state, tmp_path):
    ckpt = tmp_path / "narrow.pth"
    torch.save(state, ckpt)
    assert ServeConfig.from_args(["--dtype", "bfloat16"]).dtype == "bf16"
    assert parse_model_spec("s=x,dtype=float32", default_size=32,
                            default_img_num=4)["dtype"] == "f32"
    with pytest.raises(ValueError, match="f32|bf16|int8"):
        ServeConfig.from_args(["--dtype", "fp16"])
    cfg = ServeConfig.from_args([
        "--device", "cpu", "--image-size", str(SIZE), "--buckets", "1",
        "--max-queue", "4", "--dtype", "int8", "--model-path", str(ckpt),
        "--models", f"student={NAME},size=32,dtype=bf16",
        "--watchdog-timeout-s", "0"])
    eng, batcher, _ = _build_narrowed(cfg)
    try:
        detail = eng.readiness_detail()["models"]
        assert detail[NAME]["dtype"] == "int8"
        assert detail["student"]["dtype"] == "bf16"
        assert eng.compile_count == 2
        s = eng.score_batch(_payloads(1, seed=2))
        assert np.isfinite(s).all()
    finally:
        eng.stop()
        batcher.close()


def _build_narrowed(cfg):
    import deepfake_detection_tpu_torch.models as models
    real = models.create_model
    models.create_model = lambda family, **kw: real(
        family, channel_multiplier=0.25, depth_multiplier=0.34, **kw)
    try:
        return serve_runner.build_engine(cfg)
    finally:
        models.create_model = real

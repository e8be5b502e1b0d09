"""PyTorch port, the transformer families through the factory and the
training runner on CPU.

* ``runners.train --device cpu --model timesformer_tiny_patch16_224
  --input-size-v2 12,32,32 --attn-impl flash`` trains a short epoch (8
  steps, rmsproptf, mixup, EMA), validates and writes its checkpoints; the
  EMA reloaded from ``last.pth.tar`` into a fresh run scores the eval set
  as the run's last validation did.
* ``--attn-impl ring`` (and ``ring_flash``, ``ulysses``) raise as in the JAX
  runner.
* The factory's family rules: BN arguments dropped outside EfficientNet,
  ``attn_impl`` checked and dropped outside the transformers, ``img_size``
  only for the transformers, ``drop_connect_rate`` → ``drop_path_rate``;
  ``TrainConfig.input_size()`` reads any registered family's default.
"""

import logging

import numpy as np
import pytest
import torch

from deepfake_detection_tpu_torch.models import create_model, default_cfg
from deepfake_detection_tpu_torch.models.helpers import load_checkpoint
from deepfake_detection_tpu_torch.runners import train as runner
from deepfake_detection_tpu_torch.train.trainer import validate

torch.set_num_threads(2)

ARGS = ["--device", "cpu", "--dataset", "synthetic", "--model",
        "timesformer_tiny_patch16_224", "--model-version", "",
        "--input-size-v2", "12,32,32", "--attn-impl", "flash", "-b", "2",
        "--epochs", "1", "--opt", "rmsproptf", "--lr", "1e-3", "--mixup",
        "0.1", "--model-ema", "--log-interval", "4", "--seed", "5",
        "--compute-dtype", "float32"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = tmp_path_factory.mktemp("tsf_train")
    cfg = runner.parse_args(ARGS + ["--output", str(out)])
    return cfg, runner.main(cfg)


def test_runner_trains_timesformer_with_flash_on_cpu(trained):
    cfg, result = trained
    assert cfg.attn_impl == "flash" and cfg.input_size() == (12, 32, 32)
    assert len(result["train"]["step_s"]) == 8          # 16 clips / b2
    assert result["train"]["nonfinite"] == 0
    assert np.isfinite(result["train"]["loss"])
    assert np.isfinite(result["eval"]["loss"])
    ckpt = torch.load(f"{result['output_dir']}/last.pth.tar",
                      map_location="cpu", weights_only=True)
    assert ckpt["arch"] == "timesformer_tiny_patch16_224"
    assert "blocks.11.attn_s.qkv.weight" in ckpt["state_dict"]
    assert ckpt["state_dict"]["time_embed"].shape == (1, 4, 1, 192)


def test_checkpoint_reloads_and_scores_as_the_run(trained):
    cfg, result = trained
    run = runner.setup(cfg)
    assert run.state.model.blocks[0].attn_s.attn_impl == "flash"
    load_checkpoint(run.state.model, f"{result['output_dir']}/last.pth.tar",
                    use_ema=True)
    again = validate(run.eval_step, run.state, run.eval_loader, cfg)
    assert again["loss"] == pytest.approx(result["eval"]["loss"], rel=1e-6)
    assert again["prec1"] == pytest.approx(result["eval"]["prec1"])


@pytest.mark.parametrize("impl", ["ring", "ring_flash", "ulysses"])
def test_sequence_parallel_attn_impls_raise(impl):
    cfg = runner.parse_args(ARGS + ["--attn-impl", impl])
    with pytest.raises(ValueError, match="sequence-parallel"):
        runner.setup(cfg)
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        create_model("vit_tiny_patch16_224", attn_impl=impl, device="cpu")


def test_factory_family_rules(caplog):
    with caplog.at_level(logging.WARNING):
        m = create_model("efficientnet_b0", attn_impl="flash", img_size=64,
                         bn_momentum=0.01, device="cpu")
    assert "only consumed by" in caplog.text
    assert m.bn1.momentum == pytest.approx(0.01)
    with pytest.raises(ValueError, match="expected one of"):
        create_model("vit_tiny_patch16_224", attn_impl="flsh", device="cpu")
    vit = create_model("vit_tiny_patch16_224", num_classes=2, img_size=32,
                       bn_momentum=0.01, bn_eps=1e-3, drop_connect_rate=0.1,
                       device="cpu")
    assert vit.pos_embed.shape == (1, 5, 192)
    assert vit.blocks[-1].drop_path_rate == pytest.approx(0.1)
    tsf = create_model("timesformer_tiny_patch16_224", in_chans=6,
                       drop_rate=0.0, device="cpu")
    assert tsf.time_embed.shape == (1, 2, 1, 192)
    assert tsf.default_cfg["input_size"] == (6, 224, 224)
    with pytest.raises(ValueError, match="no dropout"):
        create_model("timesformer_tiny_patch16_224", drop_rate=0.1,
                     device="cpu")
    assert default_cfg("timesformer_base_patch25_600")["input_size"] == \
        (12, 600, 600)
    for name, size in (("vit_base_patch16_384", (3, 384, 384)),
                       ("timesformer_tiny_patch16_224", (12, 224, 224)),
                       ("efficientnet_deepfake_v4", (12, 600, 600))):
        assert runner.TrainConfig(model=name).input_size() == size


def test_weight_decay_mask_matches_the_jax_rule():
    """Decay exactly the parameters with ndim > 1, as the JAX optimizer's
    mask: kernels, the patch conv and the position/time embeddings; not
    LayerNorm or biases."""
    from deepfake_detection_tpu_torch.optim.factory import param_groups
    m = create_model("timesformer_tiny_patch16_224", device="cpu")
    names = {id(p): n for n, p in m.named_parameters()}
    decayed, plain = param_groups(m, 1e-5)
    got = {names[id(p)] for p in decayed["params"]}
    assert {"pos_embed", "time_embed", "patch_embed.proj.weight",
            "blocks.0.attn_t.qkv.weight", "head.weight"} <= got
    assert not any(n.endswith("bias") or "norm" in n for n in got)
    assert {names[id(p)] for p in plain["params"]} == \
        {n for n, p in m.named_parameters() if p.dim() <= 1}

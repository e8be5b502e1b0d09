"""PyTorch port, the inference slice as a whole: the port's
``runners.test.test_img`` against the JAX package's on the full-depth
flagship ``efficientnet_deepfake_v4`` (55 blocks) at a 64² canvas, CPU.

The weights are the port's seeded init with BN calibrated by one train-mode
pass (running stats := the batch's), so scores are not the 0.5/0.5 of a
fresh init.  The calibration batch is the 8 test frames and 3 noisy copies
of each: the flagship's last stages are 2×2 at 64², and stats from 8
frames alone left ill-conditioned channels that amplified rounding to
1.6e-4 in P(fake); with 32 samples the two packages agree to ~1e-6.
The weights cross to JAX through
``tools/convert_torch_checkpoint.convert_state_dict`` and the JAX
``save_model_checkpoint``; the port reads the ``torch.save``d state dict.
P(fake) agrees to ≤ 1e-4 absolute (f32 through 55 blocks, summed in
different orders by XLA and torch).
"""

import numpy as np
import pytest
import torch
from PIL import Image

from deepfake_detection_tpu.models.helpers import save_model_checkpoint
from deepfake_detection_tpu.runners import test as j_runner
from deepfake_detection_tpu_torch.models import create_deepfake_model_v4
from deepfake_detection_tpu_torch.runners import test as t_runner
from tools.convert_torch_checkpoint import convert_state_dict

torch.set_num_threads(2)

SIZE = 64
# non-canvas sizes: portrait, landscape, up- and down-scale
FRAME_HW = [(90, 50), (40, 77), (130, 120), (33, 33),
            (64, 100), (100, 64), (57, 31), (200, 180)]


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate(FRAME_HW):
        # smooth content plus noise, so resizing is not averaging white noise
        yy, xx = np.mgrid[0:h, 0:w]
        base = 127 + 100 * np.sin(xx[..., None] / (5 + i) + yy[..., None]
                                  / 7 + np.arange(3) * i)
        img = np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255)
        path = d / f"frame{i}.png"
        Image.fromarray(img.astype(np.uint8)).save(path)
        paths.append(str(path))
    return paths


def test_cli_scores_match_jax_on_calibrated_flagship(frames, tmp_path):
    model = create_deepfake_model_v4(bn_momentum=1.0, device="cpu")
    batch = np.concatenate([t_runner.preprocess(f, SIZE) for f in frames])
    rng = np.random.default_rng(1)
    calib = np.concatenate([batch] + [
        batch + 0.3 * rng.standard_normal(batch.shape).astype(np.float32)
        for _ in range(3)])
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(calib).permute(0, 3, 1, 2))
    sd = model.state_dict()
    port_ckpt = tmp_path / "flagship.pth"
    torch.save(sd, port_ckpt)
    jax_ckpt = tmp_path / "flagship.msgpack"
    save_model_checkpoint(str(jax_ckpt), convert_state_dict(sd))

    for clip in (False, True):
        ref = np.asarray(j_runner.test_img(str(jax_ckpt), frames, size=SIZE,
                                           clip=clip))
        got = np.asarray(t_runner.test_img(str(port_ckpt), frames, size=SIZE,
                                           clip=clip, device="cpu"))
        assert got.shape == ref.shape == (len(frames) // (4 if clip else 1),)
        assert np.all(np.isfinite(got))
        assert np.abs(ref - 0.5).max() > 1e-3, ref      # non-degenerate
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_cli_reads_npy_frames_like_images(frames, tmp_path):
    """A ``.npy`` uint8 frame preprocesses exactly like the image file it
    came from (the card has no Pillow, so the smoke feeds ``.npy``)."""
    img = np.asarray(Image.open(frames[0]).convert("RGB"), np.uint8)
    npy = tmp_path / "frame0.npy"
    np.save(npy, img)
    np.testing.assert_array_equal(t_runner.preprocess(str(npy), SIZE),
                                  t_runner.preprocess(frames[0], SIZE))
    np.testing.assert_array_equal(t_runner.preprocess(frames[0], SIZE),
                                  j_runner.preprocess(frames[0], SIZE))


def test_cli_rejects_what_is_not_ported(frames):
    with pytest.raises(NotImplementedError, match="bf16"):
        t_runner.test_img(None, frames[:1], size=SIZE, dtype="bf16",
                          device="cpu")
    with pytest.raises(ValueError, match="multiple of img_num"):
        t_runner.test_img(None, frames[:3], size=SIZE, clip=True,
                          device="cpu")

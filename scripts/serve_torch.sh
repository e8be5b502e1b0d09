#!/usr/bin/env bash
# The serving replica on one NVIDIA H100 through the PyTorch port: the
# counterpart of scripts/serve.sh with the port's runner,
# deepfake_detection_tpu_torch.runners.serve.  MODEL_PATH names the torch
# checkpoint (timm keys; a train_torch.sh run's model_best.pth.tar works,
# --use-ema picks its EMA stream); extra flags pass through, e.g.:
#   scripts/serve_torch.sh --wire uint8 --buckets 1,4,16,64
#   scripts/serve_torch.sh --reload-dir ../output/train/flagship
#   scripts/serve_torch.sh \
#     --models "student=efficientnet_deepfake_v4,size=300" \
#     --cascade student --cascade-low 0.2 --cascade-high 0.8
# Every bucket is captured as a CUDA graph before /readyz turns 200.
# POST /score takes .npy frames (uint8 H x W x 3) without Pillow, other
# image formats where Pillow is installed.  --device cpu runs the same
# programs eagerly (tests); --dtype bf16|int8, --warmstart-dir,
# --compile-cache-dir and --single-thread-xla raise (not ported).
python -m deepfake_detection_tpu_torch.runners.serve \
    --model-path "${MODEL_PATH:-../models/model_best.pth.tar}" "$@"

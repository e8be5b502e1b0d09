#!/usr/bin/env bash
# The streaming-video scoring server on one NVIDIA H100 through the
# PyTorch port: the counterpart of scripts/stream.sh with the port's
# runner, deepfake_detection_tpu_torch.runners.stream.  MODEL_PATH names
# the torch checkpoint (timm keys); extra flags pass through, e.g.:
#   scripts/stream_torch.sh --window-hop 2 --state-dir ../output/streams
#   scripts/stream_torch.sh --wire uint8 --buckets 1,4,16 --dtype int8
# Windows score through the server's CUDA graphs, all captured before
# /readyz turns 200.  Raw uint8 RGB frames need no decoder:
#   curl -s -X POST http://127.0.0.1:8378/streams     # -> {"stream_id": ID}
#   curl -s -X POST --data-binary @frames.rgb \
#     -H 'Content-Type: application/x-dfd-raw' \
#     -H 'X-Frame-Width: 640' -H 'X-Frame-Height: 480' \
#     http://127.0.0.1:8378/streams/ID/frames
# JPEG, MJPEG and image/* chunks need Pillow and answer 501 without it;
# video/* needs an ffmpeg binary (501 without).  --device cpu runs the
# same programs eagerly (tests).  --warmstart-dir STORE reuses the kernel
# libraries and capture manifests of an earlier start (serve_torch.sh);
# the XLA-only --compile-cache-dir and --single-thread-xla raise.
python -m deepfake_detection_tpu_torch.runners.stream \
    --model-path "${MODEL_PATH:-../models/model_best.pth.tar}" "$@"

#!/usr/bin/env bash
# The fleet router in front of N replicas of the PyTorch port on one
# NVIDIA H100: the counterpart of scripts/router.sh with the port's
# runner, deepfake_detection_tpu_torch.runners.router.  The router process
# imports no torch; each spawned replica is its own process with its own
# CUDA context and graphs on the card (--device cuda).  MODEL_PATH names
# the torch checkpoint the spawned replicas serve; extra flags pass
# through to the router, e.g.:
#   scripts/router_torch.sh --spawn 4
#   scripts/router_torch.sh --spawn 2 --spawn-runner stream
#   scripts/router_torch.sh --spawn 1 --autoscale --max-replicas 3 \
#     --backfill-tenant run/manifest.json --backfill-out run/ \
#     --backfill-args "--data-packed pack/ --model-path model.pth --device cuda"
#   curl -s http://127.0.0.1:8380/replicas           # fleet view
#   curl -s -X POST http://127.0.0.1:8380/replicas/127.0.0.1:8377/drain
# --single-thread-xla is XLA-only and raises in the port's replicas: it is
# not passed here (scripts/router.sh passes it to the JAX replicas).
python -m deepfake_detection_tpu_torch.runners.router \
    --replica-args "--model-path ${MODEL_PATH:-../models/model_best.pth.tar} \
--device cuda --wire uint8 --buckets 1,4,16" "$@"

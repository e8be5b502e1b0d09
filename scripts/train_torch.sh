#!/usr/bin/env bash
# Canonical flagship training config (reference scripts/train.sh:3-22) on
# one NVIDIA H100 through the PyTorch port: scripts/train.sh's command line
# and restart loop with the port's runner, deepfake_detection_tpu_torch.
# Usage: bash scripts/train_torch.sh ROOT [more runner flags]
# (ROOT: the clip tree; --data-packed DIR reads a pack of it).
# AugMix (timm's split-view recipe: a clean and two AugMix views a clip,
# the JSD loss, an auxiliary BN for each augmented split; it excludes
# mixup, so the later --mixup 0 overrides the line's):
#   bash scripts/train_torch.sh ROOT --mixup 0 --aug-splits 3 --jsd --split-bn
#
# Restart-on-preemption wrapper: the runner's exit-code contract
# (deepfake_detection_tpu_torch/train/resilience.py) is 75 = preempted
# with a recovery snapshot on disk, 85 = stall-watchdog abort — both
# restartable.  Any such exit relaunches into --auto-resume (bit-continuous
# mid-epoch resume) with a bounded retry budget; any other exit code is
# final.  Tune with:
#   DFD_MAX_RESTARTS   restart budget (default 5)
#   DFD_EXPERIMENT     run name — REQUIRED for a stable output dir across
#                      relaunches (default "flagship")
attempt=0
max_restarts="${DFD_MAX_RESTARTS:-5}"
# an operator's Ctrl-C reaches the trainer (which exits 75 with a snapshot
# on disk) AND this shell — without the trap, bash would treat the child's
# handled-SIGINT exit as restartable and silently relaunch the run the
# operator just tried to stop
trap 'echo "train_torch.sh: interrupted; not relaunching (snapshot on disk)" >&2;
      exit 130' INT
while :; do
  export DFD_RESTART_COUNT="$attempt"
  python -m deepfake_detection_tpu_torch.runners.train \
    --data "$1" \
    --model efficientnet_deepfake_v4 --model-version v4 \
    --input-size-v2 12,600,600 \
    -b 3 \
    --opt rmsproptf --basic-lr 5e-7 \
    --sched step --decay-epochs 2 --decay-rate .92 \
    --epochs 200 \
    --amp \
    --reprob 0.2 --remax 0.05 \
    --flicker 0.05 --rotate-range 5 --blur-prob 0.05 \
    --bn-momentum 0.001 \
    --mixup 0.1 \
    --label-balance \
    --eval-metric loss \
    --workers 8 \
    --experiment "${DFD_EXPERIMENT:-flagship}" \
    --auto-resume \
    --recovery-interval 500 \
    "${@:2}"
  rc=$?
  case "$rc" in
    75|85) ;;                       # preempted / watchdog: restartable
    *) exit "$rc" ;;
  esac
  attempt=$((attempt + 1))
  if [ "$attempt" -gt "$max_restarts" ]; then
    echo "train_torch.sh: restart budget ($max_restarts) exhausted after" \
         "exit $rc" >&2
    exit "$rc"
  fi
  echo "train_torch.sh: exit $rc; relaunching into --auto-resume" \
       "($attempt/$max_restarts)" >&2
done

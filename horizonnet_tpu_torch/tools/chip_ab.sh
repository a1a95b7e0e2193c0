#!/bin/bash
# Parent-against-change comparison of the PyTorch port on one CUDA card.
#
#   bash horizonnet_tpu_torch/tools/chip_ab.sh PARENT_DIR CHANGE_DIR [PHASES...]
#
# PARENT_DIR and CHANGE_DIR are unpacked trees (`git archive`) of the two
# commits. Runs `python3 chip_smoke.py --phases PHASES` (default: kernel
# flagship fused) from each tree in turns, parent, change, change, parent,
# on the same card, and writes each run's log to
# $AB_OUT/ab_<n>_<parent|change>.txt (AB_OUT defaults to build/ab_logs).
# Then it compares the SASS of csrc/bilstm_fwd.cu (K1) and
# csrc/fused_bottleneck.cu (K4) built from both trees (sass_same.sh) and
# times K1, K2 and K3 at batch 1, 8 and 64 through each tree in the same
# turns (lstm_sweep.py: a parent's chip_smoke.py may not time them all).
# Exits non-zero if a run fails or the SASS differs.
set -u
parent=$(cd "$1" && pwd)
change=$(cd "$2" && pwd)
shift 2
phases=${*:-kernel flagship fused}
out=$(pwd)/${AB_OUT:-build/ab_logs}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
rc=0
n=0
for side in parent change change parent; do
  n=$((n + 1))
  dir=${!side}
  log="$out/ab_${n}_${side}.txt"
  echo "== run $n: $side ($phases)"
  (cd "$dir" && python3 chip_smoke.py --phases $phases) > "$log" 2>&1
  r=$?
  echo "rc=$r"
  [ $r -eq 0 ] || rc=1
  grep -E "^K1 recurrence|^K4 bf16 \[|^K4 over|^flagship resnet50|^  *K1 bound|serving unfused|^K2 bf16|^K2/K3|^bilstm_(train_fwd|bwd) bound|^bi-LSTM layer bf16 \[T=256,B=8|^train resnet50|^train step stages|^profiler, per step|^  .*(recurrence|backward|bilstm)" "$log"
done
tools=$(cd "$(dirname "$0")" && pwd)
for src in bilstm_fwd.cu fused_bottleneck.cu; do
  bash "$tools/sass_same.sh" "$parent" "$change" $src || rc=1
done
python3 "$tools/lstm_sweep.py" "$parent" "$change" "$change" "$parent" || rc=1
exit $rc

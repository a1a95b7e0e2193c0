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
# Then it compares the SASS of csrc/bilstm_train.cu (K2/K3) built from both
# trees (sass_same.sh) and times K1 at batch 1, 8 and 64 through each tree
# in the same turns (k1_sweep.py: a parent's chip_smoke.py may not time
# the small batches). Exits non-zero if a run fails or the SASS differs.
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
  grep -E "^K1 recurrence|^K4 bf16 \[|^K4 over|^flagship resnet50|^  *K1 bound|serving unfused" "$log"
done
tools=$(cd "$(dirname "$0")" && pwd)
bash "$tools/sass_same.sh" "$parent" "$change" bilstm_train.cu || rc=1
python3 "$tools/k1_sweep.py" "$parent" "$change" "$change" "$parent" || rc=1
exit $rc

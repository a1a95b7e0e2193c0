#!/bin/bash
# Whether one kernel source of the port builds to the same SASS in two
# trees.
#
#   bash horizonnet_tpu_torch/tools/sass_same.sh TREE_A TREE_B SOURCE
#
# SOURCE is a file name under horizonnet_tpu_torch/csrc/ (bilstm_train.cu,
# say). Builds it from each tree with the port's nvcc flags for sm_90a,
# dumps the SASS with cuobjdump and compares the instructions. Kernel names
# are left out of the comparison, so a renamed kernel or template argument
# alone is no change. Prints whether they match; exits 1 if they differ.
# Needs the CUDA toolkit under /usr/local/cuda.
set -u
tmp=$(mktemp -d)
trap 'rm -rf "$tmp"' EXIT
for side in a b; do
  if [ $side = a ]; then tree=$1; else tree=$2; fi
  /usr/local/cuda/bin/nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 \
    -O3 -shared -Xcompiler -fPIC -o "$tmp/$side.so" \
    "$tree/horizonnet_tpu_torch/csrc/$3" || exit 2
  /usr/local/cuda/bin/cuobjdump -sass "$tmp/$side.so" |
    grep -vE "^\s*$|Fatbin|code for|arch =|host =|compile_size|identifier" |
    sed -E 's/Function : .*/Function :/' > "$tmp/$side.sass"
done
n=$(grep -c "/\*[0-9a-f]*\*/" "$tmp/a.sass")
if cmp -s "$tmp/a.sass" "$tmp/b.sass"; then
  echo "$3 SASS: the same $n instructions in both trees"
  exit 0
fi
echo "$3 SASS: differs"
diff "$tmp/a.sass" "$tmp/b.sass" | head -40
exit 1

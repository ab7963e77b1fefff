#!/usr/bin/env bash
# Evaluate a checkpoint of the PyTorch port on the Wild6D test split
# (NOCS-style metrics).
# Usage: selfcorr_tpu_torch/scripts/predict.sh laptop /path/to/Wild6D \
#            log/exp1-laptop/ckpt [extra flags of python -m
#            selfcorr_tpu_torch.predict]
# The model is a port checkpoint (a run's ckpt directory, or one step's) or
# a reference pred_net_*.pth. The entry point runs on CUDA; without a GPU
# pass --device cpu.
set -euo pipefail
cd "$(dirname "$0")/../.."
cat=${1:-laptop}
data=${2:-/data/Wild6D}
model=${3:?model checkpoint path (port ckpt dir or reference .pth)}

if [ ! -d "$data/test_set/$cat" ]; then
    echo "[predict.sh] ERROR: Wild6D test split not found at $data/test_set/$cat" >&2
    echo "[predict.sh] Download Wild6D (images + pkl_annotations) and pass" >&2
    echo "[predict.sh] its root: selfcorr_tpu_torch/scripts/predict.sh $cat /path/to/Wild6D <ckpt>" >&2
    exit 2
fi
ndev=$(python -c "import torch; print(torch.cuda.device_count())")
extra=()
if [ "$ndev" -gt 0 ]; then
    extra+=(--num_devices "$ndev")
fi
list="config/wild6d/lists/${cat}_test.txt"
if [ ! -f "$list" ]; then
    echo "[predict.sh] generating video list $list from $data/test_set/$cat"
    python -m selfcorr_tpu_torch.tools.gen_lists "$data/test_set/$cat" "$list"
fi

python -m selfcorr_tpu_torch.predict --flagfile "config/wild6d/$cat.txt" \
    "${extra[@]}" \
    --test --model_path "$model" \
    --test_dataset_path "$data/test_set/$cat/" \
    --test_list "$list" \
    --checkpoint_dir log --name "eval-$cat" \
    --batch_size 16 --repeat 1 --dframe_eval 1 --use_depth --eval --eval_nocs \
    "${@:4}"

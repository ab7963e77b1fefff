#!/usr/bin/env bash
# Train one Wild6D category with the PyTorch port on every visible GPU.
# Usage: selfcorr_tpu_torch/scripts/train.sh laptop /path/to/Wild6D exp1 \
#            [extra flags of python -m selfcorr_tpu_torch.train]
#
# If the Wild6D download is present at $data, the video list is generated
# from it on first use (selfcorr_tpu_torch.tools.gen_lists). If it is NOT
# present, the run ABORTS unless SYNTH_FALLBACK=1 is set, in which case it
# falls back to the procedural synthetic dataset so the full pipeline still
# runs end to end (loudly): a typo'd dataset path must not burn GPU hours.
# The entry point runs on CUDA; without a GPU pass --device cpu.
set -euo pipefail
cd "$(dirname "$0")/../.."
cat=${1:-laptop}
data=${2:-/data/Wild6D}
name=${3:-exp1-$cat}
ndev=$(python -c "import torch; print(torch.cuda.device_count())")

prior="config/wild6d/priors/$cat.obj"
if [ ! -f "$prior" ]; then
    echo "[train.sh] generating shape priors ($prior missing)"
    python -m selfcorr_tpu_torch.tools.gen_priors
fi

extra=()
if [ "$ndev" -gt 0 ]; then
    extra+=(--num_devices "$ndev")
fi

# pretrained bootstrap (reference convention: a pretrain/ directory next to
# the repo root: an ImageNet resnet18 and pretrain/dino_deitsmall8_pretrain
# .pth). The reference recipe NEEDS these: without them rotation is
# unlearnable.
resnet_ckpt=$(ls pretrain/resnet18*.pth 2>/dev/null | head -1 || true)
dino_ckpt="pretrain/dino_deitsmall8_pretrain.pth"
if [ -n "${resnet_ckpt:-}" ]; then
    echo "[train.sh] using ImageNet resnet18 init: $resnet_ckpt"
    extra+=(--resnet_init_path "$resnet_ckpt")
else
    echo "[train.sh] NOTE: no pretrain/resnet18*.pth found — backbone" >&2
    echo "[train.sh] starts RANDOM (the reference recipe uses ImageNet)." >&2
fi
if [ -f "$dino_ckpt" ]; then
    echo "[train.sh] using DINO ViT-S/8 init: $dino_ckpt"
    extra+=(--dino_init_path "$dino_ckpt")
else
    echo "[train.sh] NOTE: $dino_ckpt not found — the frozen DINO trunk" >&2
    echo "[train.sh] starts RANDOM (cycle_loss_pretrain presumes DINO)." >&2
fi

if [ -d "$data/$cat" ]; then
    list="config/wild6d/lists/${cat}_train.txt"
    if [ ! -f "$list" ]; then
        echo "[train.sh] generating video list $list from $data/$cat"
        python -m selfcorr_tpu_torch.tools.gen_lists "$data/$cat" "$list"
    fi
    extra+=(--dataset_path "$data/$cat/" --train_list "$list")
elif [ "${SYNTH_FALLBACK:-0}" = "1" ]; then
    echo "[train.sh] WARNING: Wild6D not found at $data/$cat —" >&2
    echo "[train.sh] training on the SYNTHETIC procedural dataset instead" >&2
    echo "[train.sh] (SYNTH_FALLBACK=1)." >&2
    extra+=(--dataset_name synthetic)
else
    echo "[train.sh] ERROR: Wild6D not found at $data/$cat." >&2
    echo "[train.sh] Download Wild6D (see README) and pass its path:" >&2
    echo "[train.sh]   selfcorr_tpu_torch/scripts/train.sh $cat /path/to/Wild6D" >&2
    echo "[train.sh] or set SYNTH_FALLBACK=1 to train on the procedural" >&2
    echo "[train.sh] synthetic dataset instead." >&2
    exit 1
fi

python -m selfcorr_tpu_torch.train --flagfile "config/wild6d/$cat.txt" \
    "${extra[@]}" \
    --checkpoint_dir log --name "$name" \
    --save_freq 2000 --vis_freq 2000 "${@:4}"

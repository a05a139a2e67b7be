#!/usr/bin/env bash
# Canonical train + eval invocations of the PyTorch / CUDA port
# (cmpc_refseg_torch), the counterpart of scripts/trainval.sh (reference:
# trainval.sh:7-27).  Data parallelism is one process per card through
# torchrun (-distributed; -bs is the global batch).  Adjust dataset paths
# and the card count for your environment.
set -e

NPROC=${NPROC:-$(nvidia-smi -L | wc -l)}

# RefVOS training, batch size 8, bf16 (the default on CUDA), data-parallel
# over all local cards
torchrun --nproc_per_node "$NPROC" -m cmpc_refseg_torch.cli -m train \
    -d refvos -t train -n CMPC_model -i 700000 -s 100000 -bs 8 \
    -dtype bfloat16 -distributed \
    -im_dir data/train/JPEGImages -mask_dir data/train/Annotations \
    -meta data/train_metadata.json -vocab data/vocabulary_refvos.txt \
    -emb refvos -emb_dir data -ckpt_dir ./checkpoints -log_dir ./logs

# UNC val evaluation with DenseCRF refinement
python -m cmpc_refseg_torch.cli -m test -d unc -t val -n CMPC_model \
    -f ./data -ckpt_dir ./checkpoints -c

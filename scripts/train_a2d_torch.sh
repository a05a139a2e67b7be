#!/usr/bin/env bash
# Canonical A2D-Sentences video train / test of the PyTorch / CUDA port
# (cmpc_refseg_torch), the counterpart of scripts/train_a2d.sh (reference:
# CMPC_video/train_a2d_new.sh: 400k iterations, a snapshot every 20k).
set -e

python -m cmpc_refseg_torch.cli_video -m train -f ./a2d_sent_new \
    -n CMPC_video_mm_tgraph_allvec -i 400000 -s 20000 -bs 1 \
    -emb Gref -emb_dir data -ckpt_dir ./checkpoints_video -log_dir ./logs_video

python -m cmpc_refseg_torch.cli_video -m test -f ./a2d_sent_new \
    -n CMPC_video_mm_tgraph_allvec -ckpt_dir ./checkpoints_video

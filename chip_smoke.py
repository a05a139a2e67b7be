#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (cmpc_refseg_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each fatal on failure:
 1. card: name and power limit (nvidia-smi), torch and CUDA versions;
 2. build: nvcc builds every kernel of the port from its sources (timed;
    ptxas's report per kernel: registers, spills, static shared memory and
    any waits it injected into a wgmma pipeline);
 3. kernels: each kernel's wrapper at the shapes each path of phases 4
    to 9 gives it, against its plain PyTorch version on the same CUDA
    tensors: the flagship bs=8 forward (320x320 -> N=1600 nodes, C=1000,
    K=1008, A=1000, T=20, mlp C=500), the batch-1 request, the bs=64
    forward and the bs=8 train step (the mutan kernel's training form
    with the bf16 residual v, the dz pass of its backward and the dW
    product in place of the inference mutan).  Where the packing rule packs
    the levels (bs=8 and bs=1), the graph kernels run on the packed batch
    (G=3 levels of B samples) and the affinity and update in their grouped
    forms; at bs=64 the graph runs level by level through the ungrouped
    forms.  One record per kernel and path: error against a stated
    tolerance; median times (CUDA events) of the kernel, the plain version
    and cuBLAS's bf16 product alone (for dW, `torch.mm` computes the same
    function: its time is `library_ms`, and the kernel is held against it
    too, at 1e-3); the least time the card could take at those shapes.
    The dz pass's record also splits its time between the dz kernel and
    the slot finalize (torch.profiler), and the dz and raw records give
    their grids.  Then the kernels at small ragged shapes ("edge" records:
    M, K, C and W off their tiles, tiles that straddle samples, C = 1000
    against the per-head edge of W's tensor map; the ConvLSTM gates and SE
    sum at an odd B*N = 75 with 25-row samples, and SE sum with 4 others;
    the grouped affinity and update at 3 samples of 75 rows, C = 72, A =
    40, T = 40 words, G = 3, and graph_msg at T = 40, and at 3 samples of
    N = 1681 rows (a last 32-row group of 17 rows), C = 1000 and an odd
    T = 17; the dz pass at N = 1681, and at 3 samples of 25 rows (blocks'
    rows cross samples) with C = 72 and a sample whose v rows are zero;
    the ConvLSTM raw kernel at B*N = 75 with 25-row samples, C = 12 and
    500; and `cmpc.apply_mutan` at the HSV configs' K = 1011, which it
    pads to 1016, against its plain route).  The wide forms at the widths
    past their main kernels (`wide_edge_inputs`: the affinity at A = 2056,
    the SE sum at C = 1032, graph_msg and graph_update at C = 4104,
    graph_msg at C = 4096 with T = 300, the dz pass at C = 4104 with 5
    heads and C = 1030 with 8), each of which must launch its wrapper's
    wide form, and mutan_fused at C = 4104 and the ConvLSTM pair at CM =
    1032 on their main kernels.  Each path's record carries
    its widths: C = v_emb_dim, K, A = the affinity width, CM = mlp_dim
    (1000 / 1008 / 1000 / 500 for most configs; the HSV configs' K 1016;
    BERT's 1024 / 1032 / 512 / 512; phase 17's 4104 / 4112 / 4104 / 1032)
    and its form (main, or wide on phase 17's paths, where every wrapper
    with a wide form must take it and no registry path may);
 4. forward: build_model("CMPC_model") on CUDA at 320x320, bs=8, bf16,
    full depth.  Launch counts are reset just before the timed forwards and
    read just after (the counts the path needs per forward, see
    `expected_launches`); outputs must be finite and shaped, and sigm must
    agree with the same forward through the plain versions.  Then one
    forward at bs=64, above the packing threshold, where the spatial graph
    runs level by level through the ungrouped kernels, counted likewise;
    and one bs=1 forward with num_steps = 40 (more words than one 32-word
    chunk of the affinity kernel, a 48-word pooled box in the message
    kernel) against the plain route;
 5. serving: build_service("CMPC_model") at 320x320, bf16, full depth,
    answers 20 requests (seeded images of several sizes and aspect ratios,
    3-20-word expressions) at batch 1.  Counts reset before the requests
    and read after; each mask has its image's native shape, and prob
    agrees with the plain route's.  Per-request latency, and the
    level-packed against the per-level spatial graph at batch 1 to
    128 (time and peak memory);
 6. train: build_trainer("CMPC_model") on CUDA at 320x320, bs=8, bf16,
    full depth, frozen backbone.  On one seeded batch from the initial
    weights, the loss and every trainable gradient of the kernel route
    against the plain route (autograd through the plain versions); then
    one warm-up step and 10 timed steps on seeded uint8 batches (3-20
    words, box masks), launch counts reset just before them and read just
    after; losses and gradients finite; ms/step, steps/s, peak memory;
 7. variants: build_model of CMPC_model_origin, CMPCv2_model,
    CMPCv3_model, CMPCv4_model, CMPCv5_model, CMPCv6_model and
    CMPCv4_model with graph_norm="double_softmax" at 320x320, bs=8, bf16,
    full depth (two levels for all but origin: the packed graph at G=2,
    one "other" level in the SE sum; no SE sum for the self-gated v6; the
    per-level graph for the double softmax; the ASPP + v3+ decoder with
    its BN moving statistics for v4-v6; front-padded tokens with
    `valid_idx` for origin and v3).  Each: counts reset before 5 timed
    forwards and read after, sigm against the plain route, the device
    split of a forward (port kernels, convolutions, GEMMs, the rest) and,
    for the decoder configs, of the ASPP + decoder alone.  Then 20
    batch-1 requests to build_service("CMPCv6_model") as in phase 5, and
    CMPCv4_model's bs=8 train step as in phase 6 (its BN batch statistics
    of both routes held against each other too, and the rule must fail
    the faults `mutan_faults` plants).  Phase 3 holds every kernel at each
    of these paths' shapes;
 8. eval and checkpoints: `evaluator.evaluate` (the reference protocol:
    native-resolution masks, overall and mean IoU, prec@X) on the
    flagship at bs=8 over 61 seeded samples of 8 native sizes (the last
    batch padded), counted; per batch the kernel route's `up` and sigm
    against the plain route's, and the on-device (I, U) sums at model
    resolution against the host accumulator's, exactly; both routes'
    results and `evaluate_sharded`'s printed.  Then CMPCv4_model's bs=8
    trainer takes two steps and saves a checkpoint, a trainer from
    another seed restores it bit-equal, both take one more step (losses
    within 1e-4 relative), and services from both answer a request
    (prob within 2e-2); save and restore ms, bytes on disk;
 9. options: the six configs of the text-encoder and lateral options
    (OPTIONS: CMPCv4_BiLSTM_T_model, CMPCv4_BiLSTM_T2_model,
    CMPCv5_HSV_model, CMPCv5_BiLSTM_model, CMPCv5_BiLSTM_HSV_model,
    CMPCv4_BERT_model) through build_model at 320x320, bs=8, bf16, full
    depth, as phase 7 drives its configs (BERT with seeded N(0, 1)
    features [8, 20, 768] and 3-20-word masks); 20 batch-1 requests to
    build_service("CMPCv5_BiLSTM_HSV_model") as in phase 5; and the bs=8
    train steps of CMPCv5_BiLSTM_HSV_model, both trainers built from a
    seeded synthetic [12112, 300] GloVe table that must arrive on the card
    bit for bit, and of CMPCv4_BERT_model, each as phase 6 holds its
    step (losses, gradients, BN statistics of both routes);
10. plus: CMPCv6_plus_model (the sentence fusion: a second mutan per level;
    two graph convolutions per level on the l2-normalized affinity) and
    CMPCv5_plus_model (the detection head) at 320x320, bs=8, bf16, full
    depth: each one's bs=8 forward as phase 7 drives its configs (v5+'s
    boxes finite and shaped, their confidence against the plain route's),
    20 batch-1 requests as in phase 5, and its bs=8 train step as phase 6
    holds it (v5+ with `preprocess_true_boxes` labels of the batch's seeded
    box masks, and the rule must fail faults planted in the mutan kernels'
    wrappers on v5+'s step, `mutan_faults`); CMPCv4_model with conv5=True,
    its res3-5 conv kernels training: the bs=8 step as phase 6 holds it
    (the res3-5 leaves among the gradients), its peak memory and step time,
    and proof that the forward after the steps reads the trained kernels
    (moved, the very tensors the state trains, and a forward from them
    differs from one from the initial kernels); CMPC_model with
    grad_accum=2: two bs=4 micro-steps (no update after the first, one
    after the second, counted) whose mean gradient is held against the bs=8
    step's gradients by phase 6's rule.  Phase 3 holds each of these paths'
    kernels at their shapes (the l2-normalized affinity at C = A = 1000,
    two update rounds and two mutans per level counted in the launches),
    and the edge records add the padding functions of `models/cmpc.py` at
    odd widths (C 1001, A 1003, CM 502: mutan and its training kernels, the
    affinity, the graph convolution, the SE sum and the ConvLSTM step, each
    against the unpadded plain function);
11. command lines: the flagship (320x320, bs=8, bf16, full depth) through the
    port's command line, `cli.main` called in this process, on a fake
    `unc` npz dataset written with numpy (64 train samples at 320x320, the
    61 eval samples of phase 8's native sizes, a 12112-word vocabulary
    and a seeded [12112, 300] GloVe table): `-m train` 20 steps with a
    snapshot every 10, then `-resume` to 30 (it starts at 20 and ends with
    a snapshot at 30; its first loss within 1e-2 of a Trainer.step from
    the restored step 20 on the same batch); `-m test` from step 30 (the
    printed IoUs within 1e-5 of `evaluate` on the same samples and
    weights); the readers alone (NpzReader; where PIL imports,
    RefVOSReader on 32 seeded 720x1280 JPEG frames and palette PNG masks
    with 1 thread and 8 spawned processes, the fast decode where cv2
    imports, then a 10-step `-d refvos -workers 8` CLI run); where PIL
    imports, `serving.server.main` on step 30 in a thread answering one
    POST /predict as a PredictService on the same state does; and
    `export_program` at bs=1 loaded back (its masks within 2e-2 of the
    plain route's, no kernel launched).  Step ms (steps 2-20, the loop's
    read included) against phase 6's, samples/s against phase 8's, the
    readers' samples/s and the host libraries are printed.  The CLI's
    runs launch at the shapes of phase 3's train_bs8, eval_bs8 and
    serving_bs1 paths and are held there (CLI_PATHS);
12. video and post-processing: CMPC_video_mm_tgraph_allvec (16-frame
    clips, 5 sampled; C 1000, K 1008, A 1000, CM 500, T 20) through
    build_model at 1 and 8 clips as phase 7 drives its configs (ms,
    clips/s, the device split, launches, sigm against the plain route),
    its bs=8 train step as phase 6 holds it (the planted mutan faults
    must fail: its mutan runs at 8 x 5 x 1600 rows); the A2D command line
    on a seeded fake npz set (64 train and 16 test clips at 320x320, 3 of
    the test masks empty): `cli_video -m train -bs 8` 10 steps, then `-m
    test`, whose printout must equal `evaluate_a2d` on the same weights
    and samples within 1e-5 (n counting the non-empty samples); RefVOS
    inference (`infer_video.run_inference`, the flagship, frame_batch 8)
    over phase 11's kind of 32-frame 720x1280 tree with 2 expressions:
    frames/s, the PNGs equal to masks made from Model.forward's sigm, and
    with the native DenseCRF (required: it loads, and no frame falls back
    to `mean_field_gaussian`) its ms per frame; on the card,
    `mean_field_gaussian` against its CPU run (1e-5) and `nms_torch`
    keeping `nms_numpy`'s boxes.  Phase 3 holds the video paths
    (`video_bs1`, `video_bs8`, `video_train_bs8`: the mutan family at the
    clips' rows, everything else at the clips' batch) and the command
    lines' launches through CLI_PATHS (the inference at forward_bs8);
13. int8 backbone, VGG16-FCN, data parallelism: phase 5's 20 requests
    through `PredictService(quantize=True)`, dynamic and calibrated on 4
    seeded images (latency beside phase 5's, the backbone's bytes on the
    card, masks agreeing with the bf16 service's on > 95% of the pixels),
    on one request all 104 units' int32 accumulations (`torch._int_mm`)
    bit-equal to the float64 conv, c5 against the f32 backbone within the
    JAX package's bounds, a bs=8 int8 forward; VGG16-FCN at bs=1 and 8 in
    bf16 (fc8 against float32 by a stated bound); two ranks on the one
    card over gloo (spawned): the flagship's and CMPCv4_model's DP
    gradients at global bs=8 held against the plain route by phase 6's
    rule, 3 DP steps against single-process steps, the ranks bit-equal
    after each, `evaluate_sharded` over the ranks, `cli.main -m train
    -distributed` through torchrun's environment, and a one-rank NCCL
    step bit-equal to the step without a group.  Phase 3 holds the ranks'
    launches at their shapes (`v4_dp_train_bs4`, `dp_eval_bs4`; the
    flagship's rank step shares `accum_train_bs4`'s);
14. tensor parallelism and ZeRO: four ranks on the one card over gloo
    (spawned, `tp_rank`) laid out as data = 2 x model = 2
    (`build_trainer(mesh=make_mesh((2, 2)))`), the flagship at full width
    and bf16, global bs=8, under the production rule (51 leaves stored
    split over the model axis, Adam ZeRO-sharded over the 4 ranks): 3
    steps, each step's reduced gradient held against the single
    process's plain route by phase 6's rule (the ranks read the draws),
    its loss within DP_LOSS_TOL of the single process's from the same
    weights, the single process's Adam fed that gradient bit-equal to the
    ranks' consolidated weights and moments, the 2 ranks of each model
    index holding bit-equal shards; each rank's Adam, master and engaged
    bytes against what the layout implies; the rank step's ms; a
    consolidated checkpoint restored in one process, every leaf
    bit-equal.  The ranks' launches are held at `accum_train_bs4`'s
    shapes;
15. the VOC backbone pretraining pipeline, the convergence proof and the
    visualisation tool (`run_voc_phase`): ResNet-101 with the 21-class
    VOC head through `tools.pretrain_backbone.run_train` (the `--mode
    train` main) on fabricated VOC-style JPEG / palette PNG pairs of
    VOC's sizes, 321x321 crops, bs=10: SGD over every conv in bf16 and
    f32 (one warm-up, 5 timed steps), `--train-msc` and head-only Adam in
    bf16 (3); ms/step, images/s and peak GB of each; the bf16 loss and
    every gradient against f32's from the same weights and batch (medians
    over the weights and NOISE_DRAWS draws, against f32's own response
    to draws of the weights at bf16's rounding), and a second
    SGD step replayed bit for bit; `--mode eval` single-scale and `--msc`
    over 8 images (ms per image; the card's confusion matrix against
    the host's) and `--mode infer`; res4_blocks 2 at crop 65, f32,
    against the port on the CPU (losses, the step-2 snapshot by the
    step rule, `eval_forward`'s logits); the convergence proof for 20
    steps (finite hold-out IoU, launches as 20 train_bs8 steps and 2
    forwards); `tools.visualize` over 4 samples of phase 11's set from
    its snapshot (every file, the sigm PNGs equal to `colorize` of
    Model.forward's sigm);
16. the reference-checkpoint path without JAX (`run_reference_phase`):
    seeded reference-named tensors (`tools.convert_tf_checkpoint.
    reference_tensors`) of the flagship and CMPCv4_model at full width
    through `convert_tensors` onto the card (wall s, bytes), each
    converted model's bs=8 forward through `api.Model` against the plain
    route (v4's converted BN statistics are the file's and the ones the
    forward reads); `tools.parity_rehearsal.run(from_tensors=True,
    full_width=True)` over its 8 COCO-size images (the save's ms
    and bytes, `cli -m test -c` samples/s, then without -c), the
    checkpoint's weights bit-equal to the conversion, the printed table
    (without and with the CRF) within IOU_TOL of `evaluate(use_crf=True)`
    on those weights and batches; launches held at forward_bs8, v4_bs8
    and eval_bs8;
17. the flagship widened past every main kernel's bound
    (`run_wide_phase`: v_emb_dim 4104, so C = A = 4104, and mlp_dim 1032)
    at 320x320, bs=2, bf16, full depth: one forward, whose affinity,
    message, update and SE sum launches all go to their wide forms
    (counted), sigm against the plain route by phase 4's rule, its ms,
    peak GB and device time by kernel; the train step held by phase 6's
    rule (`check_train_routes`) and one timed step, the dz pass wide too;
18. the kernels' share of each path's run, the `kernels` JSON line (each
    record's launches are its path's count), the nvidia-smi line and the
    final JSON line.  The edge records go to their own log line, not into
    the `kernels` line: they are on no path.

Exits non-zero, printing no result, without CUDA or without the package.
"""

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12        # H100 SXM f32 peak outside the tensor cores
HBM_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth

DEV = "cuda"
B, H_IMG, N, C, K, A, T, HEADS = 8, 320, 1600, 1000, 1008, 1000, 20, 5
RES4 = 23                    # full depth: ResNet-101
CM, G = 500, 3               # mlp width (fusion stack); levels packed at bs=1
B_LARGE = 64                 # above the packing threshold: per-level graph
# phase 7: (path tag, config name, overrides)
VARIANTS = (("origin", "CMPC_model_origin", {}), ("v2", "CMPCv2_model", {}),
            ("v3", "CMPCv3_model", {}), ("v4", "CMPCv4_model", {}),
            ("v5", "CMPCv5_model", {}), ("v6", "CMPCv6_model", {}),
            ("v4ds", "CMPCv4_model", {"graph_norm": "double_softmax"}))
# phase 9, the text-encoder and lateral options: (path tag, config name,
# overrides)
OPTIONS = (("bilstm_t", "CMPCv4_BiLSTM_T_model", {}),
           ("bilstm_t2", "CMPCv4_BiLSTM_T2_model", {}),
           ("hsv", "CMPCv5_HSV_model", {}),
           ("v5_bilstm", "CMPCv5_BiLSTM_model", {}),
           ("v5_bilstm_hsv", "CMPCv5_BiLSTM_HSV_model", {}),
           ("bert", "CMPCv4_BERT_model", {}))
GLOVE_SEED = 11              # the synthetic GloVe table of phase 9
# phase 10: (path tag, config name, overrides)
PLUS = (("v6plus", "CMPCv6_plus_model", {}), ("v5plus", "CMPCv5_plus_model",
                                              {}))
ODD_C, ODD_A, ODD_CM = 1001, 1003, 502   # phase 10's odd widths
# phase 17: the flagship widened past every main kernel's bound (A = C =
# 4104 > 2048 and 4096, CM = 1032 > 1024), so each wrapper with a wide form
# launches it on its real call path
WIDE_CFG = {"v_emb_dim": 4104, "mlp_dim": 1032}
WIDE_B = 2
WIDE_FORMS = ("spa_affinity_grouped", "graph_msg", "graph_update_grouped",
              "se_sum")               # and mutan_bwd_dz in a train step
WIDE_KERNELS = ("aff_wide_proj_kernel", "aff_wide_norm_kernel",
                "aff_wide_words_kernel", "aff_wide_softmax_kernel",
                "se_wide_kernel", "se_wide_norm_kernel",
                "graph_msg_wide_kernel", "graph_update_wide_kernel",
                "dz_wide_rows_kernel", "dz_wide_cols_kernel",
                "dz_wide_finish_kernel")
PORT_KERNELS = ("convlstm_gates_kernel", "convlstm_raw_kernel",
                "graph_msg_kernel", "graph_update_kernel",
                "mutan_heads_kernel", "mutan_norm_kernel", "mutan_dz_kernel",
                "mutan_dz_finalize_kernel", "mutan_dw_kernel",
                "mutan_dw_sum_kernel", "se_sum_kernel", "spa_affinity_kernel",
                *WIDE_KERNELS)
N_FWD = 5
SIGM_TOL = 2e-2
# kernel outputs against the plain version, as a share of the largest entry
# (check_kernels); dW's f32 result sums exact bf16 products, so only the
# order of its f32 sums differs from the plain version and torch.mm
KERNEL_TOL = {"mutan_dw": 1e-3}
EDGE_ROWS, EDGE_N, EDGE_K = 300, 100, 136
EDGE_C, EDGE_A, EDGE_T = 72, 40, 40   # the graph kernels' edge shapes
EDGE_DZ_N = 1681             # 41 x 41 rows per sample: no 32-row blocks
EDGE_MSG_T = 17              # odd: w_aff rows 2-byte aligned, K padded
LONG_T = 40                  # num_steps of the long-expression forward
N_REQ = 20
N_TRAIN = 10
TRAIN_LOSS_TOL = 1e-2        # kernel vs plain route, relative
TRAIN_GRAD_TOL = 5e-2        # per leaf, ||g_k - g_p|| / ||g_p||
# the plain bf16 route's own noise in a gradient leaf moves under a 1e-5
# relative change of the weights (2.2-8.3% of the leaf's norm for some
# leaves of the v5 configs, 1-3.4x for an HSV bias; PERF.md, section 6):
# check_train_routes reads it at the weights and at NOISE_DRAWS such draws
NOISE_DRAWS, NOISE_EPS = 6, 1e-5
PACK_BATCHES = (1, 2, 4, 8, 16, 32, 64, 128)
# phase 8: 61 samples, so the last bs=8 batch of the evaluation is padded;
# native sizes (h, w) between 240x320 and 640x480
N_EVAL = 61
EVAL_SIZES = ((240, 320), (333, 500), (375, 500), (427, 640), (480, 640),
              (500, 375), (512, 512), (640, 480))
CKPT_LOSS_TOL = 1e-4         # next-step loss, restored vs original, relative
# phase 11, the command lines: the fake npz dataset's 320x320 train samples (its
# eval samples are phase 8's N_EVAL at EVAL_SIZES) and the fake RefVOS
# tree's 720x1280 frames; the CLI's runs are held at the shapes of the
# phase-3 paths they share
N_CLI_TRAIN = 64
N_REFVOS, REFVOS_HW = 32, (720, 1280)
CLI_PATHS = {"cli_train_bs8": "train_bs8",
             "cli_refvos_train_bs8": "train_bs8",
             "cli_eval_bs8": "eval_bs8", "cli_serving_bs1": "serving_bs1",
             "cli_video_train_bs8": "video_train_bs8",
             "cli_video_test_bs1": "video_bs1",
             "infer_video_bs8": "forward_bs8",
             # phase 13: the int8 backbone leaves the head's shapes alone,
             # and a rank's flagship step is the accumulation's bs=4 one
             "int8_dynamic_serving_bs1": "serving_bs1",
             "int8_calibrated_serving_bs1": "serving_bs1",
             "int8_forward_bs8": "forward_bs8",
             f"dp_train_bs{B // 2}": f"accum_train_bs{B // 2}",
             f"cli_dp_train_bs{B // 2}": f"accum_train_bs{B // 2}",
             # phase 14: a rank's step runs the flagship on its data
             # slot's 4 rows, on full weights gathered from the shards
             f"tp_train_bs{B // 2}": f"accum_train_bs{B // 2}",
             # phase 16: converted weights leave the shapes alone
             "converted_flagship_bs8": "forward_bs8",
             "converted_v4_bs8": "v4_bs8",
             "rehearsal_eval_bs8": "eval_bs8",
             "rehearsal_eval_nocrf_bs8": "eval_bs8"}
IOU_TOL = 1e-5               # the CLI's printout vs `evaluate`'s results
# phase 12, the video model and post-processing: its config; the fake A2D
# npz set (16-frame 320x320 clips; the test samples at A2D_EMPTY have empty
# masks, which the evaluation skips); the CLI's train steps; the RefVOS
# inference's expressions (over phase 11's tree) and the CRF's frames
VIDEO = "CMPC_video_mm_tgraph_allvec"
N_A2D_TRAIN, N_A2D_TEST, A2D_EMPTY = 64, 16, (3, 9, 14)
N_VIDEO_STEPS = 10
N_EXPR = 2
N_CRF = 4                    # frames refined by the native DenseCRF (~1.2 s
                             # a frame at 320x320 on the card's host)
N_NMS = 300                  # boxes of the on-device NMS check
MF_TOL = 1e-5                # mean field on the card vs the CPU
HOST_LIBS = ("PIL", "cv2", "h5py", "scipy", "tensorboardX")
# phase 13: the int8 backbone, VGG16-FCN and data parallelism on one card
INT8_UNITS = 104             # ResNet-101's conv units: conv1, 4 shortcuts,
                             # 33 blocks x 3
N_CAL = 4                    # calibration images of the calibrated service
# the JAX package's own bounds on the int8 backbone
# (tests/test_model.py:154-199): c5 against the f32 backbone, and the
# masks against the unquantized model at 0.5
INT8_C5_REL, INT8_C5_COS, INT8_AGREE = 0.08, 0.995, 0.95
# VGG16-FCN in bf16 against float32: each of its 16 convs rounds its input
# and its weights to bf16 (2^-9 relative each) and sums in f32, so the
# relative error of fc8's norm grows at most ~linearly with depth
VGG_CONVS = 16
VGG_TOL = VGG_CONVS * 2 * 2.0 ** -9
N_DP, DP_STEPS = 2, 3        # ranks sharing the card over gloo; DP steps
DP_CONFIGS = (("dp", "CMPC_model"), ("v4_dp", "CMPCv4_model"))
N_DP_CLI = 3                 # steps of the 2-rank command line
# a DP loss against the single process's from the same weights on the same
# global batch, relative: the readings were 2.3e-5 (flagship) and 3.7e-4
# (CMPCv4_model, whose ill-conditioned image-level BN moves most) on the
# H100 (PERF.md), so a wrong step sits well above it
DP_LOSS_TOL = 2e-3
DP_TIMEOUT = 900             # s for all of the ranks' work: a hang fails
# phase 14: tensor parallelism and ZeRO, four ranks sharing the card over
# gloo as data = 2 x model = 2 under the production rule (min_dim 512)
TP_SHAPE, TP_STEPS = (2, 2), 3
N_TP = TP_SHAPE[0] * TP_SHAPE[1]
TP_ENGAGED = 51
# what each rank should hold of the flagship's 76,055,608 trainable f32
# entries, 49,962,000 of them in the 51 leaves the rule engages: one
# process's Adam moments / 4, the master segment, the engaged leaves / 2
TP_WANT_MB = {"adam_moments": 2 * 76_055_608 * 4 / N_TP / 1e6,
              "master_segment": 76_055_608 * 4 / N_TP / 1e6,
              "engaged_storage": 49_962_000 * 4 / TP_SHAPE[1] / 1e6}
# phase 15: the VOC backbone pretraining pipeline at full width
# (ResNet-101, 21 classes, 321x321 crops, bs=10) on fabricated VOC-style
# JPEG / palette PNG pairs of VOC's typical sizes (h, w), the convergence
# proof (short) and the visualisation tool
VOC_CLASSES, VOC_BS, VOC_CROP = 21, 10, 321
VOC_SIZES = ((375, 500), (500, 375), (333, 500), (500, 333), (366, 500),
             (500, 400), (281, 500), (375, 500))
N_VOC_TRAIN = 20
N_VOC_STEPS = 5              # timed SGD steps after one warm-up
N_VOC_SHORT = 3              # timed --train-msc / head-only Adam steps
# the recipe's lr (2.5e-4, x10 / x20 for the head) is set for an ImageNet
# backbone; from random weights SGD diverges in 3 steps (to NaN: the
# seeded weights' three-scale loss, the calibrated weights' bf16 SGD, on
# the card, PERF.md section 6), so the phase trains at 1/100 of it
VOC_LR = 2.5e-6
VOC_LOSS_TOL = 1e-2          # the bf16 step's loss vs f32's, relative
# bf16 vs f32 gradients: bf16 rounds each conv's input and weight to 2^-9
# relative, and through ResNet-101's 100 ReLUs such a change moves the deep
# leaves' gradients far more than the rounding itself (a pre-activation
# within it of 0 takes the other branch).  The f32 gradient's own response
# to draws of the weights times (1 + 2^-9 N(0, 1)) measures that: per leaf,
# the median of ||g_bf16 - g_32|| over the weights and NOISE_DRAWS draws
# must be within VOC_NOISE_FACTOR x the median of ||g_32(draw) -
# g_32(weights)|| (PERF.md section 2)
VOC_DRAW_EPS, VOC_NOISE_FACTOR = 2.0 ** -9, 3.0
VOC_CPU_TOL = 1e-4           # card vs CPU at the reduced geometry, f32
VOC_SMALL_RES4, VOC_SMALL_CROP, VOC_SMALL_BS = 2, 65, 2
# the step rule of tests/test_torch_pretrain.py on one run: a leaf's error
# over its largest update; head leaves 1e-4, backbone leaves 5e-2 (a ReLU
# input within rounding of 0 takes the other branch on one device)
VOC_HEAD_TOL, VOC_RELU_FLIP_TOL = 1e-4, 5e-2
CONV_ARGS = ("--steps", "20", "--pool", "32", "--holdout", "16",
             "--eval-every", "20")
N_VIS = 4
# phase 16: the reference-checkpoint path: fabricated reference-named
# tensors (`reference_tensors`, seeded) converted at full width, and the
# parity rehearsal with --from-tensors (the card has no TensorFlow) over
# its 8 fabricated images of COCO's sizes, one bs=8 batch
REFERENCE = (("flagship", "CMPC_model"), ("v4", "CMPCv4_model"))
REPLACES = {
    "mutan_fused": "cmpc_refseg_tpu/ops/pallas_kernels.py:98",
    "mutan_fwd_residual": "cmpc_refseg_tpu/ops/pallas_kernels.py:332",
    "mutan_bwd_dz": "cmpc_refseg_tpu/ops/pallas_kernels.py:457",
    "mutan_dw": "cmpc_refseg_tpu/ops/pallas_kernels.py:400",
    "spa_affinity": "cmpc_refseg_tpu/ops/pallas_kernels.py:1025",
    "spa_affinity_grouped": "cmpc_refseg_tpu/ops/pallas_kernels.py:1025",
    "graph_msg": "cmpc_refseg_tpu/ops/pallas_kernels.py:842",
    "graph_update": "cmpc_refseg_tpu/ops/pallas_kernels.py:884",
    "graph_update_grouped": "cmpc_refseg_tpu/ops/pallas_kernels.py:884",
    "se_sum": "cmpc_refseg_tpu/ops/pallas_kernels.py:1155",
    "convlstm_gates": "cmpc_refseg_tpu/ops/pallas_kernels.py:643",
    "convlstm_raw": "cmpc_refseg_tpu/ops/pallas_kernels.py:703",
}
SOURCES = {
    "mutan_fused": "cmpc_refseg_torch/csrc/mutan.cu",
    "mutan_fwd_residual": "cmpc_refseg_torch/csrc/mutan.cu",
    "mutan_bwd_dz": "cmpc_refseg_torch/csrc/mutan_bwd.cu",
    "mutan_dw": "cmpc_refseg_torch/csrc/mutan_bwd.cu",
    "spa_affinity": "cmpc_refseg_torch/csrc/spa_affinity.cu",
    "spa_affinity_grouped": "cmpc_refseg_torch/csrc/spa_affinity.cu",
    "graph_msg": "cmpc_refseg_torch/csrc/graph_conv.cu",
    "graph_update": "cmpc_refseg_torch/csrc/graph_conv.cu",
    "graph_update_grouped": "cmpc_refseg_torch/csrc/graph_conv.cu",
    "se_sum": "cmpc_refseg_torch/csrc/se_sum.cu",
    "convlstm_gates": "cmpc_refseg_torch/csrc/convlstm.cu",
    "convlstm_raw": "cmpc_refseg_torch/csrc/convlstm.cu",
}
# which output of a wrapper holds statistics partials [B, P, (Q,) 2]
STATS_OUTPUT = {"graph_msg": 1, "graph_update": 1, "graph_update_grouped": 1,
                "convlstm_gates": 1, "convlstm_raw": 2}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def wall_ms(torch, fn, groups=5, reps=5):
    """Median over `groups` of the host-clock time of `reps` calls ending in
    a synchronize, per call: what a caller waits, host dispatch included."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / reps)
    return statistics.median(times)


def gpu_ms(torch, fn, groups=5, reps=10):
    """Median over `groups` of the mean CUDA-event time of `reps` back-to-back
    calls.  A spin kernel queued first lets the host enqueue every call
    before the timed ones start, so host overhead between calls is hidden."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_split_ms(torch, fn, reps=20, launches=False):
    """Mean device ms per call of each kernel `fn` launches, by name, from
    torch.profiler's CUDA activity; {} where it records no device time.
    With `launches`, also the device kernels a call launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out, count = {}, 0
    for e in prof.key_averages():
        total = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        if total:
            name = e.key.split("(")[0].replace("void ", "").replace(
                "cmpc::", "")
            out[name] = total / reps / 1e3
            count += e.count
    return (out, count / reps) if launches else out


def bound(flops_mm, ops_f32, nbytes):
    """Least time: the larger of the bf16 products at the tensor-core peak,
    the f32 elementwise work at the f32 peak (the two units overlap) and
    the bytes at the memory rate."""
    t_ops = max(flops_mm / BF16_FLOPS, ops_f32 / F32_FLOPS)
    t_bytes = nbytes / HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def compare(torch, got, want, tol, what):
    """max |got - want| and the same over max |want|; fails past tol."""
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    norm = err / max(ref, 1e-30)
    if not math.isfinite(norm) or norm > tol:
        fail(f"{what}: max abs err {err:.3e} = {norm:.3e} of max |ref| "
             f"{ref:.3e}, tolerance {tol:.0e}")
    return err, norm


def compare_stats(torch, got, want, count, tol, what):
    """Whole-sample statistics given as (sum, sum of squares) partials
    [B, P, 2], or [B, P, Q, 2] for Q statistics, over `count` entries per
    sample: per sample, the mean's error over the reference's standard
    deviation and the variance's relative error, each within tol (the two
    columns are held apart, each at its own scale).  Returns (max abs err
    of the summed columns, the larger of the two normalised errors)."""
    if got.dim() == 4:
        res = [compare_stats(torch, got[:, :, q], want[:, :, q], count, tol,
                             f"{what} [{q}]") for q in range(got.shape[2])]
        return max(r[0] for r in res), max(r[1] for r in res)

    def moments(s):
        s = s.double().sum(dim=1)
        mean = s[:, 0] / count
        return s, mean, s[:, 1] / count - mean * mean
    gs, gm, gv = moments(got)
    ws, wm, wv = moments(want)
    err_mean = ((gm - wm).abs() / wv.clamp(min=1e-30).sqrt()).max().item()
    err_var = ((gv - wv).abs() / wv.clamp(min=1e-30)).max().item()
    norm = max(err_mean, err_var)
    if not math.isfinite(norm) or norm > tol:
        fail(f"{what}: mean error {err_mean:.3e} of the std, variance error "
             f"{err_var:.3e} of the variance, tolerance {tol:.0e}")
    return (gs - ws).abs().max().item(), norm


def path_spec(cfg, batch, train=False):
    """What phase 3 needs to know of a path: its batch, whether it trains,
    the frames per sample of its mutan (the video model's sampled frames:
    each clip is one mutan sample of frames * N rows; 1 for the image
    configs), its config's levels, graph norm and exchange layout, and its
    widths:
    c = v_emb_dim, k = the mutan's K (v_emb_dim + spatial_dim, padded to a
    multiple of 8 as `cmpc.apply_mutan` pads it), a = the affinity width
    (vw_emb_dim, else v_emb_dim) and cm = mlp_dim (the fusion stack); and
    the head's options: the l2-normalized affinity, the graph rounds per
    level and the sentence fusion's second mutan."""
    return {"batch": batch, "train": train,
            "frames": len(cfg.sampled_frames) if cfg.video else 1,
            "levels": len(cfg.levels),
            "graph_norm": cfg.graph_norm, "self_gate": cfg.exchange_self_gate,
            "l2n": bool(cfg.l2norm_affinity), "rounds": cfg.num_graph_conv,
            "sent_fusion": cfg.sent_fusion,
            "c": cfg.v_emb_dim, "k": -(-(cfg.v_emb_dim + cfg.spatial_dim)
                                        // 8) * 8,
            "a": cfg.vw_emb_dim or cfg.v_emb_dim, "cm": cfg.mlp_dim}


def path_specs(get_config):
    """The paths phases 4 to 8 drive: the flagship's bs=8 forward, batch-1
    request, bs=64 forward (above the packing threshold: the per-level
    spatial graph) and bs=8 train step; each variant's bs=8 forward, the
    CMPCv6_model batch-1 request and the CMPCv4_model bs=8 train step;
    the flagship's bs=8 evaluation, and the CMPCv4_model train steps
    around a checkpoint and the requests to services from it; each
    OPTIONS config's bs=8 forward, the CMPCv5_BiLSTM_HSV_model batch-1
    request and its bs=8 train step, and CMPCv4_BERT_model's bs=8 train
    step; each PLUS config's bs=8 forward, batch-1 request and bs=8 train
    step, CMPCv4_model's bs=8 conv5 step and CMPC_model's grad_accum=2
    bs=4 micro-steps; the video model's forwards of 1 and 8 clips and its
    bs=8 train step; a data-parallel rank's CMPCv4_model step and
    flagship evaluation at half of bs=8; phase 17's widened flagship
    (WIDE_CFG) forward and train step at WIDE_B, whose specs say `wide`:
    there every wrapper with a wide form must launch it, elsewhere none
    may."""
    flag = get_config("CMPC_model")
    specs = {"forward_bs8": path_spec(flag, B),
             "serving_bs1": path_spec(flag, 1),
             f"forward_bs{B_LARGE}": path_spec(flag, B_LARGE),
             "train_bs8": path_spec(flag, B, train=True)}
    for tag, name, overrides in VARIANTS:
        specs[f"{tag}_bs8"] = path_spec(get_config(name, **overrides), B)
    specs["v6_serving_bs1"] = path_spec(get_config("CMPCv6_model"), 1)
    v4 = get_config("CMPCv4_model")
    specs["v4_train_bs8"] = path_spec(v4, B, train=True)
    specs["eval_bs8"] = path_spec(flag, B)
    specs["ckpt_v4_train_bs8"] = path_spec(v4, B, train=True)
    specs["ckpt_v4_serving_bs1"] = path_spec(v4, 1)
    for tag, name, overrides in OPTIONS:
        specs[f"{tag}_bs8"] = path_spec(get_config(name, **overrides), B)
    hsv = get_config("CMPCv5_BiLSTM_HSV_model")
    specs["v5_bilstm_hsv_serving_bs1"] = path_spec(hsv, 1)
    specs["v5_bilstm_hsv_train_bs8"] = path_spec(hsv, B, train=True)
    specs["bert_train_bs8"] = path_spec(get_config("CMPCv4_BERT_model"), B,
                                        train=True)
    for tag, name, overrides in PLUS:
        cfg = get_config(name, **overrides)
        specs[f"{tag}_bs8"] = path_spec(cfg, B)
        specs[f"{tag}_serving_bs1"] = path_spec(cfg, 1)
        specs[f"{tag}_train_bs8"] = path_spec(cfg, B, train=True)
    specs["v4conv5_train_bs8"] = path_spec(v4, B, train=True)
    specs[f"accum_train_bs{B // 2}"] = path_spec(flag, B // 2, train=True)
    video = get_config(VIDEO)
    specs["video_bs1"] = path_spec(video, 1)
    specs[f"video_bs{B}"] = path_spec(video, B)
    specs[f"video_train_bs{B}"] = path_spec(video, B, train=True)
    # phase 13's ranks: CMPCv4_model's step and the flagship's evaluation
    # on each rank's half of a bs=8 batch (the flagship's step: CLI_PATHS)
    specs[f"v4_dp_train_bs{B // 2}"] = path_spec(v4, B // 2, train=True)
    specs[f"dp_eval_bs{B // 2}"] = path_spec(flag, B // 2)
    wide = get_config("CMPC_model", **WIDE_CFG)
    specs[f"wide_bs{WIDE_B}"] = {**path_spec(wide, WIDE_B), "wide": True}
    specs[f"wide_train_bs{WIDE_B}"] = {
        **path_spec(wide, WIDE_B, train=True), "wide": True}
    return specs


def kernel_inputs(torch, kernels, cmpc, dev, spec):
    """The inputs of each kernel the path `spec` launches, at the shapes it
    gives them, made from a seed and scaled so the logits and products are
    O(1) as in the model; graph_update takes graph_msg's (msg, stats) and
    convlstm_raw takes convlstm_gates' (gates, stats), as the path does.
    Where the rule packs the levels, the graph kernels see the packed batch
    G*batch (G = the config's levels) and the affinity and update take G
    weight groups.  The affinity's `masked` form follows the graph norm;
    under the double softmax no affinity kernel runs and graph_msg takes
    that affinity (a softmax over the nodes times a relation probability
    per word).  The SE sum takes G - 1 others; the self-gated exchange
    launches none.  With `train`, the mutan kernel's training form takes
    the inference form's place, and the dz pass takes the residual v it
    makes and a cotangent, the dW product x and the dz pass's dz.  The
    mutan family takes `frames` * N rows per sample (the video model's
    clips), everything else N.
    Returns {wrapper name: (args, kwargs, kernel batch, groups)}."""
    batch, train, levels = spec["batch"], spec["train"], spec["levels"]
    rows = spec["frames"] * N                 # the mutan's rows per sample
    norm = spec["graph_norm"]
    c, k, a, cm = spec["c"], spec["k"], spec["a"], spec["cm"]
    g = torch.Generator(device=dev).manual_seed(batch)
    f32 = torch.float32

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    def uniform(*shape, limit, dtype=torch.bfloat16):
        u = torch.rand(*shape, generator=g, device=dev) * 2 - 1
        return (u * limit).to(dtype)

    def word_mask(b):
        lens = torch.randint(3, T + 1, (b,), generator=g, device=dev)
        return (torch.arange(T, device=dev)[None] < lens[:, None]).float()[
            :, None].contiguous()

    def msg_args(b):
        logits = randn(b, N, T, dtype=f32)
        if norm == "double_softmax":
            w_aff = torch.softmax(logits, 1) * torch.rand(
                b, 1, T, generator=g, device=dev)
        else:
            w_aff = torch.softmax(logits, -1)
        return w_aff.to(torch.bfloat16), randn(b, T, c)

    packed = cmpc.pack_levels(batch, levels, norm)
    bg, lead, groups = ((levels * batch, (levels,), levels) if packed
                        else (batch, (), 1))
    sfx = "_grouped" if packed else ""
    affinity = ((randn(bg, N, c), randn(*lead, c, a, scale=0.05),
                 randn(*lead, a, scale=0.1), randn(bg, T, a),
                 torch.rand(bg, 1, T, generator=g, device=dev),
                 word_mask(bg)),
                {"scale": math.sqrt(c), "l2n": spec["l2n"],
                 "masked": norm in ("masked", "unmasked")})
    msg, stats1 = kernels.graph_msg_plain(*msg_args(bg))
    update = (randn(bg, N, c), msg, stats1,
              uniform(*lead, c, c, limit=math.sqrt(3 / c)),
              randn(*lead, c, scale=0.1),
              1 + randn(*lead, c, scale=0.1, dtype=f32),
              randn(*lead, c, scale=0.1, dtype=f32))
    x, h, cell = (randn(batch, N, cm) for _ in range(3))
    gates_args = (x, h, cell, uniform(2 * cm, 4 * cm,
                                      limit=math.sqrt(6 / (6 * cm))),
                  uniform(N, cm, limit=0.1), uniform(N, cm, limit=0.1))
    gates, gstats = kernels.convlstm_gates_plain(*gates_args)
    mutan_args = (randn(batch * rows, k),
                  uniform(k, HEADS * c, limit=math.sqrt(6 / (k + HEADS * c))),
                  randn(HEADS * c, scale=0.1, dtype=f32),
                  torch.tanh(randn(batch, HEADS * c, dtype=f32)))
    mutan_kw = {"heads": HEADS, "rows_per_sample": rows}
    if train:
        _, v = kernels.mutan_fwd_residual_plain(*mutan_args, **mutan_kw)
        dz_args = (v, mutan_args[3], randn(batch * rows, c, scale=1e-3))
        dz, _, _ = kernels.mutan_bwd_dz_plain(*dz_args, **mutan_kw)
        out = {"mutan_fwd_residual": (mutan_args, mutan_kw, batch, 1),
               "mutan_bwd_dz": (dz_args, mutan_kw, batch, 1),
               "mutan_dw": ((mutan_args[0], dz), {}, batch, 1)}
    else:
        out = {"mutan_fused": (mutan_args, mutan_kw, batch, 1)}
    if norm != "double_softmax":
        out["spa_affinity" + sfx] = (*affinity, bg, groups)
    out["graph_msg"] = (msg_args(bg), {}, bg, 1)
    out["graph_update" + sfx] = (update, {}, bg, groups)
    if not spec["self_gate"]:
        n_other = levels - 1
        out["se_sum"] = ((randn(batch, N, cm),
                          [randn(batch, N, cm) for _ in range(n_other)],
                          [torch.sigmoid(randn(batch, cm, dtype=f32)).to(
                              torch.bfloat16) for _ in range(n_other)],
                          [uniform(cm, cm, limit=math.sqrt(3 / cm))
                           for _ in range(n_other)],
                          [randn(cm, scale=0.1) for _ in range(n_other)]), {},
                         batch, 1)
    out["convlstm_gates"] = (gates_args, {}, batch, 1)
    out["convlstm_raw"] = ((gates, cell, uniform(N, cm, limit=0.1), gstats,
                            1 + randn(5, cm, scale=0.1, dtype=f32),
                            randn(5, cm, scale=0.1, dtype=f32)), {}, batch, 1)
    return out


def kernel_cost(name, bk, groups, spec, others=2):
    """(bf16 product FLOPs, other f32 operations, bytes) of a kernel's
    function on a batch of `bk` samples of N rows with `groups` weight
    groups (the SE sum with `others` other levels), at the path `spec`'s
    widths (the mutan family at `frames` * N rows a sample): each input
    read once, each output written once."""
    c, k, a, cm = spec["c"], spec["k"], spec["a"], spec["cm"]
    m = bk * N
    if name.startswith("mutan"):
        m *= spec["frames"]
    if name in ("mutan_fused", "mutan_fwd_residual"):
        v_out = m * HEADS * c * 2 if name == "mutan_fwd_residual" else 0
        return (2 * m * k * HEADS * c, 4 * m * HEADS * c + 4 * m * c,
                m * k * 2 + k * HEADS * c * 2 + HEADS * c * 4
                + bk * HEADS * c * 4 + m * c * 2 + v_out)
    if name == "mutan_bwd_dz":
        # per v entry: the head sum, dz, dlang and db (~9 operations); per
        # output column: tanh, the norm and the l2norm's vjp (~12)
        return (0, 9 * m * HEADS * c + 12 * m * c,
                2 * m * HEADS * c * 2 + m * c * 2 + 2 * bk * HEADS * c * 4
                + HEADS * c * 4)
    if name == "mutan_dw":
        return (2 * m * k * HEADS * c, 0,
                m * k * 2 + m * HEADS * c * 2 + k * HEADS * c * 4)
    if name.startswith("spa_affinity"):
        return (2 * m * c * a + 2 * m * a * T, 2 * m * a + 12 * m * T,
                m * c * 2 + groups * (c * a + a) * 2 + bk * T * a * 2
                + 2 * bk * T * 4 + 2 * m * T * 4)
    if name == "graph_msg":
        return (2 * m * T * c, 3 * m * c, m * T * 2 + bk * T * c * 2
                + m * c * 2)
    if name.startswith("graph_update"):
        return (2 * m * c * c, 10 * m * c,
                3 * m * c * 2 + groups * (c * c * 2 + c * 2 + 2 * c * 4))
    if name == "se_sum":     # per other: product, bias, relu, gate, add; norm
        o = others
        return (2 * o * m * cm * cm, o * 5 * m * cm + 3 * m * cm,
                (2 + o) * m * cm * 2 + o * (cm * cm + cm + bk * cm) * 2)
    if name == "convlstm_gates":
        return (2 * m * 2 * cm * 4 * cm, 8 * m * cm,
                3 * m * cm * 2 + 2 * cm * 4 * cm * 2 + 2 * N * cm * 2
                + 4 * m * cm * 2)
    # convlstm_raw: 3 layer norms, tanh, 2 sigmoids, the cell and output
    # updates, the statistics: ~40 operations per element
    return (0, 40 * m * cm, 4 * m * cm * 2 + m * cm * 2 + N * cm * 2
            + 2 * 5 * cm * 4 + 2 * m * cm * 2)


def library_call(torch, name, args):
    """One PyTorch call that computes the kernel's whole function on the
    same inputs, where there is one (dW = x^T @ dz: `torch.mm` with an f32
    result); else None."""
    if name == "mutan_dw":
        return lambda: torch.mm(args[0].t(), args[1], out_dtype=torch.float32)
    return None


def library_product(torch, name, args):
    """cuBLAS's bf16 product of the kernel's main GEMM alone on the same
    inputs, a yardstick (not the same function); None where the kernel has
    no product."""
    if name == "mutan_dw":
        return library_call(torch, name, args)
    if name == "convlstm_gates":
        xh, w = torch.cat(args[:2], dim=-1), args[3]
        return lambda: torch.matmul(xh, w)
    if name == "se_sum":
        return lambda: [torch.matmul(o, w) for o, w in zip(args[1], args[3])]
    if name in ("convlstm_raw", "mutan_bwd_dz"):
        return None
    if name == "graph_msg":
        return lambda: torch.bmm(args[0], args[1])
    x, w = args[0], args[3 if name.startswith("graph_update") else 1]
    if name.endswith("_grouped"):          # [G, B/G*N, C] @ [G, C, A]
        xg = x.view(w.shape[0], -1, x.shape[-1])
        return lambda: torch.bmm(xg, w)
    return lambda: torch.matmul(x, w)


def check_kernels(torch, kernels, cmpc, dev, specs):
    """Phase 3: each kernel of each path of `specs` at the shapes that path
    gives it, against its plain version; returns one record per (kernel,
    path)."""
    # bf16 outputs: the kernel and its plain version round at the same
    # places but sum in other orders, so a rounding may land one bf16 ulp
    # apart; 1e-2 of the largest entry admits one ulp there (at most 2^-7)
    default_tol = 1e-2
    # statistics: the same f32 sums in other orders over up to 1.6M entries
    # per sample, of values that may sit one bf16 ulp apart; both move the
    # mean and the variance by far less than 1e-3 of their size, while a
    # wrong or missing column moves them by its whole size
    stats_tol = 1e-3
    records = []
    for path, spec in specs.items():
        inputs = kernel_inputs(torch, kernels, cmpc, dev, spec)
        for name, (args, kw, bk, groups) in inputs.items():
            others = len(args[1]) if name == "se_sum" else None
            wrapper = getattr(kernels, name)
            plain = kernels.PLAIN[wrapper]
            what = f"{name} at {path}"
            tol = KERNEL_TOL.get(name, default_tol)
            torch.cuda.synchronize()
            wide_before = getattr(wrapper, "wide_launches", None)
            got = wrapper(*args, **kw)
            want = plain(*args, **kw)
            torch.cuda.synchronize()
            form = "main" if wide_before is None or \
                wrapper.wide_launches == wide_before else "wide"
            if (form == "wide") != (spec.get("wide", False)
                                    and wide_before is not None):
                fail(f"{what}: the {form} form launched")
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            errs, stats = [], {}
            for i, (a, b) in enumerate(zip(got, want)):
                if STATS_OUTPUT.get(name) == i:
                    count = want[0].shape[-2] * want[0].shape[-1]
                    sum_err, stats_err = compare_stats(
                        torch, a, b, count, stats_tol, f"{what} statistics")
                    stats = {"stats_abs_err": sum_err, "stats_err": stats_err,
                             "stats_tolerance": stats_tol}
                else:
                    errs.append(compare(torch, a, b, tol, f"{what} output {i}"))
            library = library_call(torch, name, args)
            if library:
                lib_err = compare(torch, got[0], library(), tol,
                                  f"{what} against the library call")
                stats.update(library_max_abs_err=lib_err[0],
                             library_norm_err=lib_err[1])
            slots = got[2].shape[1] if name == "convlstm_raw" else None
            del got, want
            ms = gpu_ms(torch, lambda: wrapper(*args, **kw))
            plain_ms = gpu_ms(torch, lambda: plain(*args, **kw), groups=3,
                              reps=3)
            library_ms = gpu_ms(torch, library) if library else None
            product = library_product(torch, name, args)
            matmul_ms = gpu_ms(torch, product) if product else None
            bound_ms, bound_by = bound(*kernel_cost(name, bk, groups, spec,
                                                    others or 2))
            extra = {}
            rows = bk * N * (spec["frames"] if name.startswith("mutan")
                             else 1)
            if name == "mutan_bwd_dz":
                # dz kernel and finalize apart; the grid is one block per SM
                extra["split_ms"] = device_split_ms(
                    torch, lambda: wrapper(*args, **kw))
                scratch = kernels.mutan_bwd_dz_scratch(
                    rows, rows // bk, spec["c"], HEADS)[0]
                if form == "main":
                    extra["grid"] = (scratch - bk + 1) // 2
            if name == "convlstm_raw":   # one statistics slot per block
                extra["grid"] = slots * bk
            rec = {
                "name": f"{name}@{path}", "kernel": name, "path": path,
                "shape": {"batch": bk, "groups": groups, "rows": rows,
                          **{w: spec[w] for w in ("c", "k", "a", "cm")},
                          **({"others": others} if others else {}),
                          **({"masked": kw["masked"]} if "masked" in kw
                             else {})},
                "route": "cuda", "form": form, "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": None,
                "max_abs_err": max(e for e, _ in errs),
                "max_norm_err": max(n for _, n in errs),
                "tolerance": tol, **stats, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms, "matmul_ms": matmul_ms, **extra,
            }
            records.append(rec)
            stats_note = (f"; statistics: mean/variance error "
                          f"{stats['stats_err']:.3e} <= {stats_tol:.0e}"
                          if "stats_err" in stats else "")
            if library:
                stats_note = (f"; against torch.mm: max abs err "
                              f"{stats['library_max_abs_err']:.3e} (norm "
                              f"{stats['library_norm_err']:.3e}), "
                              f"library_ms {library_ms:.4f}")
            prod = (f"cuBLAS product alone {matmul_ms:.4f} ms"
                    if matmul_ms is not None else "no product")
            if extra:
                prod += f"; {json.dumps(extra)}"
            shape = (f", {others} other(s)" if others else "") + (
                "" if kw.get("masked", True) else ", unmasked")
            log(f"[kernels] {name} at {path} ({form} form, batch {bk}, "
                f"{rows} rows, "
                f"{groups} weight group(s){shape}, C={spec['c']} K={spec['k']} "
                f"A={spec['a']} CM={spec['cm']}): max abs err {rec['max_abs_err']:.3e} (norm "
                f"{rec['max_norm_err']:.3e} <= {tol:.0e}){stats_note}; "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, {prod}, bound "
                f"{bound_ms:.4f} ms ({bound_by})")
        del inputs
        torch.cuda.empty_cache()
    return records


def ptxas_report(text):
    """Per kernel entry of an nvcc -Xptxas -v log: registers, spill bytes
    (stores + loads), static shared memory, and the waits ptxas injected
    into a wgmma pipeline (C7517: the pipeline is serialised there)."""
    out, name, injected = [], None, {}
    for line in text.splitlines():
        if "C7517" in line:
            fn = line.split("in function '")[1].split("'")[0]
            injected[fn] = injected.get(fn, 0) + 1
        elif "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            spill = nums[1] + nums[2] if len(nums) >= 3 else None
        elif name and "Used" in line and "registers" in line:
            words = line.replace(",", " ").split()
            regs = int(words[words.index("registers") - 1])
            smem = int(words[words.index("smem") - 2]) if "smem" in words \
                else 0
            out.append({"kernel": name, "registers": regs,
                        "spill_bytes": spill, "static_smem": smem})
            name = None
    for rec in out:
        rec["wgmma_waits_injected"] = injected.get(rec["kernel"], 0)
    return out


def edge_inputs(torch, kernels, dev):
    """The kernels at small ragged shapes, as (wrapper name, record tag,
    args, kwargs): mutan at EDGE_ROWS rows of
    EDGE_N per sample (tiles straddle samples; 300 is off both row tiles),
    K = EDGE_K (off the 64-deep stages), C = 1000 (off the 128-column tiles,
    so W's 3D tensor map must read zeros past each head); dW at M = 1000,
    K = 136, W = 360; the ConvLSTM gates and the SE sum (4 others) at 3
    samples of 25 rows (75 rows: odd, and row tiles past each sample) and
    the fusion stack's C = CM; the grouped affinity (l2n, masked) and
    update and graph_msg at 3 samples of 25 * 3 = 75 rows (the last 128-row
    tile of each sample part empty), C = EDGE_C (one 256-column block),
    A = EDGE_A != C, T = EDGE_T words (two 32-word chunks of the affinity;
    a 48-word pooled box of graph_msg) and G = 3; graph_msg also at 3
    samples of EDGE_DZ_N rows (its last 32-row group holds 17), C = 1000
    (a 40-column last chunk) and T = EDGE_MSG_T; the
    dz pass at 2 samples of EDGE_DZ_N rows and C = 1000, and at 3 samples
    of 25 rows (a block's rows cross samples), C = EDGE_C, and the same
    with sample 1's v rows zero (sq <= 1e-12; its dz, ~1e6 times the
    others', would hide their errors in one record); the ConvLSTM raw kernel at 3 samples of 25
    rows (N * C % 8 != 0: 8-byte vectors), C = 12 and CM."""
    g = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(
            dtype)

    samples = EDGE_ROWS // EDGE_N
    mutan = ((randn(EDGE_ROWS, EDGE_K), randn(EDGE_K, HEADS * C, scale=0.1),
              randn(HEADS * C, scale=0.1, dtype=torch.float32),
              torch.tanh(randn(samples, HEADS * C, dtype=torch.float32))),
             {"heads": HEADS, "rows_per_sample": EDGE_N})
    b, n = 3, 25
    sig = [torch.sigmoid(randn(b, CM, dtype=torch.float32)).to(
        torch.bfloat16) for _ in range(4)]
    f32, gn = torch.float32, 3 * n
    mask = torch.zeros(b, 1, EDGE_T, device=dev)
    mask[:, :, :30] = 1
    affinity = ((randn(b, gn, EDGE_C), randn(G, EDGE_C, EDGE_A,
                                              scale=EDGE_C ** -0.5),
                 randn(G, EDGE_A, scale=0.1), randn(b, EDGE_T, EDGE_A),
                 torch.rand(b, 1, EDGE_T, generator=g, device=dev), mask),
                {"scale": EDGE_C ** 0.5, "l2n": True, "masked": True})

    def msg_args(n, t, c):
        return (torch.softmax(randn(b, n, t, dtype=f32), -1).to(
            torch.bfloat16), randn(b, t, c))

    edge_msg = msg_args(gn, EDGE_T, EDGE_C)
    msg, st = kernels.graph_msg_plain(*edge_msg)
    update = (randn(b, gn, EDGE_C), msg, st,
              randn(G, EDGE_C, EDGE_C, scale=EDGE_C ** -0.5),
              randn(G, EDGE_C, scale=0.1),
              1 + randn(G, EDGE_C, scale=0.1, dtype=f32),
              randn(G, EDGE_C, scale=0.1, dtype=f32))

    def dz_args(b, n, c, zero_sample):
        # the dz pass: v as the forward's residual; sample 1's v rows zero
        v = torch.tanh(randn(b * n, HEADS * c, dtype=f32))
        if zero_sample:
            v[n:2 * n] = 0
        return ((v.to(torch.bfloat16),
                 torch.tanh(randn(b, HEADS * c, dtype=f32)),
                 randn(b * n, c, scale=0.1)),
                {"heads": HEADS, "rows_per_sample": n})

    def raw_args(c):
        gates, st = kernels.convlstm_gates_plain(
            *(randn(b, n, c) for _ in range(3)),
            randn(2 * c, 4 * c, scale=c ** -0.5), randn(n, c, scale=0.1),
            randn(n, c, scale=0.1))
        return ((gates, randn(b, n, c), randn(n, c, scale=0.1), st,
                 1 + randn(5, c, scale=0.1, dtype=f32),
                 randn(5, c, scale=0.1, dtype=f32)), {})

    # (wrapper name, record tag, args, kwargs)
    return [
        ("spa_affinity_grouped", "", *affinity),
        ("graph_msg", "", edge_msg, {}),
        ("graph_msg", ":N1681", msg_args(EDGE_DZ_N, EDGE_MSG_T, C), {}),
        ("graph_update_grouped", "", update, {}),
        ("mutan_fused", "", *mutan), ("mutan_fwd_residual", "", *mutan),
        ("mutan_dw", "", (randn(1000, EDGE_K), randn(1000, 360, scale=0.1)),
         {}),
        ("convlstm_gates", "", (*(randn(b, n, CM) for _ in range(3)),
                                randn(2 * CM, 4 * CM, scale=CM ** -0.5),
                                randn(n, CM, scale=0.1),
                                randn(n, CM, scale=0.1)), {}),
        ("se_sum", "", (randn(b, n, CM), [randn(b, n, CM) for _ in range(4)],
                        sig, [randn(CM, CM, scale=CM ** -0.5)
                              for _ in range(4)],
                        [randn(CM, scale=0.1) for _ in range(4)]), {}),
        ("mutan_bwd_dz", ":N1681", *dz_args(2, EDGE_DZ_N, C, False)),
        ("mutan_bwd_dz", ":N25", *dz_args(b, n, EDGE_C, False)),
        ("mutan_bwd_dz", ":zero", *dz_args(b, n, EDGE_C, True)),
        ("convlstm_raw", ":C12", *raw_args(12)),
        ("convlstm_raw", ":C500", *raw_args(CM)),
    ]


def wide_edge_inputs(torch, kernels, dev):
    """The wide forms at tests/test_torch_wide.py's widths, as (wrapper
    name, record tag, args, kwargs); a tag that starts with ':wide' must
    launch the wrapper's wide form: the affinity at A = 2056 (l2n and
    masked, and neither) on 3 samples of 75 rows, C = EDGE_C, T = EDGE_T;
    the SE sum at C = 1032 with 2 others on 3 samples of 25 rows;
    graph_msg at C = 4104 (T = EDGE_T) and at C = 4096 with T = 300, and
    graph_update at C = 4104 on the first's msg; the dz pass at C = 4104
    with 5 heads and at C = 1030 with 8, on 2 samples of 75 rows.  Then the
    kernels that list no width bound, at the widened flagship's widths on
    their main kernels: mutan_fused at C = 4104 (K = 4112) and the
    ConvLSTM gates and raw kernels at CM = 1032."""
    g = torch.Generator(device=dev).manual_seed(17)
    f32, bf = torch.float32, torch.bfloat16
    wc, wa, wcm = WIDE_CFG["v_emb_dim"], 2056, WIDE_CFG["mlp_dim"]

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(
            dtype)

    b, n = 3, 75
    mask = torch.zeros(b, 1, EDGE_T, device=dev)
    mask[:, :, :30] = 1

    def affinity(l2n, masked):
        return ((randn(b, n, EDGE_C), randn(EDGE_C, wa, scale=EDGE_C ** -0.5),
                 randn(wa, scale=0.1), randn(b, EDGE_T, wa, scale=wa ** -0.5),
                 torch.rand(b, 1, EDGE_T, generator=g, device=dev), mask),
                {"scale": EDGE_C ** 0.5, "l2n": l2n, "masked": masked})

    def msg_args(bb, t, c):
        return (torch.softmax(randn(bb, n, t, dtype=f32), -1).to(bf),
                randn(bb, t, c))

    wide_msg = msg_args(b, EDGE_T, wc)
    msg, st = kernels.graph_msg_plain(*wide_msg)
    update = (randn(b, n, wc), msg, st, randn(wc, wc, scale=wc ** -0.5),
              randn(wc, scale=0.1), 1 + randn(wc, scale=0.1, dtype=f32),
              randn(wc, scale=0.1, dtype=f32))

    def dz_args(c, heads):
        return ((torch.tanh(randn(2 * n, heads * c, dtype=f32)).to(bf),
                 torch.tanh(randn(2, heads * c, dtype=f32)),
                 randn(2 * n, c, scale=0.1)),
                {"heads": heads, "rows_per_sample": n})

    se_n = 25
    se = (randn(b, se_n, wcm), [randn(b, se_n, wcm) for _ in range(2)],
          [torch.sigmoid(randn(b, wcm, dtype=f32)).to(bf) for _ in range(2)],
          [randn(wcm, wcm, scale=wcm ** -0.5) for _ in range(2)],
          [randn(wcm, scale=0.1) for _ in range(2)])
    k = wc + 8
    mutan = ((randn(2 * n, k), randn(k, HEADS * wc, scale=k ** -0.5),
              randn(HEADS * wc, scale=0.1, dtype=f32),
              torch.tanh(randn(2, HEADS * wc, dtype=f32))),
             {"heads": HEADS, "rows_per_sample": n})
    gates_args = (*(randn(b, se_n, wcm) for _ in range(3)),
                  randn(2 * wcm, 4 * wcm, scale=wcm ** -0.5),
                  randn(se_n, wcm, scale=0.1), randn(se_n, wcm, scale=0.1))
    gates, gst = kernels.convlstm_gates_plain(*gates_args)
    raw = (gates, randn(b, se_n, wcm), randn(se_n, wcm, scale=0.1), gst,
           1 + randn(5, wcm, scale=0.1, dtype=f32),
           randn(5, wcm, scale=0.1, dtype=f32))
    return [
        ("spa_affinity", ":wide-A2056-l2n", *affinity(True, True)),
        ("spa_affinity", ":wide-A2056", *affinity(False, False)),
        ("se_sum", f":wide-C{wcm}", se, {}),
        ("graph_msg", f":wide-C{wc}", wide_msg, {}),
        ("graph_msg", ":wide-C4096-T300", msg_args(1, 300, 4096), {}),
        ("graph_update", f":wide-C{wc}", update, {}),
        ("mutan_bwd_dz", f":wide-C{wc}-5heads", *dz_args(wc, HEADS)),
        ("mutan_bwd_dz", ":wide-C1030-8heads", *dz_args(1030, 8)),
        ("mutan_fused", f":C{wc}", *mutan),
        ("convlstm_gates", f":CM{wcm}", gates_args, {}),
        ("convlstm_raw", f":CM{wcm}", raw, {}),
    ]


def mutan_k_edge(torch, cmpc, dev):
    """`cmpc.apply_mutan` at the HSV configs' K = 1000 + 11 = 1011, which
    it pads to 1016 for the kernel, on a bs=8 40x40 level against its plain
    route: seeded weights at their init scales, l2-normalized visual
    features and text feature, and the spatial channels at their ranges
    (the grid in [-1, 1], hue and saturation in [0, 1], value in [0,
    255])."""
    g = torch.Generator(device=dev).manual_seed(9)
    c, side = C, H_IMG // 8

    def uniform(*shape, lo=-1.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=g, device=dev)

    k = c + 11
    params = {"vis_trans": {"DW": uniform(1, 1, k, HEADS * c) * math.sqrt(
                  6 / (k + HEADS * c)),
                  "biases": 0.1 * uniform(HEADS * c)},
              "lang_trans": {"DW": uniform(1, 1, c, HEADS * c) * math.sqrt(
                  6 / (c + HEADS * c)),
                  "biases": 0.1 * uniform(HEADS * c)}}
    vis = torch.nn.functional.normalize(
        torch.randn(B, side, side, c, generator=g, device=dev), dim=-1)
    lang = torch.nn.functional.normalize(
        torch.randn(B, 1, 1, c, generator=g, device=dev), dim=-1)
    spatial = torch.cat([uniform(B, side, side, 8),
                         uniform(B, side, side, 2, lo=0.0),
                         uniform(B, side, side, 1, lo=0.0, hi=255.0)], -1)
    vis = vis.to(torch.bfloat16)
    with torch.inference_mode():
        got = cmpc.apply_mutan(params, lang, spatial, vis)
        want = cmpc.apply_mutan(params, lang, spatial, vis, use_kernels=False)
    torch.cuda.synchronize()
    err, norm = compare(torch, got, want, 1e-2, "apply_mutan at K = 1011")
    return {"name": "apply_mutan@edge:K1011",
            "shapes": [list(vis.shape), list(spatial.shape),
                       [k, HEADS * c]], "tolerance": 1e-2,
            "max_abs_err": err, "max_norm_err": norm}


def check_edges(torch, kernels, cmpc, dev):
    """Each wgmma kernel at its edge shapes against its plain version (and
    dW against torch.mm), with the path records' tolerances (statistics
    partials as in phase 3), the wide forms at `wide_edge_inputs`' shapes
    (each must have launched its wide form, and no other edge a wide one);
    and `mutan_k_edge`."""
    records = []
    for name, tag, args, kw in (edge_inputs(torch, kernels, dev)
                                + wide_edge_inputs(torch, kernels, dev)):
        wrapper = getattr(kernels, name)
        tol = KERNEL_TOL.get(name, 1e-2)
        wide_before = getattr(wrapper, "wide_launches", 0)
        got = wrapper(*args, **kw)
        want = kernels.PLAIN[wrapper](*args, **kw)
        torch.cuda.synchronize()
        wide = getattr(wrapper, "wide_launches", 0) > wide_before
        if wide != tag.startswith(":wide"):
            fail(f"{name}@edge{tag}: the {'wide' if wide else 'main'} form "
                 "launched")
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        errs = [compare(torch, a, b, tol, f"{name} at the edge output {i}")
                for i, (a, b) in enumerate(zip(got, want))
                if STATS_OUTPUT.get(name) != i]
        if name in STATS_OUTPUT:
            i = STATS_OUTPUT[name]
            compare_stats(torch, got[i], want[i],
                          want[0].shape[-2] * want[0].shape[-1], 1e-3,
                          f"{name} at the edge statistics")
        library = library_call(torch, name, args)
        if library:
            errs.append(compare(torch, got[0], library(), tol,
                                f"{name} at the edge against torch.mm"))
        shapes = [list(a.shape) if hasattr(a, "shape") else
                  [list(t.shape) for t in a] for a in args]
        rec = {"name": f"{name}@edge{tag}", "shapes": shapes, "tolerance": tol,
               "max_abs_err": max(e for e, _ in errs),
               "max_norm_err": max(n for _, n in errs)}
        records.append(rec)
        log(f"[kernels] {rec['name']} {rec['shapes']}: max abs err "
            f"{rec['max_abs_err']:.3e} (norm {rec['max_norm_err']:.3e} <= "
            f"{tol:.0e})")
    rec = mutan_k_edge(torch, cmpc, dev)
    records.append(rec)
    log(f"[kernels] {rec['name']} {rec['shapes']} (K padded to 1016 inside):"
        f" max abs err {rec['max_abs_err']:.3e} (norm "
        f"{rec['max_norm_err']:.3e} <= 1e-02)")
    return records


def odd_width_edges(torch, kernels, cmpc, dev):
    """Phase 10's edge records: the functions of models/cmpc.py that pad for
    the kernels, at odd widths C = ODD_C, A = ODD_A, CM = ODD_CM (padded to
    1008, 1008 and 504), each on CUDA tensors against the unpadded plain
    function on the same inputs, with phase 3's tolerance (1e-2 of the
    largest entry; the mutan's gradients per leaf at TRAIN_GRAD_TOL of its
    norm), and each must launch its kernels: `cmpc.apply_mutan` on a bs=8
    40x40 level (the mutan kernel) and its gradient under autograd (the
    training form, the dz pass and dW); `cmpc.affinity` (l2n, masked, the
    grouped form at G = 2 over 2 x 8 samples of N rows); `cmpc.graph_conv`
    (the message kernel and the grouped update) on those samples against
    the two-pass plain graph convolution; `cmpc.se_sum` with 2 others and
    `cmpc.convlstm_step_fused` (the gates and raw kernels, whose layer
    norms count ODD_CM columns) at bs=8."""
    g = torch.Generator(device=dev).manual_seed(13)
    bf, f32 = torch.bfloat16, torch.float32
    c, a, cm, side = ODD_C, ODD_A, ODD_CM, H_IMG // 8

    def randn(*shape, scale=1.0, dtype=f32):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(
            dtype)

    def unit(*shape):
        return torch.nn.functional.normalize(randn(*shape), dim=-1).to(bf)

    def launched(names, fn):
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        if set(counts) != set(names):
            fail(f"odd widths: expected launches of {sorted(names)}, got "
                 f"{counts}")
        return out, counts

    records = []

    def record(name, got, want, counts, tol=1e-2):
        errs = [compare(torch, x, y, tol, f"{name} at odd widths output {i}")
                for i, (x, y) in enumerate(zip(got, want))]
        rec = {"name": f"{name}@edge:odd", "widths": {"c": c, "a": a,
                                                      "cm": cm},
               "tolerance": tol, "launches": counts,
               "max_abs_err": max(e for e, _ in errs),
               "max_norm_err": max(n for _, n in errs)}
        records.append(rec)
        log(f"[kernels] {rec['name']} (C={c} A={a} CM={cm}, padded to "
            f"{cmpc.padded(c)}/{cmpc.padded(a)}/{cmpc.padded(cm)}): max abs "
            f"err {rec['max_abs_err']:.3e} (norm {rec['max_norm_err']:.3e} "
            f"<= {tol:.0e}); launches {counts}")

    # mutan: K = C + 8 = 1009 -> 1016, C -> 1008 per head
    k = c + 8
    params = {"vis_trans": {"DW": randn(1, 1, k, HEADS * c,
                                        scale=math.sqrt(2 / (k + HEADS * c))),
                            "biases": randn(HEADS * c, scale=0.1)},
              "lang_trans": {"DW": randn(1, 1, C, HEADS * c,
                                         scale=math.sqrt(2 / (C + HEADS * c))),
                             "biases": randn(HEADS * c, scale=0.1)}}
    vis, lang = unit(B, side, side, c), unit(B, 1, 1, C).float()
    spatial = randn(B, side, side, 8).clamp(-1, 1)
    m = B * side * side

    def mutan_plain(p):
        x = torch.cat([vis, spatial.to(bf)], -1).reshape(m, k)
        lt = torch.tanh(lang.reshape(B, C) @ p["lang_trans"]["DW"][0, 0]
                        + p["lang_trans"]["biases"])
        return kernels.mutan_plain(x, p["vis_trans"]["DW"][0, 0].to(bf),
                                   p["vis_trans"]["biases"], lt, heads=HEADS,
                                   rows_per_sample=side * side)

    with torch.inference_mode():
        got, counts = launched({"mutan_fused"}, lambda: cmpc.apply_mutan(
            params, lang, spatial, vis))
        record("apply_mutan", [got.reshape(m, c)], [mutan_plain(params)],
               counts)
    leaves = [params[t][n] for t in ("vis_trans", "lang_trans")
              for n in ("DW", "biases")]
    for leaf in leaves:
        leaf.requires_grad_()
    cot = randn(m, c, scale=1e-2)
    with torch.enable_grad():
        out, counts = launched(
            {"mutan_fwd_residual", "mutan_bwd_dz", "mutan_dw"},
            lambda: torch.autograd.grad(
                (cmpc.apply_mutan(params, lang, spatial, vis).reshape(m, c)
                 .float() * cot).sum(), leaves))
        want = torch.autograd.grad((mutan_plain(params).float() * cot).sum(),
                                   leaves)
    rel = max(((x - y).norm() / y.norm()).item() for x, y in zip(out, want))
    if not rel <= TRAIN_GRAD_TOL:
        fail(f"apply_mutan's gradient at odd widths: {rel:.3e} > "
             f"{TRAIN_GRAD_TOL} of a leaf's norm")
    records.append({"name": "apply_mutan_grad@edge:odd", "widths": {"c": c},
                    "tolerance": TRAIN_GRAD_TOL, "launches": counts,
                    "max_grad_rel_err": rel})
    log(f"[kernels] apply_mutan_grad@edge:odd (C={c}, K={k}): worst leaf "
        f"||g_k - g_p|| / ||g_p|| {rel:.3e} <= {TRAIN_GRAD_TOL}; launches "
        f"{counts}")
    del params, leaves, out, want, got

    # the affinity and the graph convolution: 2 groups of B samples
    groups, n = 2, side * side
    x = unit(groups * B, n, c)
    wgs = randn(groups, c, a, scale=c ** -0.5, dtype=bf)
    bgs = randn(groups, a, scale=0.1, dtype=bf)
    wt = unit(groups * B, T, a)
    rel = torch.rand(groups * B, 1, T, generator=g, device=dev)
    lens = torch.randint(3, T + 1, (groups * B,), generator=g, device=dev)
    mask = (torch.arange(T, device=dev)[None] < lens[:, None]).float()[:, None]
    kw = {"scale": math.sqrt(c), "l2n": True, "masked": True}
    with torch.inference_mode():
        got, counts = launched({"spa_affinity_grouped"}, lambda: cmpc.affinity(
            x, *cmpc.pad_projection(wgs, bgs), wt, rel, mask, **kw))
        want = kernels.spa_affinity_grouped_plain(x, wgs, bgs, wt, rel, mask,
                                                  **kw)
        record("affinity", got, want, counts)
        w_aff, v_aff = want
        gps = [{"update": {"DW": randn(1, 1, c, c, scale=c ** -0.5),
                           "biases": randn(c, scale=0.1)},
                "feat_ln": {"gamma": 1 + randn(c, scale=0.1),
                            "beta": randn(c, scale=0.1)},
                "update_ln": {"gamma": 1 + randn(c, scale=0.1),
                              "beta": randn(c, scale=0.1)}}
               for _ in range(groups)]
        got, counts = launched({"graph_msg", "graph_update_grouped"},
                               lambda: cmpc.graph_conv(
                                   cmpc.stack_gconv(gps, bf), x, w_aff, v_aff))
        record("graph_conv", [got], [cmpc._graph_conv_grouped(
            gps, x, w_aff, v_aff)], counts)
        del x, wt, w_aff, v_aff, got, want

        # the fusion stack's width
        feat = unit(B, n, cm)
        others = [unit(B, n, cm) for _ in range(2)]
        gates = [torch.sigmoid(randn(B, cm)).to(bf) for _ in range(2)]
        ws = [randn(cm, cm, scale=cm ** -0.5, dtype=bf) for _ in range(2)]
        bs = [randn(cm, scale=0.1, dtype=bf) for _ in range(2)]
        got, counts = launched({"se_sum"}, lambda: cmpc.se_sum(
            feat, others, gates, ws, bs))
        record("se_sum", [got], [kernels.se_sum_plain(feat, others, gates,
                                                      ws, bs)], counts)
        p = {"kernel": randn(1, 1, 2 * cm, 4 * cm,
                             scale=math.sqrt(1 / (3 * cm))),
             **{f"W_{q}": randn(side, side, cm, scale=0.1)
                for q in ("ci", "cf", "co")},
             "ln": [{"gamma": 1 + randn(cm, scale=0.1),
                     "beta": randn(cm, scale=0.1)} for _ in range(5)]}
        xs = [feat.reshape(B, side, side, cm)] + [
            unit(B, side, side, cm) for _ in range(2)]
        got, counts = launched({"convlstm_gates", "convlstm_raw"},
                               lambda: cmpc.convlstm_step_fused(p, *xs))
        # the plain step on the unpadded tables, counting cm columns
        tables = {"w": p["kernel"][0, 0].to(bf),
                  **{k: p[f"W_{k}"].reshape(-1, cm).to(bf)
                     for k in ("ci", "cf", "co")},
                  **{k: torch.stack([ln[k] for ln in p["ln"]])
                     for k in ("gamma", "beta")}}
        want = cmpc.convlstm_step_fused({**p, "tables": tables}, *xs,
                                        use_kernels=False)
        record("convlstm_step", got, want, counts)
    return records


def expected_launches(cmpc, batch, levels=3, train=False,
                      graph_norm="masked", self_gate=False, rounds=1,
                      sent_fusion=False):
    """Kernel launches of one forward (or train step) at `batch` of a config
    with `levels` levels: one mutan per level, two with the sentence fusion
    (a train step: the training form, the dz pass and the dW product, each
    once per mutan), one graph per level (or one packed set of launches;
    under the double softmax no affinity kernel) whose message and update
    run once per graph round, one SE sum per level in each of the two
    exchange rounds (none for the self-gated exchange), and one ConvLSTM
    step per level.  The backward launches no other kernel: it recomputes
    the other ops' plain routes."""
    packed = cmpc.pack_levels(batch, levels, graph_norm)
    per_level = 0 if packed else levels
    affinity = graph_norm != "double_softmax"
    mutans = levels * (2 if sent_fusion else 1)
    mutan = dict.fromkeys(("mutan_fwd_residual", "mutan_bwd_dz", "mutan_dw"),
                          mutans if train else 0)
    return {"mutan_fused": 0 if train else mutans, **mutan,
            "spa_affinity": per_level if affinity else 0,
            "spa_affinity_grouped": int(packed and affinity),
            "graph_msg": rounds * (1 if packed else levels),
            "graph_update": rounds * per_level,
            "graph_update_grouped": rounds * int(packed),
            "se_sum": 0 if self_gate else 2 * levels,
            "convlstm_gates": levels, "convlstm_raw": levels}


def config_launches(cmpc, cfg, batch, train=False):
    """`expected_launches` of config `cfg`."""
    return expected_launches(cmpc, batch, len(cfg.levels), train,
                             cfg.graph_norm, cfg.exchange_self_gate,
                             cfg.num_graph_conv, cfg.sent_fusion)


def check_counts(counts, expected, runs, what, wide=()):
    """The launches of `runs` runs of a path against `expected`, and the
    wide forms' launches since the counts were last reset (main resets
    them after the edge records): none on a registry path; on phase 17's,
    every launch of each wrapper named in `wide` and no other."""
    from cmpc_refseg_torch.ops import kernels
    for name, n in counts.items():
        if n != expected[name] * runs:
            fail(f"{what}: {name} launched {n} times in {runs} runs, "
                 f"expected {expected[name] * runs}")
    for name, n in kernels.wide_launch_counts().items():
        if n != (counts[name] if name in wide else 0):
            fail(f"{what}: {n} of {counts.get(name)} launches of {name} went "
                 "to its wide form")


def bert_text(cfg, rng, lens):
    """The 'bert' encoder's text: seeded N(0, 1) features [B, T, bert_dim]
    (no BERT model ships with the repository) and the masks of
    expressions of `lens` words."""
    return {"words_feat": rng.standard_normal(
                (len(lens), cfg.num_steps, cfg.bert_dim)).astype(np.float32),
            "sequence_mask": (np.arange(cfg.num_steps)[None]
                              < lens[:, None]).astype(np.float32)}


def make_batch(cfg, batch, seed=0):
    """Seeded images and 3-20-word expressions: back-padded with 'seq_len',
    or, for the 'lstm_frontpad' encoder, front-padded with 'valid_idx' (the
    number of pads); for the 'bert' encoder, `bert_text`.  The video
    model's batch holds a 'clip' of num_frames images instead of 'im'."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, cfg.num_steps + 1, batch)
    if cfg.text_encoder == "bert":
        return {"im": (50 * rng.standard_normal(
                    (batch, cfg.H, cfg.W, 3))).astype(np.float32),
                **bert_text(cfg, rng, lens)}
    words = np.zeros((batch, cfg.num_steps), np.int64)
    front = cfg.text_encoder == "lstm_frontpad"
    for i, n in enumerate(lens):
        ids = rng.integers(3, cfg.vocab_size, n)
        if front:
            words[i, cfg.num_steps - n:] = ids
        else:
            words[i, :n] = ids
    text = {"valid_idx": cfg.num_steps - lens} if front else \
        {"seq_len": lens.astype(np.int64)}
    key, lead = ("clip", (batch, cfg.num_frames)) if cfg.video else \
        ("im", (batch,))
    return {key: (50 * rng.standard_normal(
                (*lead, cfg.H, cfg.W, 3))).astype(np.float32),
            "words": words, **text}


def check_config(cfg, name, what, **want):
    """Fails unless `cfg` is the registry's `name` at full size (H_IMG,
    ResNet-101, its own widths) with the fields `want`."""
    from cmpc_refseg_torch.config import get_config
    ref = get_config(name)
    if (cfg.H, cfg.res4_blocks, cfg.v_emb_dim, cfg.mlp_dim) != \
            (H_IMG, RES4, ref.v_emb_dim, ref.mlp_dim) \
            or any(getattr(cfg, k) != v for k, v in want.items()):
        fail(f"unexpected {what} config {cfg}")


def check_forward(torch, cfg, out, ref, batch, what):
    """Outputs finite and shaped, and sigm within the bf16 tolerance of the
    plain route's; returns the sigm error."""
    # the multiscore logits at the levels' 1/8, the v3+ decoder's at c2's 1/4
    stride = 4 if cfg.decoder == "aspp_v3plus" else 8
    shapes = {"up": (batch, cfg.H, cfg.W, 1), "sigm": (batch, cfg.H, cfg.W, 1),
              "pred": (batch, cfg.H // stride, cfg.W // stride, 1),
              "words_parse": (batch, 1, cfg.num_steps, cfg.parse_classes)}
    for key, shape in shapes.items():
        v = getattr(out, key)
        if tuple(v.shape) != shape or not torch.isfinite(v).all():
            fail(f"{what} output {key}: shape {tuple(v.shape)} (want "
                 f"{shape}) or non-finite values")
    # bf16 end to end: the kernels and the plain versions round at the same
    # places but sum in other orders, so single bf16 ulps (2^-8 relative)
    # differ and propagate through 3 levels and the fusion stack.
    sigm_err = (out.sigm - ref.sigm).abs().max().item()
    if not sigm_err <= SIGM_TOL:
        fail(f"{what} sigm: kernels vs plain versions differ by "
             f"{sigm_err:.3e} > {SIGM_TOL}")
    if cfg.bbox_head:
        shape = (batch, cfg.vf_h, cfg.vf_w, cfg.num_anchors, 5)
        dec, dec_ref = out.bbox[1], ref.bbox[1]
        if tuple(dec.shape) != shape or not torch.isfinite(dec).all():
            fail(f"{what} boxes: shape {tuple(dec.shape)} (want {shape}) or "
                 "non-finite values")
        conf_err = (dec[..., 4] - dec_ref[..., 4]).abs().max().item()
        if not conf_err <= SIGM_TOL:
            fail(f"{what} box confidence: kernels vs plain versions differ "
                 f"by {conf_err:.3e} > {SIGM_TOL}")
    return sigm_err


def run_forward(torch, kernels, cmpc, build_model, apply_model, card):
    """Phase 4: the port's main path through its user entry point."""
    model = build_model("CMPC_model", device=DEV, dtype="bfloat16",
                        batch_size=B)
    cfg = model.cfg
    if (cfg.H, cfg.res4_blocks, cfg.v_emb_dim) != (H_IMG, RES4, C):
        fail(f"unexpected flagship config {cfg}")
    feed = {k: torch.as_tensor(v, device=DEV)
            for k, v in make_batch(cfg, B).items()}
    model.forward(feed)                       # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times = []
    for _ in range(N_FWD):
        t0 = time.perf_counter()
        out = model.forward(feed)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_counts(counts, expected_launches(cmpc, B), N_FWD, "forward")

    def plain_forward(f):
        # the same forward through the kernels' plain versions, on the card
        with torch.inference_mode():
            return apply_model(model.params, cfg, f, use_kernels=False)

    plain_forward(feed)                       # warm-up of the plain route
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = plain_forward(feed)
    torch.cuda.synchronize()
    plain_fwd_ms = (time.perf_counter() - t0) * 1e3
    sigm_err = check_forward(torch, cfg, out, ref, B, "forward")
    ms = statistics.median(times)
    runs = [round(t, 3) for t in times]
    log(f"[forward] {card}: CMPC_model 320x320 bs={B} bf16 res4_blocks=23: "
        f"{ms:.3f} ms/batch (median of {N_FWD}; all {runs}), "
        f"{B / ms * 1e3:.1f} masks/s; plain-version forward "
        f"{plain_fwd_ms:.3f} ms; peak memory {peak_gb:.2f} GB; sigm vs plain "
        f"max abs {sigm_err:.3e} <= {SIGM_TOL}; sigm mean "
        f"{out.sigm.mean().item():.4f}")
    log(f"[forward] launches in {N_FWD} forwards: {counts}")

    # one forward above the packing threshold: the per-level spatial graph
    big = {k: torch.as_tensor(v, device=DEV)
           for k, v in make_batch(cfg, B_LARGE, seed=1).items()}
    model.forward(big)                        # warm-up at this shape
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = model.forward(big)
    torch.cuda.synchronize()
    big_ms = (time.perf_counter() - t0) * 1e3
    big_counts = kernels.launch_counts()
    check_counts(big_counts, expected_launches(cmpc, B_LARGE), 1,
                 f"forward bs={B_LARGE}")
    big_err = check_forward(torch, cfg, out, plain_forward(big), B_LARGE,
                            f"forward bs={B_LARGE}")
    log(f"[forward] {card}: bs={B_LARGE} (per-level spatial graph): "
        f"{big_ms:.3f} ms/batch (one run), {B_LARGE / big_ms * 1e3:.1f} "
        f"masks/s; sigm vs plain max abs {big_err:.3e}; launches {big_counts}")
    return {"forward_bs8": (counts, N_FWD, ms),
            f"forward_bs{B_LARGE}": (big_counts, 1, big_ms)}


def run_long_forward(torch, build_model, apply_model, card):
    """A bs=1 forward with num_steps = LONG_T and a LONG_T-word expression:
    the affinity kernel takes more words than one 32-word chunk, the
    message kernel a 48-word pooled box; sigm against the plain
    route's."""
    model = build_model("CMPC_model", device=DEV, dtype="bfloat16",
                        batch_size=1, num_steps=LONG_T)
    cfg = model.cfg
    batch = make_batch(cfg, 1, seed=2)
    rng = np.random.default_rng(2)
    batch["words"][0] = rng.integers(3, cfg.vocab_size, LONG_T)
    batch["seq_len"][0] = LONG_T
    feed = {k: torch.as_tensor(v, device=DEV) for k, v in batch.items()}
    out = model.forward(feed)
    torch.cuda.synchronize()
    with torch.inference_mode():
        ref = apply_model(model.params, cfg, feed, use_kernels=False)
    err = check_forward(torch, cfg, out, ref, 1, f"forward num_steps={LONG_T}")
    log(f"[forward] {card}: bs=1 num_steps={LONG_T} ({LONG_T}-word "
        f"expression): sigm vs plain max abs {err:.3e} <= {SIGM_TOL}")


def request_set(np, vocab_size):
    """N_REQ requests: seeded uint8 RGB images of several native sizes and
    aspect ratios (COCO-like, landscape, portrait and square) and 3-20-word
    expressions over the synthetic vocabulary."""
    rng = np.random.default_rng(0)
    sizes = [(480, 640), (640, 427), (375, 500), (512, 512), (427, 640),
             (333, 500), (640, 480), (240, 320), (500, 375), (360, 640)]
    out = []
    for i in range(N_REQ):
        h, w = sizes[i % len(sizes)]
        words = rng.integers(4, vocab_size, rng.integers(3, 21))
        out.append((rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                    " ".join(f"w{v}" for v in words)))
    return out


def peak_gb(torch, fn):
    """Device memory a call allocates at its peak above what was allocated
    before it (its outputs included), in GB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def time_packing(torch, cmpc, svc, card):
    """The level-packed against the per-level spatial graph on the card at
    each of PACK_BATCHES with the service's prepared weights, as the model
    runs them: outputs held against each other, the peak of device memory
    of each form, then the host-clock time per call (dispatch included;
    the forward is bound by the host), measured in turns per-level, packed,
    packed, per-level.  The packed path runs whatever the rule chooses, so
    the grouped kernels are launched and held."""
    cfg = svc.cfg
    graphs = [svc.params["levels"][lv]["graph"] for lv in cfg.levels]
    stack = svc.params["graph_stack"]
    g = torch.Generator(device=DEV).manual_seed(1)
    hw = cfg.vf_h
    rows = []
    for b in PACK_BATCHES:
        def unit(*shape, dtype=torch.float32):
            v = torch.randn(*shape, generator=g, device=DEV)
            return (v * torch.rsqrt((v * v).sum(-1, keepdim=True))).to(dtype)

        vis = [unit(b, hw, hw, C, dtype=torch.bfloat16) for _ in cfg.levels]
        words = unit(b, 1, T, cfg.rnn_size)
        parse = torch.softmax(torch.randn(b, 1, T, 4, generator=g,
                                          device=DEV), -1)
        lens = torch.randint(3, T + 1, (b,), generator=g, device=DEV)
        mask = (torch.arange(T, device=DEV)[None] < lens[:, None]).float(
            )[:, None, :, None]

        def packed():
            with torch.inference_mode():
                return cmpc.apply_spa_graph_grouped(graphs, cfg, vis, words,
                                                    parse, mask, stack=stack)

        def per_level():
            with torch.inference_mode():
                outs = [cmpc.apply_spa_graph(p, cfg, v, words, parse, mask,
                                             stack=cmpc.level_of(stack, i))
                        for i, (p, v) in enumerate(zip(graphs, vis))]
            return [o[0] for o in outs], [o[1] for o in outs]

        (pk_out, pk_gw), (pl_out, pl_gw) = packed(), per_level()
        for lv, a, r, ga, gr in zip(cfg.levels, pk_out, pl_out, pk_gw, pl_gw):
            compare(torch, a, r, 1e-2, f"packed vs per-level graph {lv} b={b}")
            for x, y in zip(ga, gr):
                compare(torch, x, y, 1e-2, f"packed vs per-level gw {lv}")
        del pk_out, pk_gw, pl_out, pl_gw
        mem = {"per_level_peak_gb": peak_gb(torch, per_level),
               "packed_peak_gb": peak_gb(torch, packed)}
        t = [wall_ms(torch, fn) for fn in (per_level, packed, packed,
                                           per_level)]
        row = {"batch": b, "per_level_ms": (t[0] + t[3]) / 2,
               "packed_ms": (t[1] + t[2]) / 2, "runs_ms": t, **mem,
               "rule_packs": cmpc.pack_levels(b, len(cfg.levels))}
        rows.append(row)
        log(f"[serving] {card}: spatial graph b={b}: per-level "
            f"{row['per_level_ms']:.3f} ms, packed {row['packed_ms']:.3f} ms "
            f"per call (host clock, runs {[round(v, 3) for v in t]}); peak "
            f"memory per-level {mem['per_level_peak_gb']:.3f} GB, packed "
            f"{mem['packed_peak_gb']:.3f} GB; the rule packs: "
            f"{row['rule_packs']}")
        del vis, words, parse, mask
        torch.cuda.empty_cache()
    return rows


def run_serving(torch, np, kernels, cmpc, build_service, apply_model, card,
                name="CMPC_model", path="serving_bs1"):
    """Phase 5 (and phase 7's CMPCv6_model requests): the batch-1 serving
    path of config `name` through PredictService.predict; the flagship's
    also times the packed against the per-level spatial graph."""
    svc = build_service(name, dtype="bfloat16", device=DEV)
    cfg = svc.cfg
    check_config(cfg, name, path, batch_size=1)
    requests = request_set(np, cfg.vocab_size)
    svc.warmup()
    svc.predict(*requests[0])                 # warm-up request
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    latency, results = [], []
    for img, expr in requests:
        t0 = time.perf_counter()
        results.append(svc.predict(img, expr))
        latency.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launch_counts()
    check_counts(counts, config_launches(cmpc, cfg, 1), N_REQ, path)

    # the stages of the same requests: host preprocessing, the forward
    # (ending in the copy of sigm to the host), host postprocessing
    stages = {"pre": [], "forward": [], "post": []}
    for img, expr in requests:
        t0 = time.perf_counter()
        feed = svc.preprocess(img, expr)
        t1 = time.perf_counter()
        sigm = svc.forward(feed)
        t2 = time.perf_counter()
        svc.postprocess(sigm, img.shape[:2])
        t3 = time.perf_counter()
        for k, a, b in (("pre", t0, t1), ("forward", t1, t2),
                        ("post", t2, t3)):
            stages[k].append((b - a) * 1e3)

    # each answer against the plain route (the kernels' plain versions) on
    # the same feed, with the forward's sigm tolerance
    worst = 0.0
    for (img, expr), (prob, mask) in zip(requests, results):
        if prob.shape != img.shape[:2] or mask.shape != img.shape[:2] \
                or not np.isfinite(prob).all():
            fail(f"{path}: prob {prob.shape} / mask {mask.shape} for an "
                 f"image of {img.shape[:2]}, or non-finite prob")
        with torch.inference_mode():
            ref = apply_model(svc.params, cfg, svc.preprocess(img, expr),
                              model_state=svc.model_state,
                              use_kernels=False).sigm
        ref_prob, _ = svc.postprocess(ref[0, :, :, 0].float().cpu().numpy(),
                                      img.shape[:2])
        worst = max(worst, float(np.abs(prob - ref_prob).max()))
    if not worst <= SIGM_TOL:
        fail(f"{path}: prob of the kernels vs the plain route differs by "
             f"{worst:.3e} > {SIGM_TOL}")

    def pct(v, q):
        return float(np.percentile(v, q))

    summary = {"requests": N_REQ, "median_ms": pct(latency, 50),
               "p90_ms": pct(latency, 90),
               **{f"{k}_median_ms": pct(v, 50) for k, v in stages.items()},
               "prob_vs_plain_max_abs": worst}
    log(f"[{path}] {card}: {name} 320x320 bf16 res4_blocks=23 batch 1: "
        f"{N_REQ} requests, latency median {summary['median_ms']:.3f} ms, "
        f"p90 {summary['p90_ms']:.3f} ms (after a warm-up; all "
        f"{[round(v, 3) for v in latency]}); stages median: pre "
        f"{summary['pre_median_ms']:.3f}, forward "
        f"{summary['forward_median_ms']:.3f}, post "
        f"{summary['post_median_ms']:.3f} ms; prob vs plain route max abs "
        f"{worst:.3e} <= {SIGM_TOL}")
    log(f"[{path}] launches per request: "
        f"{ {k: v / N_REQ for k, v in counts.items()} }")
    if name == "CMPC_model":
        summary["packing"] = time_packing(torch, cmpc, svc, card)
    return {path: (counts, N_REQ, summary["forward_median_ms"])}, summary


def train_batch(cfg, batch, seed):
    """A seeded uint8 train batch: RGB images, a box mask per sample (a
    quarter to all of each side), 3-20-word expressions (`bert_text` for
    the 'bert' encoder); with the detection head, the v5+ train script's labels
    of each mask's box (`preprocess_true_boxes`: 'label_bbox' and
    'true_bbox'); for the video model, uint8 clips 'clip_u8' of
    num_frames frames and the center frame's mask."""
    from cmpc_refseg_torch.data.anchors import (DEFAULT_ANCHORS,
                                                preprocess_true_boxes)
    rng = np.random.default_rng(100 + seed)
    target = np.zeros((batch, cfg.H, cfg.W, 1), np.uint8)
    boxes = []
    for t in target:
        h, w = rng.integers(cfg.H // 4, cfg.H + 1), rng.integers(
            cfg.W // 4, cfg.W + 1)
        y, x = rng.integers(0, cfg.H - h + 1), rng.integers(0, cfg.W - w + 1)
        t[y:y + h, x:x + w] = 1
        boxes.append(preprocess_true_boxes(
            [[x, y, x + w, y + h]], cfg.H,
            DEFAULT_ANCHORS[:cfg.num_anchors]))
    labels = {"label_bbox": np.stack([lb for lb, _ in boxes]).astype(
                  np.float32),
              "true_bbox": np.stack([tb for _, tb in boxes]).astype(
                  np.float32)} if cfg.bbox_head else {}
    lens = rng.integers(3, cfg.num_steps + 1, batch)
    if cfg.text_encoder == "bert":
        text = bert_text(cfg, rng, lens)
    else:
        words = np.zeros((batch, cfg.num_steps), np.int64)
        for i, n in enumerate(lens):
            words[i, :n] = rng.integers(3, cfg.vocab_size, n)
        text = {"words": words, "seq_len": lens}
    key, lead = ("clip_u8", (batch, cfg.num_frames)) if cfg.video else \
        ("im_u8", (batch,))
    return {key: rng.integers(0, 256, (*lead, cfg.H, cfg.W, 3),
                              dtype=np.uint8),
            "target_u8": target, **text, **labels}


def mutan_faults(kernels):
    """Faults planted in the mutan kernels' wrappers, as check_train_routes'
    controls (name, plant, must_fail): the training forward with its first
    head's language vector zeroed (one head dropped) and its output times
    1.10, and the dW product times 1.25, which the rule must fail; the
    forward's output times 1.02 and dW times 1.10, near the tolerance and
    the noise of the mutan's own leaves, reported."""
    fwd, dw = kernels.mutan_fwd_residual, kernels.mutan_dw

    @contextlib.contextmanager
    def patched(name, fn):
        original = getattr(kernels, name)
        fn.launches = 0            # the wrapper counts under its own name
        setattr(kernels, name, fn)
        try:
            yield
        finally:
            setattr(kernels, name, original)

    def head_dropped(x, w, b, lang, *, heads, rows_per_sample):
        lang = lang.clone()
        lang[:, :lang.shape[1] // heads] = 0
        return fwd(x, w, b, lang, heads=heads,
                   rows_per_sample=rows_per_sample)

    def fwd_scaled(f):
        def fn(x, w, b, lang, *, heads, rows_per_sample):
            out, v = fwd(x, w, b, lang, heads=heads,
                         rows_per_sample=rows_per_sample)
            return (out.float() * f).to(out.dtype), v
        return lambda: patched("mutan_fwd_residual", fn)

    def dw_scaled(f):
        return lambda: patched("mutan_dw", lambda x, dz: dw(x, dz) * f)

    return (("mutan forward, first head dropped",
             lambda: patched("mutan_fwd_residual", head_dropped), True),
            ("mutan forward output x 1.10", fwd_scaled(1.10), True),
            ("mutan dW x 1.25", dw_scaled(1.25), True),
            ("mutan forward output x 1.02", fwd_scaled(1.02), False),
            ("mutan dW x 1.10", dw_scaled(1.10), False))


def draw_weights(torch, leaves, saved, i):
    """Draw i of check_train_routes: `leaves` set to `saved`, times
    (1 + NOISE_EPS N(0, 1)) from seed i for i > 0, leaf by leaf in order
    (the same draws in every process on the card)."""
    with torch.no_grad():
        gen = torch.Generator(device=DEV).manual_seed(i)
        for leaf, old in zip(leaves, saved):
            leaf.copy_(old)
            if i:
                leaf.mul_(1 + NOISE_EPS * torch.randn(
                    leaf.shape, generator=gen, device=DEV))


def check_train_routes(torch, trainer, reference, compute_gradients,
                       named_leaves, batch, kernel=None, controls=()):
    """The loss and every trainable gradient of the kernel route (g_k) against
    the plain route (g_p) on one batch from the trainer's current weights.

    `reference` is a float32 TrainState from the same seed: its plain route
    gives each gradient without bf16 rounding (g_32).  The three routes are
    read at the weights and at NOISE_DRAWS draws of them times
    (1 + NOISE_EPS N(0, 1)), each draw the same for all three, a change far
    below what moves a gradient that bf16 resolves; each quantity below is
    the median over these 1 + NOISE_DRAWS paired readings, over ||g_p|| at
    the weights.  The plain route's noise in a leaf is the median of
    ||g_p - g_32||.  A leaf whose noise exceeds TRAIN_GRAD_TOL is
    unresolved in bf16: its gradient is a small sum of large terms that
    cancel (PERF.md, section 6).  The classification reads the plain routes
    only, so no kernel fault can move a leaf into that set.  A resolved
    leaf is held at the median of ||g_k - g_p|| <= TRAIN_GRAD_TOL.  An
    unresolved one is held to the plain route's noise: the medians of
    ||g_k - g_32|| and of ||g_k - g_p|| each <= 2 x that noise, both
    gradients nonzero at the weights and the median ||g_k|| within half and
    twice the median ||g_p||, so that a gradient dropped, zeroed or blown
    up fails.  The summary also counts the leaves that one reading at the
    weights would resolve and fail (the rule before the draws) and that the
    largest of the plain readings would resolve.

    `kernel(i)`, when given, is the kernel route's (loss, gradients, BN
    statistics) at draw i (0: the weights), made elsewhere (phase 10's
    accumulated micro-steps).  `controls` are (name, plant, must_fail)
    triples (`mutan_faults`): plant() is a context in which a kernel
    wrapper gives a wrong result; the kernel route is read again at every
    draw under it and judged against the same plain readings; the rule must
    fail each control marked must_fail, and the others are reported.  The
    ASPP decoder's BN batch statistics (mean and variance of each unit,
    read back from the moving statistics each route leaves) are held like
    resolved gradients at the weights: ||s_k - s_p|| <= TRAIN_GRAD_TOL
    ||s_p|| per leaf; the state is restored after each route.  Returns a
    summary; fails past the tolerances, on a non-finite gradient or on a
    control that passes."""
    from cmpc_refseg_torch.models.aspp import BN_DECAY
    state, cfg = trainer.state, trainer.cfg
    named = list(named_leaves(state.trainable))
    paths = ["/".join(map(str, p)) for p, _ in named]
    pairs = list(zip((leaf for _, leaf in named),
                     (leaf for _, leaf in named_leaves(
                         reference.state.trainable))))
    label = f"train {cfg.variant}"
    if len(pairs) != len(paths) or any(not torch.equal(a, b)
                                       for a, b in pairs):
        fail(f"{label}: the f32 reference does not start from the weights")
    saved = [a.detach().clone() for a, _ in pairs]

    def grads(st, c, use_kernels):
        before = st.model_state
        loss, _ = compute_gradients(st, c, batch, use_kernels=use_kernels)
        out = [leaf.grad.double() for _, leaf in named_leaves(st.trainable)]
        st.optimizer.zero_grad(set_to_none=True)
        for path, g in zip(paths, out):
            if not torch.isfinite(g).all():
                fail(f"{label}: non-finite gradient of {path}")
        stats = {"/".join(p): (a.double() - BN_DECAY * b.double())
                 / (1 - BN_DECAY) for (p, a), (_, b) in
                 zip(named_leaves(st.model_state), named_leaves(before))}
        st.model_state = before
        return loss.item(), out, stats

    def draw(i):
        """Both trainers' weights, times (1 + NOISE_EPS N(0, 1)) drawn from
        seed i for i > 0."""
        draw_weights(torch, [a for a, _ in pairs], saved, i)
        with torch.no_grad():
            for a, b in pairs:
                b.copy_(a)

    def kernel_readings(read):
        """[draw][leaf] (||g_k - g_32||, ||g_k - g_p||, ||g_k||) of the
        kernel route `read(i)` against the f32 and plain gradients of each
        draw, and its (loss, BN statistics) at the weights."""
        out, first = [], None
        try:
            for i, (gp_i, g32_i) in enumerate(zip(plains, refs)):
                draw(i)
                loss, gk_i, stats = read(i)
                first = first or (loss, stats)
                out.append([((a - c).norm().item(), (a - b).norm().item(),
                             a.norm().item())
                            for a, b, c in zip(gk_i, gp_i, g32_i)])
        finally:
            draw(0)
        return out, first

    kernel = kernel or (lambda i: grads(state, cfg, True))
    # [draw][leaf] the f32 and plain gradients (f32, as the leaves hold
    # them) and (||g_p - g_32||, ||g_p||)
    refs, plains, plain = [], [], []
    try:
        for i in range(NOISE_DRAWS + 1):
            draw(i)
            loss32, g32, _ = grads(reference.state, reference.cfg, False)
            loss, g, stats = grads(state, cfg, False)
            if i == 0:
                loss_32, loss_p, sp = loss32, loss, stats
            refs.append([t.float() for t in g32])
            plains.append([t.float() for t in g])
            plain.append([((a - c).norm().item(), a.norm().item())
                          for a, c in zip(g, g32)])
    finally:
        draw(0)
    kern, (loss_k, sk) = kernel_readings(kernel)
    bn_rel = {leaf: ((sk[leaf] - sp[leaf]).norm() / sp[leaf].norm()).item()
              for leaf in sp}
    if any(not v <= TRAIN_GRAD_TOL for v in bn_rel.values()):
        fail(f"{label}: BN batch statistics of the kernel route vs the plain "
             f"route beyond {TRAIN_GRAD_TOL}: {bn_rel}")
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    if not loss_err <= TRAIN_LOSS_TOL:
        fail(f"{label}: loss of the kernel route {loss_k:.6g} vs the plain "
             f"route {loss_p:.6g}: relative error {loss_err:.3e} > "
             f"{TRAIN_LOSS_TOL}")
    norms = [n for _, n in plain[0]]
    for path, n in zip(paths, norms):
        if n == 0:
            fail(f"{label}: zero gradient of {path} on the plain route")

    def judge(kern):
        """Per leaf: the medians of the rule and its verdict, and the rule
        at the weights alone."""
        rows = []
        for j, (path, norm) in enumerate(zip(paths, norms)):
            def med(xs):
                return statistics.median(xs) / norm
            r = {"leaf": path, "norm": norm,
                 "plain_noise": med([d[j][0] for d in plain]),
                 "plain_norm": med([d[j][1] for d in plain]),
                 "plain_noise_max": max(d[j][0] for d in plain) / norm,
                 "rel": med([d[j][1] for d in kern]),
                 "kernel_vs_f32": med([d[j][0] for d in kern]),
                 "kernel_norm": med([d[j][2] for d in kern]),
                 "plain_vs_f32": plain[0][j][0] / norm,
                 "rel_at_weights": kern[0][j][1] / norm,
                 "f32_norm": refs[0][j].norm().item() / norm}
            r["resolved"] = r["plain_noise"] <= TRAIN_GRAD_TOL
            r["ok"] = kern[0][j][2] > 0 and (
                r["rel"] <= TRAIN_GRAD_TOL if r["resolved"] else
                max(r["kernel_vs_f32"], r["rel"]) <= 2 * r["plain_noise"]
                and r["plain_norm"] / 2 <= r["kernel_norm"]
                <= 2 * r["plain_norm"])
            # the rule on the one reading at the weights
            at = kern[0][j]
            r["ok_at_weights"] = at[2] > 0 and (
                at[1] / norm <= TRAIN_GRAD_TOL
                if r["plain_vs_f32"] <= TRAIN_GRAD_TOL else
                at[0] / norm <= 2 * r["plain_vs_f32"]
                and 0.5 <= at[2] / norm <= 2)
            rows.append(r)
        rows.sort(key=lambda r: -r["rel"])
        return rows

    rows = judge(kern)
    resolved = [r for r in rows if r["resolved"]]
    unresolved = [r for r in rows if not r["resolved"]]
    for r in rows[:6]:
        log(f"[{label}] gradient of {r['leaf']}: medians over the weights "
            f"and {NOISE_DRAWS} draws, over ||g_p|| = {r['norm']:.3e}: "
            f"||g_k - g_p|| {r['rel']:.3e} (at the weights "
            f"{r['rel_at_weights']:.3e}), ||g_k|| {r['kernel_norm']:.3e}, "
            f"||g_32|| {r['f32_norm']:.3e}, ||g_p - g_32|| "
            f"{r['plain_noise']:.3e} (at the weights {r['plain_vs_f32']:.3e}"
            f", largest {r['plain_noise_max']:.3e}), ||g_k - g_32|| "
            f"{r['kernel_vs_f32']:.3e}")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"{label}: kernel vs plain route gradients of {len(bad)} leaves "
             f"beyond the tolerance, first {bad[0]}")
    planted = {}
    for name, plant, must_fail in controls:
        with plant():
            caught = [r for r in judge(kernel_readings(kernel)[0])
                      if not r["ok"]]
        planted[name] = {"leaves_failed": len(caught), "must_fail": must_fail,
                         "first": caught[0]["leaf"] if caught else None}
        log(f"[{label}] control {name}: the rule fails {len(caught)} of "
            f"{len(rows)} leaves"
            f"{', first ' + caught[0]['leaf'] if caught else ''}")
        if must_fail and not caught:
            fail(f"{label}: control {name} passes the rule")
    return {"loss_rel_err": loss_err, "loss_f32_rel_err":
            abs(loss_k - loss_32) / abs(loss_32),
            "worst_grad_rel_err": rows[0]["rel"],
            "worst_grad_leaf": rows[0]["leaf"],
            "worst_resolved_grad_rel_err": resolved[0]["rel"],
            "worst_resolved_grad_leaf": resolved[0]["leaf"],
            "bn_stats_rel_err_max": max(bn_rel.values(), default=None),
            "bn_stats_leaves": len(bn_rel),
            "leaves": len(rows),
            "counts": {
                "resolved": len(resolved), "held_to_noise": len(unresolved),
                "resolved_at_weights": sum(r["plain_vs_f32"] <= TRAIN_GRAD_TOL
                                           for r in rows),
                "failed_at_weights": sum(not r["ok_at_weights"]
                                         for r in rows),
                "resolved_by_largest": sum(
                    r["plain_noise_max"] <= TRAIN_GRAD_TOL for r in rows)},
            "controls": planted,
            "unresolved_leaves": [
                {k: r[k] for k in ("leaf", "rel", "kernel_norm", "f32_norm",
                                   "plain_vs_f32", "kernel_vs_f32",
                                   "plain_noise", "plain_noise_max",
                                   "plain_norm")}
                for r in unresolved]}


def recompute_ms(torch, autograd, step):
    """Host-clock ms that the backward's recompute of the plain routes
    (`autograd._Recompute.backward`: affinity, graph conv, SE sums,
    ConvLSTM steps) takes in one call of `step`, each recompute bracketed
    by synchronizes, and the whole call's ms."""
    spent = []
    original = autograd._Recompute.backward

    def timed(ctx, *grads):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = original(ctx, *grads)
        torch.cuda.synchronize()
        spent.append((time.perf_counter() - t0) * 1e3)
        return out

    autograd._Recompute.backward = staticmethod(timed)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        autograd._Recompute.backward = staticmethod(original)
    return sum(spent), total


def run_train(torch, kernels, autograd, cmpc, build_trainer,
              compute_gradients, named_leaves, card, name="CMPC_model",
              path="train_bs8", glove=None, overrides=None, controls=()):
    """Phase 6 (and the CMPCv4_model steps of phase 7, the
    CMPCv5_BiLSTM_HSV_model and CMPCv4_BERT_model steps of phase 9, and
    phase 10's): the bs=8 train step of config `name` (with `overrides`)
    through build_trainer / Trainer.step; with `glove`, both trainers
    start from that embedding table, which must arrive on the card bit for
    bit.  With conv5, `conv5_proof` after the steps.  `controls` go to
    `check_train_routes`."""
    overrides = overrides or {}
    trainer = build_trainer(name, glove=glove, device=DEV, dtype="bfloat16",
                            batch_size=B, **overrides)
    cfg = trainer.cfg
    check_config(cfg, name, path, conv5=overrides.get("conv5", False),
                 grad_accum=1)
    if glove is not None and not torch.equal(
            trainer.state.trainable["text"]["embedding"].cpu(),
            torch.from_numpy(glove)):
        fail(f"{path}: the embedding on the card is not the GloVe table")
    batches = [train_batch(cfg, B, i) for i in range(N_TRAIN + 1)]
    reference = build_trainer(name, glove=glove, device=DEV,
                              dtype="float32", batch_size=B, **overrides)
    routes = check_train_routes(torch, trainer, reference, compute_gradients,
                                named_leaves, batches[0], controls=controls)
    del reference
    torch.cuda.empty_cache()
    initial = ({p: leaf.detach().clone() for p, leaf in named_leaves(
        trainer.state.trainable["backbone"])} if cfg.conv5 else None)
    trainer.step(batches[0])                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times, metrics = [], []
    for batch in batches[1:]:
        t0 = time.perf_counter()
        metrics.append(trainer.step(batch))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_counts(counts, config_launches(cmpc, cfg, B, train=True), N_TRAIN,
                 path)
    losses = [float(m["loss_total"]) for m in metrics]
    if not all(math.isfinite(v) for v in losses):
        fail(f"{path}: non-finite loss in {losses}")
    for where, leaf in named_leaves(trainer.state.trainable):
        if leaf.grad is None or not torch.isfinite(leaf.grad).all() \
                or not torch.isfinite(leaf).all():
            fail(f"{path}: missing or non-finite gradient or weight at "
                 f"{where}")
    for where, stat in named_leaves(trainer.state.model_state):
        if not torch.isfinite(stat).all():
            fail(f"{path}: non-finite BN moving statistics at {where}")
    if trainer.state.step != N_TRAIN + 1:
        fail(f"{path}: state.step {trainer.state.step}, expected "
             f"{N_TRAIN + 1}")
    if cfg.conv5:
        routes["conv5_proof"] = conv5_proof(torch, trainer, initial,
                                            named_leaves, path)
        del initial
    rec_ms, rec_step_ms = recompute_ms(
        torch, autograd, lambda: trainer.step(batches[-1]))
    ms = statistics.median(times)
    summary = {"steps": N_TRAIN, "glove_start": glove is not None,
               "median_ms": ms, "min_ms": min(times),
               "recompute_ms": rec_ms, "recompute_step_ms": rec_step_ms,
               "max_ms": max(times), "steps_per_s": 1e3 / ms,
               "peak_gb": peak, **routes, "losses": losses,
               "learning_rate": float(metrics[-1]["learning_rate"])}
    log(f"[{path}] {card}: {name}{overrides or ''} 320x320 bs={B} bf16 "
        f"res4_blocks=23, "
        f"{'res3-5 training' if cfg.conv5 else 'frozen backbone'}: "
        f"{ms:.3f} ms/step (median of {N_TRAIN}; range "
        f"{min(times):.3f}-{max(times):.3f}; all "
        f"{[round(t, 3) for t in times]}), {1e3 / ms:.2f} steps/s, "
        f"{B * 1e3 / ms:.1f} samples/s; peak memory {peak:.2f} GB")
    unresolved = [(r["leaf"], *(round(r[k], 4) for k in (
        "kernel_norm", "f32_norm", "plain_noise", "kernel_vs_f32", "rel")))
        for r in routes["unresolved_leaves"]]
    log(f"[{path}] kernel vs plain route on one batch: loss relative error "
        f"{routes['loss_rel_err']:.3e} <= {TRAIN_LOSS_TOL} (vs the f32 "
        f"plain route {routes['loss_f32_rel_err']:.3e}); worst gradient "
        f"||g_k - g_p|| / ||g_p|| {routes['worst_resolved_grad_rel_err']:.3e}"
        f" <= {TRAIN_GRAD_TOL} ({routes['worst_resolved_grad_leaf']}) over "
        f"the {routes['leaves'] - len(unresolved)} leaves the bf16 plain "
        f"route resolves (medians over its weights and {NOISE_DRAWS} draws "
        f"of them x (1 + {NOISE_EPS:g} N(0, 1))); {len(unresolved)} leaves "
        f"below its bf16 noise, each kernel route within twice the plain "
        f"route's median distance to the f32 gradient of both and within "
        f"2x of its norm: {unresolved} (leaf, then medians over ||g_p||: "
        f"||g_k||, ||g_32||, ||g_p - g_32||, ||g_k - g_32||, ||g_k - "
        f"g_p||); leaf counts "
        f"{routes['counts']}; losses {[round(v, 2) for v in losses]}")
    if routes["bn_stats_leaves"]:
        log(f"[{path}] BN batch statistics of the kernel vs the plain route: "
            f"worst ||s_k - s_p|| / ||s_p|| "
            f"{routes['bn_stats_rel_err_max']:.3e} <= {TRAIN_GRAD_TOL} over "
            f"{routes['bn_stats_leaves']} leaves")
    log(f"[{path}] launches in {N_TRAIN} steps: {counts}")
    log(f"[{path}] backward recompute of the plain routes: {rec_ms:.3f} ms "
        f"of a {rec_step_ms:.3f} ms step ({rec_ms / rec_step_ms:.1%}; one "
        "extra step, each recompute bracketed by synchronizes)")
    return {path: (counts, N_TRAIN, ms)}, summary


def conv5_proof(torch, trainer, initial, named_leaves, path):
    """With conv5, the forward after the steps reads the trained res3-5
    kernels: they moved from `initial`, the state's parameter tree holds
    the very tensors that train (no frozen copy of them), and a forward
    from the state differs from one with the initial kernels put back.
    Returns the largest weight change and logit difference."""
    from cmpc_refseg_torch.models.model import apply_model
    from cmpc_refseg_torch.train.optimizer import merge_params
    state, cfg = trainer.state, trainer.cfg
    params = state.params()
    moved = 0.0
    for p, leaf in named_leaves(state.trainable["backbone"]):
        node = params["backbone"]
        for key in p:
            node = node[key]
        if node is not leaf:
            fail(f"{path}: the forward's {p} is not the trained tensor")
        moved = max(moved, (leaf.detach() - initial[p]).abs().max().item())
    if not moved > 0:
        fail(f"{path}: the res3-5 kernels did not move")
    before = {}
    for p, v in initial.items():
        node = before
        for key in p[:-1]:
            node = node.setdefault(key, {})
        node[p[-1]] = v
    old = merge_params({**state.trainable, "backbone": before}, state.frozen)
    feed = {k: torch.as_tensor(v, device=DEV)
            for k, v in make_batch(cfg, B, seed=5).items()}
    with torch.inference_mode():
        now = apply_model(params, cfg, feed, model_state=state.model_state)
        then = apply_model(old, cfg, feed, model_state=state.model_state)
    diff = (now.up - then.up).abs().max().item()
    if not diff > 0:
        fail(f"{path}: the forward after the steps ignores the trained "
             "res3-5 kernels")
    log(f"[{path}] the forward reads the trained res3-5 kernels: largest "
        f"weight change {moved:.3e}, logits from them vs the initial "
        f"kernels max abs difference {diff:.3e}")
    return {"max_weight_change": moved, "logit_diff": diff}


def run_accum(torch, kernels, cmpc, build_trainer, compute_gradients,
              named_leaves, card):
    """Phase 10: CMPC_model with grad_accum=2 at bs=4 takes two micro-steps
    on the halves of a bs=8 batch (launches counted): no update after the
    first, one Adam update after the second.  The mean gradient it
    updates with is held against the bs=8 step's by phase 6's rule
    (`check_train_routes` with that mean as the kernel route's reading at
    the weights, and the mean of two bs=4 kernel-route gradients at each
    draw of them)."""
    path = f"accum_train_bs{B // 2}"
    acc = build_trainer("CMPC_model", device=DEV, dtype="bfloat16",
                        batch_size=B // 2, grad_accum=2)
    cfg = acc.cfg
    check_config(cfg, "CMPC_model", path, grad_accum=2, conv5=False)
    full = build_trainer("CMPC_model", device=DEV, dtype="bfloat16",
                         batch_size=B)
    reference = build_trainer("CMPC_model", device=DEV, dtype="float32",
                              batch_size=B)
    batch = train_batch(full.cfg, B, 0)
    halves = [{k: v[s] for k, v in batch.items()}
              for s in (slice(0, B // 2), slice(B // 2, B))]
    w0 = [leaf.detach().clone()
          for _, leaf in named_leaves(acc.state.trainable)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    times, metrics = [], []
    for i, half in enumerate(halves):
        t0 = time.perf_counter()
        metrics.append(acc.step(half))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        moved = [not torch.equal(leaf, w) for (_, leaf), w in
                 zip(named_leaves(acc.state.trainable), w0)]
        if any(moved) != (i == 1):
            fail(f"{path}: after micro-step {i + 1}, {sum(moved)} of "
                 f"{len(moved)} leaves moved")
    counts = kernels.launch_counts()
    check_counts(counts, config_launches(cmpc, cfg, B // 2, train=True), 2,
                 path)
    adam = {float(st["step"]) for st in acc.state.optimizer.state.values()}
    if acc.state.step != 2 or adam != {1.0}:
        fail(f"{path}: step {acc.state.step}, Adam counts {adam}")
    loss = sum(float(m["loss_total"]) for m in metrics) / 2
    mean = [leaf.grad.double() for _, leaf in named_leaves(
        acc.state.trainable)]

    def micro_mean(i):
        """The kernel route's mean gradient over the two halves: at the
        weights the one the update took; at a draw of them, the same mean
        of two bs=4 kernel-route gradients on the full trainer's (drawn)
        weights (CMPC_model draws no augmentation)."""
        if i == 0:
            return loss, mean, {}
        total, out = 0.0, []
        for half in halves:
            part, _ = compute_gradients(full.state, cfg, half)
            out.append([leaf.grad.double() for _, leaf in named_leaves(
                full.state.trainable)])
            full.state.optimizer.zero_grad(set_to_none=True)
            total += part.item() / 2
        return total, [(a + b) / 2 for a, b in zip(*out)], {}

    routes = check_train_routes(torch, full, reference, compute_gradients,
                                named_leaves, batch, kernel=micro_mean)
    del reference, full
    summary = {"micro_steps_ms": times, **routes}
    log(f"[{path}] {card}: CMPC_model grad_accum=2 bs={B // 2} bf16 "
        f"res4_blocks=23: micro-steps {[round(t, 3) for t in times]} ms; "
        f"the update's mean gradient vs the bs={B} step: loss relative "
        f"error {routes['loss_rel_err']:.3e}, worst resolved gradient "
        f"{routes['worst_resolved_grad_rel_err']:.3e} "
        f"({routes['worst_resolved_grad_leaf']}), "
        f"{len(routes['unresolved_leaves'])} leaves below the bf16 noise "
        f"held to it; launches in 2 micro-steps: {counts}")
    return {path: (counts, 2, statistics.median(times))}, summary


def device_categories(split):
    """device_split_ms's {kernel: ms} summed by category: the port's
    kernels, cuDNN's convolutions, cuBLAS's GEMMs and the rest
    (elementwise work such as BN and the layer norms, reductions,
    copies)."""
    cats = dict.fromkeys(("port_kernels", "convolutions", "gemms", "other"),
                         0.0)
    for name, ms in split.items():
        low = name.lower()
        if name.split("<")[0] in PORT_KERNELS:
            cats["port_kernels"] += ms
        elif any(w in low for w in ("fprop", "dgrad", "wgrad", "conv",
                                    "cudnn")):
            cats["convolutions"] += ms
        elif any(w in low for w in ("gemm", "nvjet", "cutlass", "xmma")):
            cats["gemms"] += ms
        else:
            cats["other"] += ms
    return cats


def run_variants(torch, kernels, cmpc, aspp, build_model, apply_model,
                 card, variants=VARIANTS, batch=B):
    """Phase 7 (and phase 9 with OPTIONS, phase 10 with PLUS, phase 12
    with the video model at 1 and 8 clips): the forward of each of
    `variants` at `batch` through build_model, counted, timed and held
    against the plain route as phase 4 holds the flagship's; the device
    split of a
    forward and, for the ASPP decoder, of the ASPP + decoder alone on
    inputs of its shapes (the fused features [B, 40, 40, mlp_dim] and the
    c2 tap [B, 80, 80, 256])."""
    paths, summary = {}, {}
    bs = batch
    for tag, name, overrides in variants:
        path = f"{tag}_bs{bs}"
        model = build_model(name, device=DEV, dtype="bfloat16",
                            batch_size=bs, **overrides)
        cfg = model.cfg
        check_config(cfg, name, path)
        batch = make_batch(cfg, bs, seed=3)
        if ("valid_idx" in batch) != (cfg.text_encoder == "lstm_frontpad"):
            fail(f"{path}: the batch's padding does not fit "
                 f"{cfg.text_encoder}")
        feed = {k: torch.as_tensor(v, device=DEV) for k, v in batch.items()}
        model.forward(feed)                   # warm-up (cuDNN plans)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        times = []
        for _ in range(N_FWD):
            t0 = time.perf_counter()
            out = model.forward(feed)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        check_counts(counts, config_launches(cmpc, cfg, bs), N_FWD, path)
        with torch.inference_mode():
            ref = apply_model(model.params, cfg, feed,
                              model_state=model.model_state, use_kernels=False)
        err = check_forward(torch, cfg, out, ref, bs, path)
        ms = statistics.median(times)
        split, per_fwd = device_split_ms(
            torch, lambda: model.forward(feed), reps=5, launches=True)
        split = device_categories(split)
        rec = {"config": name, **overrides, "median_ms": ms,
               "runs_ms": times, "masks_per_s": bs * 1e3 / ms,
               "peak_gb": peak, "sigm_vs_plain_max_abs": err,
               "device_ms": split, "device_kernels_per_forward": per_fwd,
               "launches": counts}
        if cfg.decoder == "aspp_v3plus":
            gen = torch.Generator(device=DEV).manual_seed(3)
            fused = torch.randn(B, cfg.vf_h, cfg.vf_w, cfg.mlp_dim,
                                generator=gen, device=DEV).to(torch.bfloat16)
            c2 = torch.relu(torch.randn(B, cfg.H // 4, cfg.W // 4, 256,
                                        generator=gen, device=DEV)).to(
                torch.bfloat16)
            state = model.model_state

            def decode():
                with torch.inference_mode():
                    enc, _ = aspp.apply_aspp(model.params["aspp"],
                                             state["aspp"], fused)
                    return aspp.apply_v3plus_decoder(
                        model.params["decoder"], state["decoder"], enc, c2)
            rec["decoder_wall_ms"] = wall_ms(torch, decode)
            rec["decoder_device_ms"] = device_categories(
                device_split_ms(torch, decode, reps=5))
        summary[path] = rec
        paths[path] = (counts, N_FWD, ms)
        dec = (f"; ASPP + decoder alone {rec['decoder_wall_ms']:.3f} ms "
               f"(host clock), device {json.dumps(rec['decoder_device_ms'])}"
               if "decoder_wall_ms" in rec else "")
        unit = f"{cfg.num_frames}-frame clips" if cfg.video else "masks"
        log(f"[{path}] {card}: {name}{overrides or ''} 320x320 bs={bs} bf16 "
            f"res4_blocks=23: {ms:.3f} ms/batch (median of {N_FWD}; all "
            f"{[round(t, 3) for t in times]}), {bs * 1e3 / ms:.1f} {unit}/s "
            f"(one mask each); "
            f"peak memory {peak:.2f} GB; sigm vs plain max abs {err:.3e} <= "
            f"{SIGM_TOL}; device ms per forward {json.dumps(split)} over "
            f"{per_fwd:.0f} device kernels{dec}")
        log(f"[{path}] launches in {N_FWD} forwards: {counts}")
        del model, feed, out, ref
        torch.cuda.empty_cache()
    return paths, summary


def eval_samples(cfg):
    """N_EVAL seeded evaluation samples as `evaluator.evaluate` takes them:
    a uint8 RGB image of one of EVAL_SIZES resized and padded to the
    model's size (BGR - mean), 3-20 words, a native mask (an ellipse whose
    boundary the model's grid does not align with) and its model-resolution
    copy 'target' for the on-device path."""
    from cmpc_refseg_torch.data.image import IMAGE_MEAN_BGR, resize_and_pad
    rng = np.random.default_rng(8)
    out = []
    for i in range(N_EVAL):
        h, w = EVAL_SIZES[i % len(EVAL_SIZES)]
        image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        cy, cx = rng.uniform(0.2, 0.8, 2) * (h, w)
        ry, rx = rng.uniform(0.1, 0.5, 2) * (h, w)
        yy, xx = np.mgrid[:h, :w]
        mask = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
        n = int(rng.integers(3, 21))
        words = np.zeros((1, cfg.num_steps), np.int64)
        words[0, :n] = rng.integers(3, cfg.vocab_size, n)
        im = resize_and_pad(image.astype(np.float32), cfg.H, cfg.W)
        target = resize_and_pad(mask.astype(np.float32), cfg.H, cfg.W) > 0
        out.append({"im": (im[..., ::-1] - IMAGE_MEAN_BGR)[None].astype(
                        np.float32),
                    "words": words, "seq_len": np.asarray([n]),
                    "orig_size": (h, w), "target_native": mask,
                    "target": target.astype(np.float32)[None, ..., None]})
    return out


def run_eval(torch, kernels, cmpc, card):
    """Phase 8a: the reference protocol (`evaluator.evaluate`) on the
    flagship at bs=8, bf16, full depth, over N_EVAL samples (the last
    batch padded).  Gates, per batch: the kernel route's `up` against the
    plain route's (max abs over max(1, max |up|) within SIGM_TOL, and sigm
    within SIGM_TOL absolute, as phase 4 holds it), and on the kernel
    route's own `up` the on-device (I, U) at model resolution
    (`model_res_iu`, `batched_mask_iu`: what `evaluate_sharded` sums)
    against the host `SegEvalAccumulator`'s, exactly.  Timed: the forward
    per batch, the host's native mapping per sample, and `evaluate`'s
    samples/s, its launches counted."""
    from cmpc_refseg_torch.config import get_config
    from cmpc_refseg_torch.models.model import (init_model, init_model_state,
                                                prepare_params)
    from cmpc_refseg_torch.ops.metrics import SegEvalAccumulator
    from cmpc_refseg_torch.train import evaluator as ev

    cfg = get_config("CMPC_model", compute_dtype="bfloat16", batch_size=B)
    params = init_model(0, cfg, device=DEV)
    state = init_model_state(cfg, device=DEV)
    samples = eval_samples(cfg)
    prepared = prepare_params(params, cfg)
    step_k = ev.make_eval_step(cfg)
    step_p = ev.make_eval_step(cfg, use_kernels=False)
    host = SegEvalAccumulator()
    dev_i = dev_u = 0
    worst_up = worst_sigm = 0.0
    small, pixels = 0, 0
    fwd_ms, map_ms = [], []
    step_k(prepared, state, next(ev.eval_batches(iter(samples), B))[1])
    for group, batch in ev.eval_batches(iter(samples), B):
        if len(batch["words"]) != B:
            fail(f"eval: a batch of {len(batch['words'])} rows, not {B}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        up_k, sigm_k = step_k(prepared, state, batch)
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - t0) * 1e3)
        up_p, sigm_p = step_p(prepared, state, batch)
        if not (torch.isfinite(up_k).all() and up_k.shape == (B, cfg.H,
                                                              cfg.W, 1)):
            fail(f"eval: up {tuple(up_k.shape)} or non-finite values")
        scale = max(1.0, up_p.abs().max().item())
        worst_up = max(worst_up, (up_k - up_p).abs().max().item() / scale)
        worst_sigm = max(worst_sigm, (sigm_k - sigm_p).abs().max().item())
        n = len(group)
        small += (up_k[:n].abs() < SIGM_TOL).sum().item()
        pixels += up_k[:n].numel()
        target = torch.as_tensor(np.concatenate([s["target"] for s in group]),
                                 device=DEV)
        i, u = ev.model_res_iu(up_k[:n], target)
        dev_i += int(i.sum())
        dev_u += int(u.sum())
        up_host = up_k[:n, :, :, 0].float().cpu().numpy()
        for j, sample in enumerate(group):
            pred = up_host[j] >= ev.SCORE_THRESHOLD
            tgt = sample["target"][0, :, :, 0] > 0.5
            host.update(np.sum(pred & tgt), np.sum(pred | tgt))
            t0 = time.perf_counter()
            native = ev.native_prediction(up_host[j], *sample["orig_size"])
            gt = sample["target_native"]
            _ = np.sum(native & gt), np.sum(native | gt)  # as `evaluate`
            map_ms.append((time.perf_counter() - t0) * 1e3)
    if not (worst_up <= SIGM_TOL and worst_sigm <= SIGM_TOL):
        fail(f"eval: kernel vs plain route: up {worst_up:.3e} of "
             f"max(1, max |up|), sigm {worst_sigm:.3e} > {SIGM_TOL}")
    if (dev_i, dev_u) != (host.cum_i, host.cum_u) or host.seg_total != N_EVAL:
        fail(f"eval: on-device (I, U) sums {(dev_i, dev_u)} vs the host "
             f"accumulator's {(host.cum_i, host.cum_u)} over "
             f"{host.seg_total} samples")

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = ev.evaluate(cfg, params, state, iter(samples), batch_size=B,
                          device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    forwards = -(-N_EVAL // B)
    check_counts(counts, expected_launches(cmpc, B), forwards, "eval_bs8")
    plain = ev.evaluate(cfg, params, state, iter(samples), batch_size=B,
                        device=DEV, use_kernels=False)
    batches = [{k: np.concatenate([s[k] for s in samples[i:i + B]])
                for k in ("im", "words", "seq_len", "target")}
               for i in range(0, N_EVAL - B + 1, B)]
    sharded = ev.evaluate_sharded(cfg, params, state, iter(batches),
                                  device=DEV)
    for r in (results["no_crf"], plain["no_crf"], sharded):
        if not all(math.isfinite(v) for v in r.values()):
            fail(f"eval: non-finite result {r}")
    summary = {
        "samples": N_EVAL, "batches": forwards,
        "forward_ms_per_batch": statistics.median(fwd_ms),
        "forward_ms_runs": fwd_ms,
        "host_map_ms_per_sample": statistics.median(map_ms),
        "samples_per_s": N_EVAL / wall, "evaluate_s": wall,
        "up_vs_plain_max_norm": worst_up, "sigm_vs_plain_max_abs": worst_sigm,
        "model_res_i": dev_i, "model_res_u": dev_u,
        "share_abs_up_below_2e-2": small / pixels,
        "results_kernels": results, "results_plain": plain,
        "sharded_56_samples": sharded}
    log(f"[eval_bs8] {card}: CMPC_model 320x320 bs={B} bf16 res4_blocks=23, "
        f"{N_EVAL} samples of {len(EVAL_SIZES)} native sizes: forward "
        f"{summary['forward_ms_per_batch']:.3f} ms per batch (median of "
        f"{forwards}, host clock around the step and a synchronize), native "
        f"mapping {summary['host_map_ms_per_sample']:.3f} host ms per "
        f"sample, evaluate {summary['samples_per_s']:.1f} samples/s "
        f"({wall:.3f} s); kernel vs plain route: up {worst_up:.3e} of "
        f"max(1, max |up|), sigm {worst_sigm:.3e} <= {SIGM_TOL}; on-device "
        f"(I, U) = ({dev_i}, {dev_u}) = the host accumulator's; "
        f"|up| < 2e-2 on {small / pixels:.3%} of the pixels")
    log(f"[eval_bs8] results, kernel route: {json.dumps(results)}; plain "
        f"route: {json.dumps(plain)}; evaluate_sharded over "
        f"{len(batches) * B} samples: {json.dumps(sharded)}")
    log(f"[eval_bs8] launches in {forwards} forwards: {counts}")
    return {"eval_bs8": (counts, forwards,
                         wall * 1e3 / forwards)}, summary


def run_checkpoint(torch, kernels, cmpc, build_trainer, named_leaves, card):
    """Phase 8b: CMPCv4_model's bs=8 trainer (bf16, full depth) takes two
    steps and saves a checkpoint; a trainer from another seed restores it
    (every leaf bit-equal: weights, the f32 frozen backbone, Adam's
    moments and count, the BN moving statistics, the step); each takes
    one more step on the same batch (losses within CKPT_LOSS_TOL
    relative); then a PredictService from the restored state and one from
    the original answer a request each (prob within SIGM_TOL).  Times
    save and restore, and the bytes on disk.  Launches of the four steps
    and of the two requests are counted."""
    import os
    import tempfile

    from cmpc_refseg_torch.data.text import synthetic_vocab
    from cmpc_refseg_torch.serving.server import PredictService
    from cmpc_refseg_torch.train.checkpoint import (FILE, restore_checkpoint,
                                                    save_checkpoint)

    trainer = build_trainer("CMPCv4_model", device=DEV, dtype="bfloat16",
                            batch_size=B)
    cfg = trainer.cfg
    batches = [train_batch(cfg, B, 200 + i) for i in range(3)]

    def saved(state):
        adam = state.optimizer.state
        out = {("step",): torch.tensor(state.step)}
        for path, p in named_leaves(state.trainable):
            out[("trainable",) + path] = p.detach()
            for key in ("exp_avg", "exp_avg_sq", "step"):
                out[(key,) + path] = adam[p][key]
        for name in ("frozen_f32", "model_state"):
            out.update({(name,) + path: leaf for path, leaf in
                        named_leaves(getattr(state, name))})
        return out

    def timed_step(t, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = t.step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return metrics

    step_ms = []
    kernels.reset_launch_counts()
    for batch in batches[:2]:
        timed_step(trainer, batch)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        save_checkpoint(tmp, trainer.state, trainer.state.step)
        save_ms = (time.perf_counter() - t0) * 1e3
        nbytes = os.path.getsize(os.path.join(tmp, str(trainer.state.step),
                                              FILE))
        restored = build_trainer("CMPCv4_model", seed=1, device=DEV,
                                 dtype="bfloat16", batch_size=B)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore_checkpoint(tmp, restored.state)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
    want, got = saved(trainer.state), saved(restored.state)
    bad = [k for k in want if k not in got or got[k].dtype != want[k].dtype
           or got[k].device != want[k].device
           or not torch.equal(got[k], want[k])]
    if bad or set(got) != set(want):
        fail(f"checkpoint: {len(bad)} leaves differ after the restore, "
             f"first {bad[:3]}")
    leaves = len(want)
    del want, got
    loss = [float(timed_step(t, batches[2])["loss_total"])
            for t in (trainer, restored)]
    counts = kernels.launch_counts()
    check_counts(counts, config_launches(cmpc, cfg, B, train=True), 4,
                 "ckpt_v4_train_bs8")
    loss_err = abs(loss[1] - loss[0]) / abs(loss[0])
    if not loss_err <= CKPT_LOSS_TOL:
        fail(f"checkpoint: next-step loss {loss[1]!r} after the restore vs "
             f"{loss[0]!r}: relative error {loss_err:.3e} > {CKPT_LOSS_TOL}")
    param_diff = max((a.detach().float() - b.detach().float()).abs().max()
                     .item() for (_, a), (_, b) in zip(
                         named_leaves(trainer.state.trainable),
                         named_leaves(restored.state.trainable)))

    vocab = synthetic_vocab(cfg.vocab_size)
    image, expr = request_set(np, cfg.vocab_size)[1]
    services = [PredictService(cfg, t.state.params(), vocab,
                               model_state=t.state.model_state, device=DEV)
                for t in (trainer, restored)]
    for svc in services:
        svc.warmup()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    probs, req_ms = [], []
    for svc in services:
        t0 = time.perf_counter()
        probs.append(svc.predict(image, expr)[0])
        req_ms.append((time.perf_counter() - t0) * 1e3)
    srv_counts = kernels.launch_counts()
    check_counts(srv_counts, config_launches(cmpc, cfg, 1), 2,
                 "ckpt_v4_serving_bs1")
    prob_err = float(np.abs(probs[0] - probs[1]).max())
    if probs[1].shape != image.shape[:2] or not prob_err <= SIGM_TOL:
        fail(f"checkpoint: the restored service's prob {probs[1].shape} "
             f"differs from the original's by {prob_err:.3e} > {SIGM_TOL}")
    summary = {"save_ms": save_ms, "restore_ms": restore_ms,
               "bytes": nbytes, "leaves_bit_equal": leaves,
               "step_ms": step_ms, "request_ms": req_ms,
               "next_step_losses": loss, "loss_rel_err": loss_err,
               "param_max_abs_diff_after_step": param_diff,
               "prob_vs_original_max_abs": prob_err}
    log(f"[ckpt_v4] {card}: CMPCv4_model bs={B} bf16 res4_blocks=23: save "
        f"{save_ms:.1f} ms, restore {restore_ms:.1f} ms, {nbytes} bytes on "
        f"disk; {leaves} leaves bit-equal after the restore; next-step loss "
        f"{loss[0]!r} vs restored {loss[1]!r} (relative {loss_err:.3e} <= "
        f"{CKPT_LOSS_TOL}); largest weight difference after that step "
        f"{param_diff:.3e}; the restored service's prob vs the original's "
        f"max abs {prob_err:.3e} <= {SIGM_TOL}")
    log(f"[ckpt_v4] launches in 4 steps: {counts}; in 2 requests: "
        f"{srv_counts}")
    return {"ckpt_v4_train_bs8": (counts, 4, statistics.median(step_ms)),
            "ckpt_v4_serving_bs1": (srv_counts, 2,
                                    statistics.median(req_ms))}, summary


def host_libraries():
    """{name: version or None} of the host libraries the data layer imports
    where it decodes (PIL, cv2), reads HDF5 (h5py), resizes (scipy) and
    logs (tensorboardX)."""
    import importlib
    out = {}
    for name in HOST_LIBS:
        try:
            out[name] = getattr(importlib.import_module(name), "__version__",
                                "?")
        except ImportError:
            out[name] = None
    return out


class Tee:
    """A stdout that also keeps what is written (the CLI's printout)."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self):
        return "".join(self.parts)


def run_cli(main, argv):
    """`main(argv)` in this process (so the launch counts see it), its
    printout kept; (result, printout, wall s)."""
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        result = main(argv)
    return result, tee.text(), time.perf_counter() - t0


@contextlib.contextmanager
def timed_steps(torch):
    """For the enclosed CLI runs, `trainer.make_train_step`'s steps and
    `save_checkpoint` are wrapped: each step ends in a synchronize and
    records its end on the host clock, the first step's batch and loss
    are kept, and each save's step and ms (`laps_ms` takes a save's time
    out of the lap of the step after it, so a lap is the loop's read,
    prepare and step)."""
    from cmpc_refseg_torch.train import trainer as tm
    real_step, real_save = tm.make_train_step, tm.save_checkpoint
    rec = {"ends": [], "first": None, "saves": [], "saved_after": {}}

    def make_train_step(cfg, **kw):
        step = real_step(cfg, **kw)

        def run(state, batch):
            metrics = step(state, batch)
            torch.cuda.synchronize()
            rec["ends"].append(time.perf_counter())
            if rec["first"] is None:
                rec["first"] = (dict(batch), float(metrics["loss_total"]))
            return metrics
        return run

    def save_checkpoint(directory, state, step, **kw):
        t0 = time.perf_counter()
        real_save(directory, state, step, **kw)
        dt = time.perf_counter() - t0
        rec["saves"].append((step, dt * 1e3))
        rec["saved_after"][len(rec["ends"]) - 1] = dt

    tm.make_train_step, tm.save_checkpoint = make_train_step, save_checkpoint
    try:
        yield rec
    finally:
        tm.make_train_step, tm.save_checkpoint = real_step, real_save


def laps_ms(rec):
    """Host ms between consecutive step ends of a `timed_steps` record,
    less a save between them: steps 2 to n."""
    ends, saved = rec["ends"], rec["saved_after"]
    return [(ends[i + 1] - ends[i] - saved.get(i, 0.0)) * 1e3
            for i in range(len(ends) - 1)]


class MemoryReader:
    """`read_collated` over batches held in memory, in turn: the train
    loop without a reader thread."""

    def __init__(self, batches):
        self.batches, self.n = batches, 0

    def read_collated(self, bs):
        batch = self.batches[self.n % len(self.batches)]
        self.n += 1
        return batch


def cli_dataset(root, vocab_size, glove_dim):
    """Phase 11's fake `unc` dataset, numpy alone, in the batch builders'
    layout: N_CLI_TRAIN train samples at 320x320 (uint8 image, a box
    mask, 3-20 back-padded words; no 'seq_length', so the CLI's collator
    counts the words) and N_EVAL eval samples at phase 8's native sizes
    (an ellipse mask each); the vocabulary file of `vocab_size` words and
    a seeded GloVe table [vocab_size, glove_dim] as `Gref_emb.npy`."""
    import os

    from cmpc_refseg_torch.data.text import synthetic_vocab
    rng = np.random.default_rng(13)

    def text():
        t = np.zeros(T, np.int32)
        n = int(rng.integers(3, T + 1))
        t[:n] = rng.integers(4, vocab_size, n)
        return t
    for split, n in (("train", N_CLI_TRAIN), ("val", N_EVAL)):
        d = os.path.join(root, "unc", f"{split}_batch")
        os.makedirs(d)
        for i in range(n):
            h, w = (H_IMG, H_IMG) if split == "train" else \
                EVAL_SIZES[i % len(EVAL_SIZES)]
            yy, xx = np.mgrid[:h, :w]
            if split == "train":
                bh, bw = rng.integers(h // 4, h + 1, 2)
                y, x = rng.integers(0, h - bh + 1), rng.integers(0, w - bw + 1)
                mask = (yy >= y) & (yy < y + bh) & (xx >= x) & (xx < x + bw)
            else:
                cy, cx = rng.uniform(0.2, 0.8, 2) * (h, w)
                ry, rx = rng.uniform(0.1, 0.5, 2) * (h, w)
                mask = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
            np.savez(os.path.join(d, f"unc_{split}_{i}.npz"),
                     text_batch=text(), mask_batch=mask,
                     im_batch=rng.integers(0, 256, (h, w, 3), np.uint8),
                     sent_batch=[f"sample {i}"])
    vocab = synthetic_vocab(vocab_size)
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(sorted(vocab, key=vocab.get)) + "\n")
    glove = (0.4 * np.random.default_rng(GLOVE_SEED).standard_normal(
        (vocab_size, glove_dim))).astype(np.float32)
    np.save(os.path.join(root, "Gref_emb.npy"), glove)


def refvos_tree(root, vocab_size):
    """A seeded fake RefVOS tree: N_REFVOS JPEG frames at REFVOS_HW
    (smooth content, quality 90) and palette PNG masks with object 1's
    color, one expression each; returns (im_dir, mask_dir, meta)."""
    import os

    from PIL import Image

    from cmpc_refseg_torch.data.refvos import OBJECT_COLOR
    im_dir, mask_dir = (os.path.join(root, d, "v") for d in ("J", "A"))
    os.makedirs(im_dir)
    os.makedirs(mask_dir)
    rng = np.random.default_rng(14)
    h, w = REFVOS_HW
    meta = []
    for i in range(N_REFVOS):
        small = rng.integers(0, 256, (h // 16, w // 16, 3), np.uint8)
        Image.fromarray(small).resize((w, h), Image.BILINEAR).save(
            os.path.join(im_dir, f"f{i}.jpg"), quality=90)
        m = np.zeros((h, w), np.uint8)
        y, x = rng.integers(0, h // 2), rng.integers(0, w // 2)
        m[y:y + h // 3, x:x + w // 3] = 1
        pm = Image.fromarray(m, mode="P")
        pm.putpalette([0, 0, 0] + list(OBJECT_COLOR["1"]) + [0] * (254 * 3))
        pm.save(os.path.join(mask_dir, f"f{i}.png"))
        words = rng.integers(4, vocab_size, rng.integers(3, T + 1))
        meta.append([f"v/f{i}.jpg", f"v/f{i}.png",
                     " ".join(f"w{v}" for v in words), "1"])
    path = os.path.join(root, "meta.json")
    with open(path, "w") as f:
        json.dump(meta, f)
    return os.path.dirname(im_dir), os.path.dirname(mask_dir), path


def reader_rate(read, n, warm):
    """Samples/s of `read()` over n calls after `warm` calls."""
    for _ in range(warm):
        read()
    t0 = time.perf_counter()
    for _ in range(n):
        read()
    return n / (time.perf_counter() - t0)


def serve_once(torch, requests, argv):
    """`serving.server.main(argv)` in a thread until it serves, a POST
    /predict of each (image, expression) of `requests` (each in a new
    handler thread), then the server shut down; returns (reply, mask,
    wall ms) per request."""
    import base64
    import io
    import threading
    import urllib.request

    from PIL import Image

    from cmpc_refseg_torch.serving import server as srv
    real_serve, held, errors = srv.serve, [], []

    def serve(service, host="127.0.0.1", port=8500):
        httpd = real_serve(service, host=host, port=port)
        held.append(httpd)
        return httpd

    def target():
        try:
            srv.main(argv)
        except BaseException as e:        # reported by the caller
            errors.append(e)
    srv.serve = serve
    thread = threading.Thread(target=target, daemon=True)
    try:
        thread.start()
        deadline = time.monotonic() + 600
        while not held and not errors and time.monotonic() < deadline:
            time.sleep(0.05)
        if not held:
            fail(f"cli: serving.server.main did not serve: {errors!r}")
        port = held[0].server_address[1]
        out = []
        for image, expr in requests:
            buf = io.BytesIO()
            Image.fromarray(image).save(buf, format="PNG")
            body = json.dumps({
                "image": base64.b64encode(buf.getvalue()).decode(),
                "expression": expr}).encode()
            t0 = time.perf_counter()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/predict", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                reply = json.loads(r.read())
            ms = (time.perf_counter() - t0) * 1e3
            mask = np.asarray(Image.open(io.BytesIO(base64.b64decode(
                reply["mask"])))) > 0
            out.append((reply, mask, ms))
    finally:
        if held:
            held[0].shutdown()
        thread.join(60)
        srv.serve = real_serve
    if thread.is_alive() or errors:
        fail(f"cli: the server did not stop cleanly: {errors!r}")
    return out


def run_cli_phase(torch, kernels, cmpc, card, train_ms, eval_sps, root):
    """Phase 11: the flagship through the port's command line at 320x320,
    bs=8, bf16, full depth, on `cli_dataset`: `cli.main -m train` 20
    steps with a snapshot every 10, then `-resume` to 30 (it must start at
    20, end with a snapshot at 30, and its first loss agree within
    TRAIN_LOSS_TOL with a Trainer.step from the restored step-20 state on
    the same batch); `-m test` on the 61 eval samples from step 30 (its
    printed IoUs within IOU_TOL of `evaluate` called directly); the
    readers alone (NpzReader; where PIL imports, RefVOSReader on
    `refvos_tree` with 1 thread and 8 spawned processes, fast decode where
    cv2 imports, and a 10-step `-d refvos -workers 8` CLI run); where PIL
    imports, `serving.server.main` on step 30 answering one POST /predict
    as a PredictService on the same state does (masks equal but where
    prob is within SIGM_TOL of the threshold); `export_program` at bs=1
    loaded back, its masks within SIGM_TOL of the plain route's.  The
    CLI's launches are counted and held at the shapes of the phase-3 path
    each shares (CLI_PATHS).  `train_ms` and `eval_sps` are phase 6's
    step ms and phase 8's samples/s, printed beside.  The dataset and the
    snapshots stay under `root` (a directory the caller removes), for
    phase 15's visualisation."""
    import os

    from cmpc_refseg_torch import api, cli
    from cmpc_refseg_torch.data.reader import NpzReader
    from cmpc_refseg_torch.data.refvos import RefVOSReader
    from cmpc_refseg_torch.data.text import load_vocab_dict_from_file
    from cmpc_refseg_torch.models.model import apply_model, prepare_params
    from cmpc_refseg_torch.serving import export
    from cmpc_refseg_torch.serving.server import PredictService
    from cmpc_refseg_torch.train import evaluator as ev
    from cmpc_refseg_torch.train.checkpoint import (FILE, latest_step,
                                                    restore_checkpoint)
    from cmpc_refseg_torch.train.trainer import create_train_state, train_loop

    libs = host_libraries()
    log(f"[cli] host libraries: {json.dumps(libs)}")
    has_pil, has_cv2 = libs["PIL"] is not None, libs["cv2"] is not None
    paths, out = {}, {"host_libraries": libs}
    ck = os.path.join(root, "ckpt")
    common = ["-n", "CMPC_model", "-f", root, "-emb_dir", root,
              "-bs", str(B), "-ckpt_dir", ck,
              "-log_dir", os.path.join(root, "logs")]
    train_argv = ["-m", "train", "-d", "unc", "-t", "train", "-s", "10",
                  "-workers", "1"] + common
    cfg, _ = cli.make_config(cli.build_argparser().parse_args(
        train_argv), torch.device(DEV))
    check_config(cfg, "CMPC_model", "cli")
    t0 = time.perf_counter()
    cli_dataset(root, cfg.vocab_size, cfg.glove_dim)
    out["dataset_s"] = time.perf_counter() - t0

    # train 20 steps, then resume to 30
    kernels.reset_launch_counts()
    with timed_steps(torch) as first:
        _, text, wall = run_cli(cli.main, train_argv + ["-st", "20"])
    if latest_step(ck) != 20 or len(first["ends"]) != 20 \
            or "GloVe embedding not found" in text:
        fail(f"cli: the 20-step run: latest snapshot "
             f"{latest_step(ck)}, {len(first['ends'])} steps (and the "
             f"GloVe table must load): {text[-300:]!r}")
    with timed_steps(torch) as resumed:
        state, text, wall_resume = run_cli(
            cli.main, train_argv + ["-st", "30", "-resume"])
    counts = kernels.launch_counts()
    check_counts(counts, expected_launches(cmpc, B, train=True), 30,
                 "cli_train_bs8")
    if f"resumed from {ck} at step 20" not in text or \
            latest_step(ck) != 30 or state.step != 30:
        fail(f"cli: the resumed run: {text[-300:]!r}, latest "
             f"snapshot {latest_step(ck)}, step {state.step}")
    del state
    step_ms = laps_ms(first)
    ms = statistics.median(step_ms)
    resume_ms = statistics.median(laps_ms(resumed))
    nbytes = os.path.getsize(os.path.join(ck, "30", FILE))
    paths["cli_train_bs8"] = (counts, 30, ms)

    # the resumed first step against Trainer.step from step 20
    batch, loss = resumed["first"]
    st = create_train_state(0, cfg, device=DEV)
    restore_checkpoint(ck, st, 20)
    ref = float(api.Trainer(cfg=cfg, state=st).step(batch)["loss_total"])
    loss_err = abs(loss - ref) / abs(ref)
    if not loss_err <= TRAIN_LOSS_TOL:
        fail(f"cli: the resumed run's first loss {loss!r} vs "
             f"Trainer.step's {ref!r}: relative {loss_err:.3e} > "
             f"{TRAIN_LOSS_TOL}")
    # control: the same loop over 10 of the dataset's batches held in
    # memory (no reader thread)
    collator = cli.NpzCollator(NpzReader(
        os.path.join(root, "unc", "train_batch"), "unc_train"))
    held = [collator.read_collated(B) for _ in range(10)]
    with timed_steps(torch) as mem:
        train_loop(cfg, MemoryReader(held), max_iter=st.step + 10,
                   state=st, start_iter=st.step)
    memory_ms = statistics.median(laps_ms(mem))
    restore_checkpoint(ck, st, 30)
    torch.cuda.empty_cache()

    # test from step 30
    real_evaluate, eval_s = ev.evaluate, []

    def timed_evaluate(*a, **kw):
        t0 = time.perf_counter()
        r = real_evaluate(*a, **kw)
        eval_s.append(time.perf_counter() - t0)
        return r
    test_argv = ["-m", "test", "-d", "unc", "-t", "val"] + common
    kernels.reset_launch_counts()
    ev.evaluate = timed_evaluate
    try:
        printed, text, test_wall = run_cli(cli.main, test_argv)
    finally:
        ev.evaluate = real_evaluate
    eval_counts = kernels.launch_counts()
    forwards = -(-N_EVAL // B)
    check_counts(eval_counts, expected_launches(cmpc, B), forwards,
                 "cli_eval_bs8")
    paths["cli_eval_bs8"] = (eval_counts, forwards,
                             eval_s[0] * 1e3 / forwards)
    t0 = time.perf_counter()
    samples = list(cli.npz_eval_samples(root, "unc", "val", cfg))
    host_ms = (time.perf_counter() - t0) * 1e3 / N_EVAL
    t0 = time.perf_counter()
    direct = ev.evaluate(cfg, st.params(), st.model_state, iter(samples),
                         device=DEV)["no_crf"]
    memory_sps = N_EVAL / (time.perf_counter() - t0)
    del samples
    shown = {k: float(v) for k, v in re.findall(
        r"^(overall IoU|mean IoU|precision@[\d.]+) = ([-\d.]+)", text,
        re.M)}
    want = {"overall IoU": direct["overall_iou"],
            "mean IoU": direct["mean_iou"],
            **{f"precision@{k[5:]}": v for k, v in direct.items()
               if k.startswith("prec@")}}
    iou_err = max((abs(shown[k] - v) for k, v in want.items()
                   if k in shown), default=math.inf)
    if set(shown) != set(want) or not iou_err <= IOU_TOL \
            or direct["n"] != N_EVAL:
        fail(f"cli: the CLI printed {shown}, evaluate gives {want} "
             f"over {direct['n']} samples")

    # the readers alone
    npz = NpzReader(os.path.join(root, "unc", "train_batch"),
                    "unc_train")
    rates = {"npz_1_thread": reader_rate(npz.read, N_CLI_TRAIN, B)}
    refvos_ms = None
    if has_pil:
        t0 = time.perf_counter()
        im_dir, mask_dir, meta = refvos_tree(root, cfg.vocab_size)
        out["refvos_tree_s"] = time.perf_counter() - t0
        vocab = os.path.join(root, "vocab.txt")
        for fast in (False, True) if has_cv2 else (False,):
            for workers in (1, 8):
                r = RefVOSReader(im_dir, mask_dir, meta, vocab,
                                 num_workers=workers,
                                 prefetch_num=4 * workers,
                                 fast_decode=fast)
                kind = "thread" if workers == 1 else "procs"
                try:
                    rates[f"refvos_{'fast' if fast else 'pil'}_"
                          f"{workers}_{kind}"] = reader_rate(
                              r.read_batch, N_REFVOS, 2 * workers)
                finally:
                    r.close()
        kernels.reset_launch_counts()
        with timed_steps(torch) as rv:
            run_cli(cli.main, [
                "-m", "train", "-d", "refvos", "-n", "CMPC_model",
                "-im_dir", im_dir, "-mask_dir", mask_dir, "-meta", meta,
                "-vocab", vocab, "-emb", "Gref", "-emb_dir", root,
                "-bs", str(B), "-st", "10", "-s", "0", "-workers", "8",
                "-ckpt_dir", os.path.join(root, "ck_refvos"),
                "-log_dir", os.path.join(root, "logs_refvos")])
        rv_counts = kernels.launch_counts()
        check_counts(rv_counts, expected_launches(cmpc, B, train=True),
                     10, "cli_refvos_train_bs8")
        refvos_ms = statistics.median(laps_ms(rv))
        paths["cli_refvos_train_bs8"] = (rv_counts, 10, refvos_ms)
    else:
        log("[cli] PIL does not import here: the RefVOS readers, "
            "the -d refvos CLI run and the HTTP round trip did not run")

    # serve step 30 over HTTP; a PredictService on the same state
    requests = request_set(np, cfg.vocab_size)[1:3]
    serving = None
    if has_pil:
        kernels.reset_launch_counts()
        replies = serve_once(torch, requests, [
            "-ckpt_dir", ck, "-vocab", os.path.join(root, "vocab.txt"),
            "-emb", "Gref", "-emb_dir", root, "-port", "0"])
        srv_counts = kernels.launch_counts()
        check_counts(srv_counts, expected_launches(cmpc, 1),
                     1 + len(requests), "cli_serving_bs1")
        paths["cli_serving_bs1"] = (srv_counts, 1 + len(requests),
                                    replies[-1][2])
        svc = PredictService(cfg, st.params(), load_vocab_dict_from_file(
            os.path.join(root, "vocab.txt")),
            model_state=st.model_state, device=DEV)
        serving = []
        for (image, expr), (reply, mask, req_ms) in zip(requests,
                                                        replies):
            prob, want_mask = svc.predict(image, expr)
            near = np.abs(prob - 0.5) <= SIGM_TOL
            differ = int(((mask != want_mask) & ~near).sum())
            if mask.shape != image.shape[:2] or differ or \
                    abs(reply["prob_max"] - float(prob.max())) > SIGM_TOL:
                fail(f"cli: POST /predict's mask {mask.shape} "
                     f"differs from PredictService's at {differ} pixels "
                     f"away from the threshold; prob_max "
                     f"{reply['prob_max']} vs {float(prob.max())}")
            serving.append({
                "request_ms": req_ms,
                "server_latency_ms": reply["latency_ms"],
                "mask_pixels_differ": int((mask != want_mask).sum()),
                "prob_max": reply["prob_max"]})
        del svc

    # export at bs=1, loaded back, against the plain route
    path = os.path.join(root, "predict.pt2")
    cfg1 = cfg.replace(batch_size=1)
    t0 = time.perf_counter()
    export.export_program(cfg1, st.params(), st.model_state, path)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    program = export.load_program(path)
    load_s = time.perf_counter() - t0
    feed = make_batch(cfg1, 1, seed=21)
    args = (torch.as_tensor(feed["im"], device=DEV),
            torch.as_tensor(feed["words"], device=DEV),
            torch.as_tensor(feed["seq_len"], device=DEV))
    kernels.reset_launch_counts()
    with torch.inference_mode():
        got = program(*args)
        if any(kernels.launch_counts().values()):
            fail(f"cli: the exported program launched the port's "
                 f"kernels: {kernels.launch_counts()}")
        prepared = prepare_params(st.params(), cfg1)
        batch1 = {"im": args[0], "words": args[1], "seq_len": args[2]}
        plain = apply_model(prepared, cfg1, batch1,
                            model_state=st.model_state,
                            use_kernels=False).sigm[..., 0]
        kernel = apply_model(prepared, cfg1, batch1,
                             model_state=st.model_state).sigm[..., 0]
        program_ms = wall_ms(torch, lambda: program(*args))
        plain_ms = wall_ms(torch, lambda: apply_model(
            prepared, cfg1, batch1, model_state=st.model_state,
            use_kernels=False))
    export_err = (got.float() - plain.float()).abs().max().item()
    if got.shape != (1, H_IMG, H_IMG) or not export_err <= SIGM_TOL:
        fail(f"cli: the exported program's masks "
             f"{tuple(got.shape)} differ from the plain route's by "
             f"{export_err:.3e} > {SIGM_TOL}")
    export_bytes = os.path.getsize(path)
    del program, prepared, st
    summary = {
        **out, "train_ms_steps_2_20": step_ms, "train_ms": ms,
        "trainer_step_ms_phase6": train_ms, "resume_ms": resume_ms,
        "train_loop_in_memory_ms": memory_ms,
        "train_wall_s": wall, "resume_wall_s": wall_resume,
        "saves_ms": first["saves"] + resumed["saves"],
        "snapshot_bytes": nbytes, "resumed_loss": loss,
        "trainer_step_loss": ref, "resumed_loss_rel_err": loss_err,
        "test_wall_s": test_wall, "evaluate_s": eval_s[0],
        "cli_samples_per_s": N_EVAL / test_wall,
        "evaluate_samples_per_s": N_EVAL / eval_s[0],
        "npz_eval_samples_host_ms_per_sample": host_ms,
        "evaluate_in_memory_samples_per_s": memory_sps,
        "eval_samples_per_s_phase8": eval_sps, "printed": shown,
        "printed_vs_evaluate_max_abs": iou_err, "reader_samples_per_s": rates,
        "refvos_cli_train_ms": refvos_ms, "serving": serving,
        "export_s": export_s, "load_s": load_s, "export_bytes": export_bytes,
        "program_ms": program_ms, "plain_route_ms": plain_ms,
        "export_vs_plain_max_abs": export_err,
        "export_vs_kernel_route_max_abs": (
            got.float() - kernel.float()).abs().max().item()}
    log(f"[cli] {card}: CMPC_model 320x320 bs={B} bf16 res4_blocks=23 "
        f"through cli.main: train {ms:.3f} ms/step (median of steps 2-20, "
        f"the loop's read and prepare included; resumed steps 22-30 "
        f"{resume_ms:.3f}; the loop over batches in memory, no reader "
        f"thread, {memory_ms:.3f}) vs phase 6's Trainer.step "
        f"{train_ms:.3f}; "
        f"snapshot {nbytes} bytes, saves {summary['saves_ms']} (step, ms); "
        f"resumed first loss {loss!r} vs Trainer.step {ref!r} (relative "
        f"{loss_err:.3e} <= {TRAIN_LOSS_TOL}); test {N_EVAL} samples: "
        f"{summary['cli_samples_per_s']:.1f} samples/s for the whole run "
        f"({test_wall:.3f} s), evaluate "
        f"{summary['evaluate_samples_per_s']:.1f} (over the samples in "
        f"memory {memory_sps:.1f}; npz_eval_samples {host_ms:.3f} host ms "
        f"per sample) vs phase 8's {eval_sps:.1f}; printed IoUs within "
        f"{iou_err:.1e} of evaluate's")
    log(f"[cli] readers, samples/s: {json.dumps(rates)}; -d refvos "
        f"-workers 8 CLI: {refvos_ms} ms/step (median of steps 2-10)")
    log(f"[cli] serving.server.main: {json.dumps(serving)}; export at "
        f"bs=1: {export_s:.1f} s, {export_bytes} bytes, load {load_s:.1f} "
        f"s, program {program_ms:.3f} ms vs the plain route {plain_ms:.3f} "
        f"ms; masks vs the plain route {export_err:.3e} <= {SIGM_TOL}, vs "
        f"the kernel route {summary['export_vs_kernel_route_max_abs']:.3e}")
    log(f"[cli] launches: 30 train steps {counts}; eval {eval_counts}")
    return paths, summary


def a2d_dataset(root, vocab_size, glove_dim):
    """Phase 12's fake A2D set, numpy alone, in `data/a2d.py`'s npz layout:
    N_A2D_TRAIN train and N_A2D_TEST test samples of seeded uint8 16-frame
    clips at 320x320, the center frame's box mask (empty at the test
    samples A2D_EMPTY), 3-20 back-padded words and their length; a seeded
    GloVe table [vocab_size, glove_dim] as `Gref_emb.npy`."""
    import os
    rng = np.random.default_rng(15)
    for split, n in (("train", N_A2D_TRAIN), ("test", N_A2D_TEST)):
        d = os.path.join(root, f"{split}_batch")
        os.makedirs(d)
        for i in range(n):
            text = np.zeros(T, np.int32)
            k = int(rng.integers(3, T + 1))
            text[:k] = rng.integers(4, vocab_size, k)
            mask = np.zeros((H_IMG, H_IMG), bool)
            if not (split == "test" and i in A2D_EMPTY):
                bh, bw = rng.integers(H_IMG // 4, H_IMG + 1, 2)
                y, x = rng.integers(0, H_IMG - bh + 1), rng.integers(
                    0, H_IMG - bw + 1)
                mask[y:y + bh, x:x + bw] = True
            np.savez(os.path.join(d, f"a2d_{split}_{i}.npz"),
                     text_batch=text, seq_length=np.int32(k),
                     mask_batch=mask, frames=rng.integers(
                         0, 256, (16, H_IMG, H_IMG, 3), np.uint8))
    glove = (0.4 * np.random.default_rng(GLOVE_SEED).standard_normal(
        (vocab_size, glove_dim))).astype(np.float32)
    np.save(os.path.join(root, "Gref_emb.npy"), glove)


def run_video_cli(torch, kernels, cmpc, card, train_ms):
    """Phase 12's A2D command line: the video model (320x320, bf16, full
    depth) through `cli_video.main` in this process on `a2d_dataset`:
    `-m train -bs 8` for N_VIDEO_STEPS steps and a snapshot at the last,
    then `-m test` from it, its final score's bias moved so that the masks
    cover part of each frame (batch 1; the empty-mask samples skipped
    before the forward), whose printed results must equal `evaluate_a2d`
    on the same weights and samples within IOU_TOL, with n the non-empty
    count and a mean IoU above 0.
    Launches held at the phase-3 paths video_train_bs8 and video_bs1
    (CLI_PATHS).  `train_ms` is the Trainer.step ms of the video train
    path, printed beside."""
    import os
    import tempfile

    from cmpc_refseg_torch import cli_video
    from cmpc_refseg_torch.data.reader import NpzReader
    from cmpc_refseg_torch.models.model import apply_model
    from cmpc_refseg_torch.train.checkpoint import (FILE, latest_step,
                                                    restore_checkpoint,
                                                    save_checkpoint)
    from cmpc_refseg_torch.train.trainer import create_train_state

    paths = {}
    with tempfile.TemporaryDirectory() as root:
        ck = os.path.join(root, "ckpt")
        common = ["-f", root, "-emb_dir", root, "-ckpt_dir", ck,
                  "-log_dir", os.path.join(root, "logs")]
        train_argv = ["-m", "train", "-bs", str(B), "-i", str(N_VIDEO_STEPS),
                      "-s", str(N_VIDEO_STEPS)] + common
        cfg = cli_video.make_config(cli_video.build_argparser().parse_args(
            train_argv), torch.device(DEV))
        check_config(cfg, VIDEO, "cli_video")
        t0 = time.perf_counter()
        a2d_dataset(root, cfg.vocab_size, cfg.glove_dim)
        dataset_s = time.perf_counter() - t0

        kernels.reset_launch_counts()
        with timed_steps(torch) as rec:
            state, text, train_wall = run_cli(cli_video.main, train_argv)
        counts = kernels.launch_counts()
        check_counts(counts, config_launches(cmpc, cfg, B, train=True),
                     N_VIDEO_STEPS, "cli_video_train_bs8")
        if latest_step(ck) != N_VIDEO_STEPS or state.step != N_VIDEO_STEPS \
                or len(rec["ends"]) != N_VIDEO_STEPS \
                or "GloVe embedding not found" in text \
                or not math.isfinite(rec["first"][1]):
            fail(f"cli_video: the {N_VIDEO_STEPS}-step run: latest snapshot "
                 f"{latest_step(ck)}, step {state.step}, first loss "
                 f"{rec['first'][1]}: {text[-300:]!r}")
        step_ms = laps_ms(rec)
        ms = statistics.median(step_ms)
        nbytes = os.path.getsize(os.path.join(ck, str(N_VIDEO_STEPS), FILE))
        paths["cli_video_train_bs8"] = (counts, N_VIDEO_STEPS, ms)
        del state
        torch.cuda.empty_cache()

        # the test set, and the step-10 weights with the final score's
        # bias moved by minus the median logit of the first sample, saved
        # as step 11: the masks then cover part of each frame, so the
        # IoUs the CLI prints are not all 0 (10 steps from random weights
        # predict none)
        reader = NpzReader(os.path.join(root, "test_batch"), "a2d_test",
                           shuffle=False)
        samples = [cli_video.prepare_video_batch(
            {k: np.asarray(v)[None] for k, v in reader.read().items()
             if k in cli_video.SAMPLE_KEYS})
            for _ in range(reader.num_samples)]
        cfg1 = cfg.replace(batch_size=1)
        st = create_train_state(0, cfg1, device=DEV)
        restore_checkpoint(ck, st)
        with torch.inference_mode():
            up = apply_model(st.params(), cfg1, {
                k: torch.as_tensor(v, device=DEV) for k, v in
                samples[0].items() if k != "target"}).up
        with torch.no_grad():
            st.trainable["scores"]["score"]["biases"] -= up.median()
        save_checkpoint(ck, st, N_VIDEO_STEPS + 1)

        n_scored = N_A2D_TEST - len(A2D_EMPTY)
        kernels.reset_launch_counts()
        printed, text, test_wall = run_cli(cli_video.main,
                                           ["-m", "test"] + common)
        test_counts = kernels.launch_counts()
        check_counts(test_counts, config_launches(cmpc, cfg, 1), n_scored,
                     "cli_video_test_bs1")
        paths["cli_video_test_bs1"] = (test_counts, n_scored,
                                       test_wall * 1e3 / n_scored)
        shown = {k: float(v) for k, v in re.findall(
            r"^(\S+) = (\S+)$", text, re.M)}
        t0 = time.perf_counter()
        direct = cli_video.evaluate_a2d(cfg, st.params(), st.model_state,
                                        samples, device=DEV)
        direct_s = time.perf_counter() - t0
        del st, samples
        err = max((abs(shown[k] - float(v)) for k, v in direct.items()
                   if k in shown), default=math.inf)
        if set(shown) != set(direct) or not err <= IOU_TOL \
                or direct["n"] != n_scored or shown["n"] != n_scored \
                or not direct["mean_iou"] > 0:
            fail(f"cli_video: the CLI printed {shown}, evaluate_a2d gives "
                 f"{direct}; {n_scored} samples have a mask")
    summary = {"dataset_s": dataset_s, "train_ms_steps_2_10": step_ms,
               "train_ms": ms, "trainer_step_ms": train_ms,
               "train_wall_s": train_wall,
               "snapshot_bytes": nbytes, "first_loss": rec["first"][1],
               "test_wall_s": test_wall, "test_samples": N_A2D_TEST,
               "scored": n_scored, "evaluate_a2d_s": direct_s,
               "printed": shown, "printed_vs_evaluate_max_abs": err}
    log(f"[cli_video] {card}: {VIDEO} 320x320 bs={B} bf16 res4_blocks=23 "
        f"through cli_video.main on {N_A2D_TRAIN} + {N_A2D_TEST} fake A2D "
        f"clips: train {ms:.3f} ms/step (median of steps 2-"
        f"{N_VIDEO_STEPS}, the loop's read and prepare included) vs "
        f"Trainer.step {train_ms:.3f}; snapshot {nbytes} bytes; test "
        f"{test_wall:.3f} s for {N_A2D_TEST} samples ({n_scored} scored, "
        f"evaluate_a2d alone {direct_s:.3f} s); printed results within "
        f"{err:.3e} <= {IOU_TOL} of evaluate_a2d: {shown}")
    return paths, summary


def run_video_infer(torch, kernels, cmpc, card):
    """Phase 12's RefVOS inference: `infer_video.run_inference` with the
    flagship (320x320, bf16, full depth) over `refvos_tree`'s N_REFVOS
    720x1280 frames, N_EXPR expressions, frame_batch 8: frames/s; every
    PNG (half resolution) equal to the mask `video_output_mask` makes
    from Model.forward's sigm on the same frames (but where sigm lies
    within 1e-4 of the threshold), launches held at forward_bs8; then
    with use_crf=True over the first N_CRF frames of one expression, the
    native DenseCRF required (it loads, and `mean_field_gaussian`, which
    `refine_mask` calls where the library returns nonzero, is called no
    time), its ms per frame."""
    import os
    import tempfile

    from PIL import Image

    from cmpc_refseg_torch import infer_video
    from cmpc_refseg_torch.api import build_model
    from cmpc_refseg_torch.data.image import IMAGE_MEAN_BGR, resize_and_pad
    from cmpc_refseg_torch.data.text import (load_vocab_dict_from_file,
                                             preprocess_sentence_lstm,
                                             synthetic_vocab)
    from cmpc_refseg_torch.models.model import init_model
    from cmpc_refseg_torch.ops import densecrf

    model = build_model("CMPC_model", device=DEV, dtype="bfloat16",
                        batch_size=B)
    cfg = model.cfg
    check_config(cfg, "CMPC_model", "infer_video")
    if not densecrf.native_available():
        fail(f"infer_video: {densecrf.native_library_path()} does not load: "
             "the CRF would fall back to its approximation")
    with tempfile.TemporaryDirectory() as root:
        vocab = synthetic_vocab(cfg.vocab_size)
        vocab_path = os.path.join(root, "vocab.txt")
        with open(vocab_path, "w") as f:
            f.write("\n".join(sorted(vocab, key=vocab.get)) + "\n")
        t0 = time.perf_counter()
        im_dir, _, _ = refvos_tree(root, cfg.vocab_size)
        tree_s = time.perf_counter() - t0
        frames = [f"f{i}" for i in range(N_REFVOS)]
        rng = np.random.default_rng(16)
        exprs = {str(e): {"exp": " ".join(
            f"w{v}" for v in rng.integers(4, cfg.vocab_size,
                                          rng.integers(3, T + 1)))}
            for e in range(N_EXPR)}
        meta_path = os.path.join(root, "meta_expressions.json")
        crf_meta = os.path.join(root, "meta_crf.json")
        for path, videos in ((meta_path, {"v": {"expressions": exprs,
                                                "frames": frames}}),
                             (crf_meta, {"v": {"expressions": {
                                 "0": exprs["0"]},
                                 "frames": frames[:N_CRF]}})):
            with open(path, "w") as f:
                json.dump({"videos": videos}, f)
        kw = dict(im_dir=im_dir, vocab_path=vocab_path, frame_batch=B,
                  device=DEV)
        raw = init_model(0, cfg, device=DEV)
        out = os.path.join(root, "out")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        n = infer_video.run_inference(cfg, raw, {}, meta_path=meta_path,
                                      out_dir=out, **kw)
        infer_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
        forwards = N_EXPR * -(-N_REFVOS // B)
        check_counts(counts, expected_launches(cmpc, B), forwards,
                     "infer_video_bs8")
        paths = {"infer_video_bs8": (counts, forwards,
                                     infer_s * 1e3 / forwards)}
        if n != N_EXPR:
            fail(f"infer_video: {n} expressions, expected {N_EXPR}")

        # the same frames through Model.forward
        ims = []
        for frame in frames:
            with Image.open(os.path.join(im_dir, "v", f"{frame}.jpg")) as im:
                native = np.asarray(im.convert("RGB"))
            im = resize_and_pad(native.astype(np.float32), cfg.H, cfg.W)
            ims.append(im[..., ::-1] - IMAGE_MEAN_BGR)
        oh, ow = native.shape[0] // 2, native.shape[1] // 2
        words = load_vocab_dict_from_file(vocab_path)
        differ = outside = 0
        for eid, e in exprs.items():
            tokens, seq_len = preprocess_sentence_lstm(e["exp"], words,
                                                       cfg.num_steps)
            for start in range(0, N_REFVOS, B):
                sigm = model.forward({
                    "im": np.stack(ims[start:start + B]).astype(np.float32),
                    "words": np.tile(np.asarray(tokens, np.int64)[None],
                                     (B, 1)),
                    "seq_len": np.full((B,), seq_len)}).sigm[..., 0]
                sigm = sigm.float().cpu().numpy()
                for k, frame in enumerate(frames[start:start + B]):
                    png = np.asarray(Image.open(os.path.join(
                        out, "v", eid, f"{frame}.png")))
                    want, lo, hi = (infer_video.video_output_mask(
                        (sigm[k] >= t).astype(np.float32), oh, ow)
                        for t in (0.5, 0.5 + 1e-4, 0.5 - 1e-4))
                    if png.shape != (oh, ow):
                        fail(f"infer_video: {eid}/{frame}.png is "
                             f"{png.shape}, expected {(oh, ow)}")
                    differ += int((png != want).sum())
                    outside += int(((png < lo) | (png > hi)).sum())
        if outside:
            fail(f"infer_video: {outside} PNG pixels differ from "
                 "Model.forward's masks away from the threshold")

        # N_CRF frames of one expression with the DenseCRF; a call of the
        # approximation means the native route returned nonzero
        real, crf_ms = densecrf.refine_mask, []
        approx, fallbacks = densecrf.mean_field_gaussian, []

        def timed(*a, **k):
            t1 = time.perf_counter()
            r = real(*a, **k)
            crf_ms.append((time.perf_counter() - t1) * 1e3)
            return r

        def counted(*a, **k):
            fallbacks.append(1)
            return approx(*a, **k)
        densecrf.refine_mask = timed
        densecrf.mean_field_gaussian = counted
        try:
            t0 = time.perf_counter()
            infer_video.run_inference(cfg, raw, {}, use_crf=True,
                                      meta_path=crf_meta,
                                      out_dir=os.path.join(root, "crf"),
                                      **kw)
            crf_s = time.perf_counter() - t0
        finally:
            densecrf.refine_mask = real
            densecrf.mean_field_gaussian = approx
        if fallbacks:
            fail(f"infer_video -c: the native DenseCRF failed on "
                 f"{len(fallbacks)} of {len(crf_ms)} frames and "
                 "mean_field_gaussian stood in")
        crf_png = np.asarray(Image.open(os.path.join(root, "crf", "v", "0",
                                                     "f0.png")))
        if len(crf_ms) != N_CRF or crf_png.shape != (oh, ow) \
                or not set(np.unique(crf_png)) <= {0, 255}:
            fail(f"infer_video -c: {len(crf_ms)} refinements, mask "
                 f"{crf_png.shape}")
    frames_per_s = N_EXPR * N_REFVOS / infer_s
    summary = {"tree_s": tree_s, "frames": N_EXPR * N_REFVOS,
               "inference_s": infer_s, "frames_per_s": frames_per_s,
               "png_pixels_differ": differ, "crf_frames": len(crf_ms),
               "crf_fallbacks": len(fallbacks),
               "crf_ms_per_frame": statistics.median(crf_ms),
               "crf_ms_range": [min(crf_ms), max(crf_ms)],
               "crf_run_s": crf_s,
               "crf_frames_per_s": N_CRF / crf_s}
    log(f"[infer_video] {card}: CMPC_model 320x320 bf16 res4_blocks=23, "
        f"{N_EXPR} expressions x {N_REFVOS} frames of "
        f"{REFVOS_HW[0]}x{REFVOS_HW[1]} at frame_batch {B}: "
        f"{frames_per_s:.1f} frames/s ({infer_s:.3f} s, JPEG decode, resize "
        f"and PNG writes included); PNGs vs Model.forward's masks: {differ} "
        f"pixels differ (none away from the threshold); with -c (native "
        f"DenseCRF at 320x320): refine_mask "
        f"{summary['crf_ms_per_frame']:.3f} ms per frame (median of "
        f"{len(crf_ms)}), {summary['crf_frames_per_s']:.1f} frames/s")
    del model, raw
    return paths, summary


def run_postproc_device(torch, card):
    """Phase 12's post-processing on the card: `mean_field_gaussian` on a
    bs=8 320x320 batch against its CPU run (within MF_TOL), and
    `nms_torch` on N_NMS seeded boxes with distinct scores keeping
    `nms_numpy`'s set (and `nms_native` its list); their times."""
    from cmpc_refseg_torch.ops import densecrf, nms
    gen = torch.Generator(device=DEV).manual_seed(17)
    prob = torch.rand(B, H_IMG, H_IMG, generator=gen, device=DEV) * 0.98 \
        + 0.01
    got = densecrf.mean_field_gaussian(prob)
    t0 = time.perf_counter()
    want = densecrf.mean_field_gaussian(prob.cpu())
    cpu_ms = (time.perf_counter() - t0) * 1e3
    mf_err = (got.cpu() - want).abs().max().item()
    if not mf_err <= MF_TOL:
        fail(f"mean_field_gaussian on the card vs the CPU: {mf_err:.3e} > "
             f"{MF_TOL}")
    mf_ms = gpu_ms(torch, lambda: densecrf.mean_field_gaussian(prob))
    rng = np.random.default_rng(18)
    xy = rng.random((N_NMS, 2)) * 300
    # distinct scores: the three take ties in different orders
    dets = np.concatenate([xy, xy + rng.random((N_NMS, 2)) * 80 + 4,
                           rng.permutation(N_NMS)[:, None] / N_NMS],
                          1).astype(np.float32)
    keep = nms.nms_numpy(dets, 0.5)
    boxes = torch.as_tensor(dets[:, :4], device=DEV)
    scores = torch.as_tensor(dets[:, 4], device=DEV)
    mask = nms.nms_torch(boxes, scores, 0.5)
    got_keep = np.flatnonzero(mask.cpu().numpy()).tolist()
    if got_keep != sorted(keep) or nms.nms_native(dets, 0.5) != keep:
        fail(f"nms: nms_torch on the card kept {len(got_keep)} boxes, "
             f"nms_numpy {len(keep)}, or nms_native differs")
    nms_ms = wall_ms(torch, lambda: nms.nms_torch(boxes, scores, 0.5))
    summary = {"mean_field_max_abs_vs_cpu": mf_err,
               "mean_field_ms_bs8": mf_ms, "mean_field_cpu_ms_bs8": cpu_ms,
               "nms_boxes": N_NMS, "nms_kept": len(keep),
               "nms_torch_wall_ms": nms_ms}
    log(f"[postproc] {card}: mean_field_gaussian bs={B} 320x320 on the card "
        f"{mf_ms:.4f} ms (CPU {cpu_ms:.1f} ms), max abs vs the CPU "
        f"{mf_err:.3e} <= {MF_TOL}; nms_torch over {N_NMS} boxes keeps "
        f"nms_numpy's {len(keep)} ({nms_ms:.3f} ms host clock)")
    return summary


def run_video_phase(torch, kernels, autograd, cmpc, aspp, build_model,
                    build_trainer, apply_model, compute_gradients,
                    named_leaves, card):
    """Phase 12: the video model's forwards of 1 and 8 clips (as phase 7
    drives its configs), its bs=8 train step (as phase 6 holds it, with
    `mutan_faults`' controls), the A2D command line, the RefVOS inference
    driver with its DenseCRF, and the post-processing on the card.
    Returns (paths, summary)."""
    t0 = time.perf_counter()
    paths, summary = {}, {}
    for bs in (1, B):
        torch.cuda.empty_cache()
        fwd_paths, fwd = run_variants(torch, kernels, cmpc, aspp,
                                      build_model, apply_model, card,
                                      variants=(("video", VIDEO, {}),),
                                      batch=bs)
        paths.update(fwd_paths)
        summary.update(fwd)
    torch.cuda.empty_cache()
    train_paths, summary[f"video_train_bs{B}"] = run_train(
        torch, kernels, autograd, cmpc, build_trainer, compute_gradients,
        named_leaves, card, name=VIDEO, path=f"video_train_bs{B}",
        controls=mutan_faults(kernels))
    paths.update(train_paths)
    torch.cuda.empty_cache()
    cli_paths, summary["cli_video"] = run_video_cli(
        torch, kernels, cmpc, card,
        summary[f"video_train_bs{B}"]["median_ms"])
    paths.update(cli_paths)
    torch.cuda.empty_cache()
    inf_paths, summary["infer_video"] = run_video_infer(torch, kernels, cmpc,
                                                        card)
    paths.update(inf_paths)
    summary["postproc"] = run_postproc_device(torch, card)
    summary["phase_s"] = time.perf_counter() - t0
    return paths, summary

def tree_bytes(tree):
    """Bytes of the distinct storages under a tree of tensors (a view and
    its base count once)."""
    seen = {}

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        else:
            st = node.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    walk(tree)
    return sum(seen.values())


def check_accumulations(torch, bb, svc, request):
    """On one request through `svc` (an int8 service), every conv unit's
    int32 accumulations from `int8_conv_gemm` (`torch._int_mm`) held
    bit-equal to `int8_conv_plain` (float64 `F.conv2d`, exact) on the same
    codes.  Returns the units' shape classes and their count."""
    seen = []
    real = bb.int8_conv_gemm

    def checked(xq, w_gemm, *, ksize, stride=1, dilation=1):
        got = real(xq, w_gemm, ksize=ksize, stride=stride, dilation=dilation)
        cin = xq.shape[1]
        k = ksize * ksize * cin
        w_q = w_gemm[:, :k].reshape(-1, ksize, ksize, cin).permute(0, 3, 1,
                                                                    2)
        want = bb.int8_conv_plain(xq, w_q, stride=stride, dilation=dilation)
        seen.append({"class": f"{ksize}x{ksize}/{stride} d{dilation}",
                     "k": k, "k_gemm": w_gemm.shape[1],
                     "m": got.shape[0] * got.shape[2] * got.shape[3],
                     "n": got.shape[1], "equal": bool(torch.equal(got, want)),
                     "max_abs_err": (got.double() - want.double()).abs()
                     .max().item()})
        return got

    bb.int8_conv_gemm = checked
    try:
        svc.predict(*request)
    finally:
        bb.int8_conv_gemm = real
    bad = [u for u in seen if not u["equal"]]
    if len(seen) != INT8_UNITS or bad:
        fail(f"int8: {len(seen)} units (expected {INT8_UNITS}); "
             f"{len(bad)} whose int32 accumulations differ from the float64 "
             f"conv, first {bad[:1]}")
    classes = {}
    for u in seen:
        key = f"{u['class']} K {u['k']}" + (
            f" -> {u['k_gemm']}" if u["k_gemm"] != u["k"] else "")
        classes[key] = classes.get(key, 0) + 1
    want = {"7x7/2 d1 K 147 -> 152", "1x1/1 d1", "1x1/2 d1", "3x3/1 d1",
            "3x3/1 d2", "3x3/1 d4"}
    missing = {c for c in want if not any(k.startswith(c) for k in classes)}
    if missing:
        fail(f"int8: shape classes not met on the request: {missing}")
    return classes


def run_int8(torch, kernels, cmpc, build_service, card, bf16_serving,
             bf16_fwd_ms):
    """Phase 13a: the int8 backbone serving path of the flagship (bf16,
    full depth, seed-0 weights).  Phase 5's 20 requests through
    `PredictService(quantize=True)`, dynamic scales and then calibrated on
    N_CAL seeded images: latency beside phase 5's bf16 service, launches
    counted, masks agreeing with a bf16 service's on > INT8_AGREE of the
    pixels at 0.5; the backbone's bytes on the card, int8 against bf16;
    on one request every unit's int32 accumulations bit-equal to the
    float64 conv (`check_accumulations`); the JAX package's quality bounds
    on c5 at full width against the f32 backbone; a bs=8 forward with the
    int8 backbone (ms, device split) beside phase 4's."""
    from cmpc_refseg_torch.config import get_config
    from cmpc_refseg_torch.data.image import IMAGE_MEAN_BGR, resize_and_pad
    from cmpc_refseg_torch.models import backbone as bb
    from cmpc_refseg_torch.models.model import (apply_model, init_model,
                                                prepare_backbone,
                                                prepare_params)

    svc = build_service("CMPC_model", dtype="bfloat16", device=DEV)
    cfg = svc.cfg
    requests = request_set(np, cfg.vocab_size)
    bf16_probs = [svc.predict(img, expr)[0] for img, expr in requests]
    bf16_bytes = tree_bytes(svc.params["backbone"])
    del svc
    torch.cuda.empty_cache()
    rng = np.random.default_rng(31)
    cal = []
    for _ in range(N_CAL):
        h, w = rng.integers(240, 641, 2)
        im = resize_and_pad(rng.integers(0, 256, (h, w, 3)).astype(
            np.float32), cfg.H, cfg.W)
        cal.append((im[..., ::-1] - IMAGE_MEAN_BGR)[None].astype(np.float32))
    paths, out = {}, {"bf16_backbone_bytes": bf16_bytes}
    for tag, images in (("dynamic", None), ("calibrated", cal)):
        path = f"int8_{tag}_serving_bs1"
        t0 = time.perf_counter()
        svc = build_service("CMPC_model", dtype="bfloat16", device=DEV,
                            quantize=True, calibration_images=images)
        build_s = time.perf_counter() - t0
        unit = svc.params["backbone"]["res5c"]["branch2b"]
        if unit["w_q"].dtype != torch.int8 or "w" in unit or \
                ("x_scale" in unit) != (images is not None):
            fail(f"{path}: the backbone is not int8 ({sorted(unit)})")
        svc.warmup()
        svc.predict(*requests[0])
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        latency, probs = [], []
        for img, expr in requests:
            t0 = time.perf_counter()
            probs.append(svc.predict(img, expr)[0])
            latency.append((time.perf_counter() - t0) * 1e3)
        counts = kernels.launch_counts()
        check_counts(counts, config_launches(cmpc, cfg, 1), N_REQ, path)
        same = sum(int(((p > 0.5) == (q > 0.5)).sum())
                   for p, q in zip(probs, bf16_probs))
        agree = same / sum(p.size for p in probs)
        if not all(np.isfinite(p).all() and p.shape == img.shape[:2]
                   for p, (img, _) in zip(probs, requests)) \
                or not agree > INT8_AGREE:
            fail(f"{path}: masks agree with the bf16 service's on "
                 f"{agree:.4f} of the pixels (> {INT8_AGREE} needed), or "
                 "prob is non-finite or misshaped")
        rec = {"median_ms": float(np.percentile(latency, 50)),
               "p90_ms": float(np.percentile(latency, 90)),
               "runs_ms": latency, "mask_agreement": agree,
               "build_s": build_s,
               "backbone_bytes": tree_bytes(svc.params["backbone"])}
        if tag == "dynamic":
            rec["units"] = check_accumulations(torch, bb, svc, requests[1])
        out[tag] = rec
        paths[path] = (counts, N_REQ, rec["median_ms"])
        log(f"[{path}] {card}: CMPC_model 320x320 bf16 res4_blocks=23, "
            f"int8 backbone ({tag} activation scales): {N_REQ} requests, "
            f"latency median {rec['median_ms']:.3f} ms, p90 "
            f"{rec['p90_ms']:.3f} ms (bf16 backbone, phase 5: "
            f"{bf16_serving['median_ms']:.3f} / "
            f"{bf16_serving['p90_ms']:.3f}); masks agree with the bf16 "
            f"service's on {agree:.4%} of the pixels (> {INT8_AGREE}); "
            f"backbone {rec['backbone_bytes']} bytes on the card vs bf16 "
            f"{bf16_bytes}")
        del svc
        torch.cuda.empty_cache()
    log(f"[int8] on one request, all {INT8_UNITS} units' int32 "
        f"accumulations bit-equal to the float64 conv; shape classes "
        f"{json.dumps(out['dynamic']['units'])}")

    # the JAX package's quality bounds at full width
    f32 = get_config("CMPC_model", compute_dtype="float32")
    backbone = init_model(0, f32, device=DEV)["backbone"]
    quant = prepare_backbone(bb.quantize_backbone(backbone), f32)
    x = torch.as_tensor(50 * np.random.default_rng(0).standard_normal(
        (1, cfg.H, cfg.W, 3)).astype(np.float32), device=DEV)
    with torch.inference_mode():
        ref = bb.apply_backbone(backbone, x, taps=("c5",),
                                res4_blocks=f32.res4_blocks)["c5"].double()
        got = bb.apply_backbone(quant, x, taps=("c5",),
                                res4_blocks=f32.res4_blocks)["c5"].double()
    rel = ((ref - got).norm() / ref.norm()).item()
    cos = ((ref * got).sum() / (ref.norm() * got.norm())).item()
    if not (rel < INT8_C5_REL and cos > INT8_C5_COS):
        fail(f"int8: c5 against the f32 backbone: relative error {rel:.4f} "
             f"(< {INT8_C5_REL}), cosine {cos:.5f} (> {INT8_C5_COS})")
    out["c5_rel_err"], out["c5_cosine"] = rel, cos
    del backbone, quant, ref, got
    torch.cuda.empty_cache()

    # a bs=8 forward with the int8 backbone
    cfg8 = get_config("CMPC_model", compute_dtype="bfloat16", batch_size=B)
    params = prepare_params(init_model(0, cfg8, device=DEV), cfg8,
                            quantize_backbone=True)
    feed = {k: torch.as_tensor(v, device=DEV)
            for k, v in make_batch(cfg8, B, seed=3).items()}

    def forward():
        with torch.inference_mode():
            return apply_model(params, cfg8, feed, model_state={})
    sigm = forward().sigm
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    times = []
    for _ in range(N_FWD):
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launch_counts()
    check_counts(counts, expected_launches(cmpc, B), N_FWD,
                 "int8_forward_bs8")
    if sigm.shape != (B, cfg8.H, cfg8.W, 1) or \
            not torch.isfinite(sigm).all():
        fail(f"int8_forward_bs8: sigm {tuple(sigm.shape)} or non-finite")
    ms = statistics.median(times)
    raw = device_split_ms(torch, forward, reps=5)
    split = {**device_categories(raw), "top": sorted(
        raw.items(), key=lambda kv: -kv[1])[:6]}
    out["forward_bs8"] = {"median_ms": ms, "runs_ms": times,
                          "masks_per_s": B * 1e3 / ms, "device_ms": split,
                          "bf16_forward_ms_phase4": bf16_fwd_ms}
    paths["int8_forward_bs8"] = (counts, N_FWD, ms)
    log(f"[int8_forward_bs8] {card}: CMPC_model 320x320 bs={B} bf16 "
        f"res4_blocks=23, int8 backbone (dynamic): {ms:.3f} ms/batch "
        f"(median of {N_FWD}; all {[round(t, 3) for t in times]}) vs the "
        f"bf16 backbone's {bf16_fwd_ms:.3f} (phase 4); device ms per "
        f"forward {json.dumps(split)}; c5 vs the f32 backbone: relative "
        f"error {rel:.4f} < {INT8_C5_REL}, cosine {cos:.5f} > "
        f"{INT8_C5_COS}")
    del params, feed
    torch.cuda.empty_cache()
    return paths, out


def run_vgg(torch, card):
    """Phase 13b: VGG16-FCN (its init bit-equal by construction to the
    JAX package's) at 320x320 in bf16, bs=1 and bs=8: host-clock ms per
    forward (median of 5 groups of 5) and the shapes; fc8 held against the
    float32 run (TF32 off) on the same input, ||fc8_bf16 - fc8_f32|| /
    ||fc8_f32|| <= VGG_TOL."""
    from cmpc_refseg_torch.convert import vgg16_fcn_from_jax
    from cmpc_refseg_torch.models.vgg16_fcn import (apply_vgg16_fcn,
                                                    init_vgg16_fcn)
    t0 = time.perf_counter()
    params = vgg16_fcn_from_jax(init_vgg16_fcn(0), device=DEV)
    out = {"init_s": time.perf_counter() - t0}
    for bs in (1, B):
        x = torch.as_tensor(50 * np.random.default_rng(bs).standard_normal(
            (bs, H_IMG, H_IMG, 3)).astype(np.float32), device=DEV)

        def forward(dtype=torch.bfloat16):
            with torch.inference_mode():
                return apply_vgg16_fcn(params, x, compute_dtype=dtype)
        got = forward()
        shapes = {k: list(v.shape) for k, v in got.items()
                  if k in ("pool3", "conv5_3", "fc7", "fc8")}
        if shapes["fc8"] != [bs, H_IMG // 8, H_IMG // 8, 1000]:
            fail(f"vgg bs={bs}: shapes {shapes}")
        ms = wall_ms(torch, forward)
        raw = device_split_ms(torch, forward, reps=3)
        split = {**device_categories(raw), "top": sorted(
            raw.items(), key=lambda kv: -kv[1])[:4]}
        ref = forward(None)["fc8"].double()
        fc8 = got["fc8"].double()
        rel = ((fc8 - ref).norm() / ref.norm()).item()
        if not rel <= VGG_TOL:
            fail(f"vgg bs={bs}: fc8 in bf16 vs float32: relative error "
                 f"{rel:.3e} > {VGG_TOL:.3e}")
        out[f"bs{bs}"] = {"ms": ms, "images_per_s": bs * 1e3 / ms,
                          "device_ms": split,
                          "fc8_rel_err": rel,
                          "fc8_max_abs_err": (fc8 - ref).abs().max().item(),
                          "fc8_max_abs": ref.abs().max().item(),
                          "shapes": shapes}
        log(f"[vgg16_fcn_bs{bs}] {card}: 320x320 bs={bs} bf16: {ms:.3f} "
            f"ms per forward ({bs * 1e3 / ms:.1f} images/s; device ms "
            f"{json.dumps(split)}); fc8 vs "
            f"float32 relative error {rel:.3e} <= {VGG_TOL:.3e} ({VGG_CONVS}"
            f" convs x 2 x 2^-9); shapes {json.dumps(shapes)}")
        del x, got, ref, fc8
        torch.cuda.empty_cache()
    return out


def dp_rank(rank, init_file, port, root, argvs, results, release):
    """A data-parallel rank of phase 13 (a spawned process; `dp_tasks`),
    reporting (rank, kind, payload) on `results`, or (rank, 'error',
    traceback) before it exits nonzero."""
    import os
    import traceback
    # deterministic cuBLAS for the one-rank NCCL step's bit-equality check;
    # set before the process makes a cuBLAS handle
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch
    import torch.multiprocessing  # noqa: F401  CUDA tensors through queues
    try:
        dp_tasks(torch, rank, init_file, port, root, argvs, results, release)
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise
    results.put((rank, "done", None))


def dp_tasks(torch, rank, init_file, port, root, argvs, results, release):
    """The ranks' work, two ranks on cuda:0 over gloo: for each of
    DP_CONFIGS, its bs=8 trainer (each rank the same seed, checked), then
    DP_STEPS steps on the halves of DP_STEPS batches.  Before each step,
    the gradients of the DP route (each rank's half of the batch, the
    all-reduced mean) at check_train_routes' draws 1 to NOISE_DRAWS of the
    step's weights; then the timed `Trainer.step`, whose all-reduced
    gradient (an optimizer pre-hook), loss and BN batch statistics are
    draw 0; the ranks' weights and BN statistics bit-equal after each,
    launches counted over the steps alone.  Rank 0 sends each reading and
    the weights after each step on `results` (CUDA tensors, kept until
    `release` is set).  Then `evaluate_sharded` over the group on phase 8's
    batches; `cli.main -m train -distributed` in a group joined from
    torchrun's environment (`argvs[rank]`); and on rank 0 the one-rank
    NCCL step against the step without a group (`nccl_step`)."""
    import os

    import torch.distributed as dist

    from cmpc_refseg_torch import cli
    from cmpc_refseg_torch.api import build_trainer
    from cmpc_refseg_torch.config import get_config
    from cmpc_refseg_torch.models.aspp import BN_DECAY
    from cmpc_refseg_torch.models.model import init_model, init_model_state
    from cmpc_refseg_torch.ops import kernels
    from cmpc_refseg_torch.parallel.mesh import (all_reduce_mean_,
                                                 check_replicated,
                                                 initialize_distributed,
                                                 shard_batch)
    from cmpc_refseg_torch.train.evaluator import evaluate_sharded
    from cmpc_refseg_torch.train.optimizer import named_leaves
    from cmpc_refseg_torch.train.trainer import (compute_gradients,
                                                 reduce_gradients)

    dev = initialize_distributed(f"file://{init_file}", N_DP, rank,
                                 backend="gloo", device=DEV)
    keep = []

    def flat(tensors):
        return torch.cat([t.detach().reshape(-1) for t in tensors])

    def bn_stats(before, after):
        return {"/".join(p): ((a.double() - BN_DECAY * b.double())
                              / (1 - BN_DECAY)).cpu()
                for (p, a), (_, b) in zip(named_leaves(after),
                                          named_leaves(before))}

    def send(kind, payload):
        # rank 0's CUDA tensors stay alive until the parent has copied them
        keep.extend(t for t in payload if torch.is_tensor(t))
        results.put((rank, kind, payload))
    for tag, name in DP_CONFIGS:
        trainer = build_trainer(name, device=dev, dtype="bfloat16",
                                batch_size=B)
        state, cfg = trainer.state, trainer.cfg
        leaves = [leaf for _, leaf in named_leaves(state.trainable)]
        check_replicated(leaves)
        local = [shard_batch(train_batch(cfg, B, i)) for i in range(DP_STEPS)]
        used = []     # the all-reduced gradient each update takes
        state.optimizer.register_step_pre_hook(
            lambda *_: used.append(flat(leaf.grad for leaf in leaves)))
        times, losses, counts = [], [], {}
        for j, batch in enumerate(local):
            # check_train_routes' draws of this step's weights (draw 0 is
            # the step itself, below)
            saved = [leaf.detach().clone() for leaf in leaves]
            for i in range(1, NOISE_DRAWS + 1):
                draw_weights(torch, leaves, saved, i)
                before = state.model_state
                loss, _ = compute_gradients(state, cfg, batch)
                reduce_gradients(state)
                loss = loss.reshape(1).clone()
                all_reduce_mean_([loss])
                grads = flat(leaf.grad for leaf in leaves)
                stats = bn_stats(before, state.model_state)
                state.optimizer.zero_grad(set_to_none=True)
                state.model_state = before
                if rank == 0:
                    send(f"{tag}_reading", (j, i, loss.item(), grads, stats))
            draw_weights(torch, leaves, saved, 0)
            del saved
            before = state.model_state
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            metrics = trainer.step(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            for k, v in kernels.launch_counts().items():
                counts[k] = counts.get(k, 0) + v
            losses.append(float(metrics["loss_total"]))
            check_replicated(leaves + [v for _, v in named_leaves(
                state.model_state)], "weights and BN statistics after a "
                "step")
            if rank == 0:
                send(f"{tag}_reading", (j, 0, losses[-1], used[-1],
                                        bn_stats(before, state.model_state)))
                send(f"{tag}_after", (j, flat(leaves)))
        if rank == 0:
            results.put((rank, f"{tag}_steps", {
                "losses": losses, "times_ms": times, "step": state.step,
                "counts": counts}))
        del trainer, state, leaves, used
        torch.cuda.empty_cache()

    ev_cfg = get_config("CMPC_model", compute_dtype="bfloat16",
                        batch_size=B)
    samples = eval_samples(ev_cfg)
    batches = [{k: np.concatenate([s[k] for s in samples[i:i + B]])
                for k in ("im", "words", "seq_len", "target")}
               for i in range(0, N_EVAL - B + 1, B)]
    params = init_model(0, ev_cfg, device=dev)
    model_state = init_model_state(ev_cfg, device=dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = evaluate_sharded(ev_cfg, params, model_state, iter(batches),
                           mesh=dist.group.WORLD, device=dev)
    msg = {"results": res, "seconds": time.perf_counter() - t0,
           "counts": kernels.launch_counts()}
    if rank == 0:
        # one device over the same rows at the ranks' batch, in this
        # process (the same cuBLAS set-up: bf16 forwards that round
        # otherwise can flip a pixel at the threshold)
        msg["one_device"] = evaluate_sharded(
            ev_cfg, params, model_state, iter(
                {k: v[j:j + B // N_DP] for k, v in b.items()}
                for b in batches for j in range(0, B, B // N_DP)),
            device=dev)
    results.put((rank, "eval", msg))
    del params
    torch.cuda.empty_cache()

    dist.destroy_process_group()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(N_DP), LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    # gloo, so that both ranks can share the card: the command line runs in
    # the group its process has joined
    initialize_distributed(backend="gloo", device=DEV)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    st = cli.main(argvs[rank])
    results.put((rank, "cli", {"step": st.step,
                               "seconds": time.perf_counter() - t0,
                               "counts": kernels.launch_counts()}))
    del st
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    if rank == 0:
        results.put((rank, "nccl", nccl_step(torch, init_file + ".nccl")))
    if not release.wait(timeout=DP_TIMEOUT):
        raise RuntimeError("the parent never took the readings")


def nccl_step(torch, init_file):
    """One flagship bs=8 step from the seed without a process group, again
    (the control: the step is deterministic), then under a one-rank NCCL
    group; the losses and every weight bit-equal to the first, since a
    one-rank all-reduce of the gradients and metrics must change
    nothing.  Then `agree_any` under that group (its host-side gloo
    group)."""
    import torch.distributed as dist

    from cmpc_refseg_torch.api import build_trainer
    from cmpc_refseg_torch.parallel.mesh import (agree_any,
                                                 initialize_distributed)
    from cmpc_refseg_torch.train.optimizer import named_leaves

    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    trainer = build_trainer("CMPC_model", device=DEV, dtype="bfloat16",
                            batch_size=B)
    state = trainer.state
    leaves = [leaf for _, leaf in named_leaves(state.trainable)]
    initial = [leaf.detach().clone() for leaf in leaves]
    batch = train_batch(trainer.cfg, B, 0)

    def step():
        with torch.no_grad():
            for leaf, w in zip(leaves, initial):
                leaf.copy_(w)
        state.optimizer.state.clear()
        state.step = 0
        loss = trainer.step(batch)["loss_total"].clone()
        torch.cuda.synchronize()
        return loss, [leaf.detach().clone() for leaf in leaves]

    def equal(a, b):
        return bool(torch.equal(a[0], b[0])) and all(
            torch.equal(x, y) for x, y in zip(a[1], b[1]))
    first = step()
    control = equal(first, step())
    initialize_distributed(f"file://{init_file}", 1, 0, device=DEV)
    try:
        backend = dist.get_backend()
        grouped = step()
        # the preemption flag, agreed over the gloo group made beside NCCL
        agreed = [agree_any(False), agree_any(True)]
    finally:
        dist.destroy_process_group()
    torch.use_deterministic_algorithms(False)
    return {"backend": backend, "control_equal": control,
            "nccl_equal": equal(first, grouped), "agreed": agreed,
            "loss": first[0].item(), "nccl_loss": grouped[0].item()}


def run_dp(torch, kernels, cmpc, build_trainer, compute_gradients,
           named_leaves, card, train_ms):
    """Phase 13c: data parallelism on the one card, N_DP ranks on cuda:0
    over gloo in spawned processes (`dp_rank`), then the checks here:
    for the flagship and CMPCv4_model at global bs=8, each of the DP_STEPS
    DP steps held against the single process on the same whole batch from
    the weights that DP step started from: its gradients against the
    plain route by check_train_routes' rule (DP as the route under test:
    draw 0 the step's own all-reduced gradient, the other draws read by
    the ranks; CMPCv4_model's BN batch statistics by phase 7's rule), its
    loss against the single process's kernel route within DP_LOSS_TOL,
    and its update: the single process's `Trainer.step` whose optimizer
    takes the DP step's gradient must leave every weight bit-equal to the
    ranks' (a wrong lr, bias correction or moment under DP fails it), so
    each step starts from the ranks' weights.  The ranks bit-equal after
    each step (checked by the ranks), launches held at each rank's
    shapes; `evaluate_sharded` over the ranks equal (overall IoU, prec@X,
    n) to one device over the same rows at the ranks' batch of 4 (bf16
    forwards at another batch round differently, and a pixel at the
    threshold may flip; rank 0 runs it), every rank returning the same;
    the 2-rank `cli.main -m train -distributed` on phase 11's kind of npz
    set: rank 0 alone logs and writes snapshots, its first loss within
    DP_LOSS_TOL of the single-process CLI's; the one-rank NCCL step
    bit-equal to the step without a group.  Step ms: two ranks share one
    card, so they show correctness, not scaling.  A rank that fails or
    outlives DP_TIMEOUT fails the phase."""
    import os
    import queue
    import socket
    import tempfile

    import torch.multiprocessing as mp

    from cmpc_refseg_torch import cli

    paths, out = {}, {}
    ctx = mp.get_context("spawn")
    results, release = ctx.Queue(), ctx.Event()
    with tempfile.TemporaryDirectory() as root, socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
        base = ["-m", "train", "-d", "unc", "-t", "train", "-n",
                "CMPC_model", "-f", root, "-emb_dir", root, "-bs", str(B),
                "-workers", "1", "-st", str(N_DP_CLI), "-s", str(N_DP_CLI),
                "-device", DEV]
        cfg, _ = cli.make_config(cli.build_argparser().parse_args(base),
                                 torch.device(DEV))
        cli_dataset(root, cfg.vocab_size, cfg.glove_dim)

        def dirs(tag):
            return ["-ckpt_dir", os.path.join(root, f"ckpt_{tag}"),
                    "-log_dir", os.path.join(root, f"logs_{tag}")]
        argvs = [base + dirs(f"rank{r}") + ["-distributed", "-mesh",
                                            str(N_DP)]
                 for r in range(N_DP)]
        sock.close()
        t0 = time.perf_counter()
        procs = [ctx.Process(target=dp_rank, args=(
            r, os.path.join(root, "rdzv"), port, root, argvs, results,
            release)) for r in range(N_DP)]
        for p in procs:
            p.start()
        got, deadline = {}, time.perf_counter() + DP_TIMEOUT
        try:
            done = 0
            while done < N_DP:
                try:
                    rank, kind, payload = results.get(
                        timeout=max(1.0, deadline - time.perf_counter()))
                except queue.Empty:
                    fail(f"dp: the ranks did not finish within "
                         f"{DP_TIMEOUT} s (got {sorted(got)})")
                if kind == "error":
                    fail(f"dp: rank {rank} failed:\n{payload}")
                if kind == "done":
                    done += 1
                    continue
                if kind.endswith("_reading"):
                    j, i, loss, flat, stats = payload
                    payload = (j, i, loss, flat.clone(), stats)
                    del flat
                elif kind.endswith("_after"):
                    payload = (payload[0], payload[1].clone())
                got.setdefault(kind, {}).setdefault(rank, []).append(payload)
                if kind == "nccl":
                    # the last thing rank 0 sends: every reading is copied
                    release.set()
        finally:
            release.set()
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.terminate()
        if any(p.exitcode != 0 for p in procs):
            fail(f"dp: rank exit codes {[p.exitcode for p in procs]}")
        ranks_s = time.perf_counter() - t0
        torch.cuda.synchronize()

        for tag, name in DP_CONFIGS:
            path = f"{tag}_train_bs{B // 2}"
            steps = got[f"{tag}_steps"][0][0]
            readings = {(j, i): r for j, i, *r in got.pop(f"{tag}_reading")[0]}
            afters = dict(got.pop(f"{tag}_after")[0])
            trainer = build_trainer(name, device=DEV, dtype="bfloat16",
                                    batch_size=B)
            reference = build_trainer(name, device=DEV, dtype="float32",
                                      batch_size=B)
            tcfg = trainer.cfg
            leaves = [leaf for _, leaf in named_leaves(
                trainer.state.trainable)]
            ref_leaves = [leaf for _, leaf in named_leaves(
                reference.state.trainable)]
            batches = [train_batch(tcfg, B, i) for i in range(DP_STEPS)]
            used = []      # the DP update's gradient, for the replay

            def dp_update(*_):
                k = 0
                with torch.no_grad():
                    for leaf in leaves:
                        leaf.grad.copy_(used[0][k:k + leaf.numel()]
                                        .view_as(leaf))
                        k += leaf.numel()
            trainer.state.optimizer.register_step_pre_hook(dp_update)
            routes, single, replay = [], [], []
            for j, b in enumerate(batches):
                def dp_reading(i, j=j):
                    loss, flat, stats = readings[j, i]
                    grads, k = [], 0
                    for leaf in leaves:
                        grads.append(flat[k:k + leaf.numel()]
                                     .view_as(leaf).double())
                        k += leaf.numel()
                    return loss, grads, {p: v.to(DEV)
                                         for p, v in stats.items()}
                # the f32 reference at this step's weights and brightness
                # draw (the update count)
                with torch.no_grad():
                    for a, r in zip(leaves, ref_leaves):
                        r.copy_(a)
                reference.state.step = trainer.state.step
                routes.append(check_train_routes(
                    torch, trainer, reference, compute_gradients,
                    named_leaves, b, kernel=dp_reading))
                # the single process's step from the same weights on the
                # whole batch, its update made from the DP step's gradient:
                # the weights must come out bit-equal to the ranks'
                used[:] = [readings[j, 0][1]]
                single.append(float(trainer.step(b)["loss_total"]))
                after = torch.cat([leaf.detach().reshape(-1)
                                   for leaf in leaves])
                differ = [p for (p, _), ok in zip(
                    named_leaves(trainer.state.trainable), torch.split(
                        after == afters[j], [x.numel() for x in leaves]))
                    if not bool(ok.all())]
                replay.append(len(differ))
                if differ:
                    fail(f"{path}: step {j + 1}: {len(differ)} leaves of "
                         f"the ranks' weights differ from the single "
                         f"process's update from the same weights with the "
                         f"DP gradient, first {differ[:3]}")
                del after
            del reference, readings, afters, ref_leaves, used
            torch.cuda.empty_cache()
            errs = [abs(a - b) / abs(b) for a, b in zip(steps["losses"],
                                                        single)]
            if not max(errs) <= DP_LOSS_TOL or steps["step"] != DP_STEPS:
                fail(f"{path}: DP losses {steps['losses']} vs the single "
                     f"process's from the same weights {single}: relative "
                     f"{errs} (<= {DP_LOSS_TOL}), step {steps['step']}")
            check_counts(steps["counts"], config_launches(
                cmpc, tcfg, B // 2, train=True), DP_STEPS, path)
            ms = statistics.median(steps["times_ms"])
            paths[path] = (steps["counts"], DP_STEPS, ms)
            out[path] = {"routes": routes, "dp_losses": steps["losses"],
                         "single_losses": single, "loss_rel_errs": errs,
                         "replay_leaves_differing": replay,
                         "step_ms": steps["times_ms"]}
            for j, r in enumerate(routes):
                log(f"[{path}] step {j + 1}: DP gradients vs the single "
                    f"process's plain route: loss relative "
                    f"{r['loss_rel_err']:.3e}, worst resolved leaf "
                    f"{r['worst_resolved_grad_rel_err']:.3e} "
                    f"({r['worst_resolved_grad_leaf']}), leaf counts "
                    f"{r['counts']}, BN statistics "
                    f"{r['bn_stats_rel_err_max']}")
            log(f"[{path}] {card}: {name} 320x320 global bs={B} over {N_DP} "
                f"ranks on one card (gloo), bf16 res4_blocks=23: "
                f"{DP_STEPS} steps, each step's gradients by "
                f"check_train_routes' rule (above), losses "
                f"{steps['losses']} vs the single process's from each "
                f"step's weights {single} (relative <= {max(errs):.3e} <= "
                f"{DP_LOSS_TOL}), the single process's update from the DP "
                f"gradient bit-equal to the ranks' weights after every "
                f"step, the ranks' weights and BN statistics bit-equal "
                f"after each; rank step ms "
                f"{[round(t, 3) for t in steps['times_ms']]}"
                f" (two ranks share one card: not scaling; phase 6's "
                f"single-process bs={B} step {train_ms:.3f})")
            del trainer, leaves
            torch.cuda.empty_cache()

        # sharded evaluation against one device over the same rows
        evals = [got["eval"][r][0] for r in range(N_DP)]
        if any(e["results"] != evals[0]["results"] for e in evals):
            fail(f"dp_eval: the ranks returned different results "
                 f"{[e['results'] for e in evals]}")
        one = evals[0]["one_device"]
        sharded = evals[0]["results"]
        batches = (N_EVAL - B) // B + 1
        exact = ["overall_iou", "n"] + [k for k in one
                                        if k.startswith("prec@")]
        if any(sharded[k] != one[k] for k in exact) or \
                not abs(sharded["mean_iou"] - one["mean_iou"]) <= 1e-6:
            fail(f"dp_eval: sharded {sharded} vs one device {one}")
        check_counts(evals[0]["counts"], expected_launches(cmpc, B // 2),
                     batches, f"dp_eval_bs{B // 2}")
        paths[f"dp_eval_bs{B // 2}"] = (evals[0]["counts"], batches,
                                        evals[0]["seconds"] * 1e3 / batches)
        out["eval"] = {"sharded": sharded, "one_device_bs4": one,
                       "seconds": evals[0]["seconds"]}
        log(f"[dp_eval_bs{B // 2}] {card}: evaluate_sharded over {N_DP} "
            f"ranks of {batches * B} samples: {json.dumps(sharded)}"
            f"; equal to one device over the same rows at bs={B // 2} "
            f"(overall IoU, prec@X, n; mean IoU within 1e-6)")

        # the 2-rank command line
        clis = [got["cli"][r][0] for r in range(N_DP)]
        logs0 = os.path.join(root, "logs_rank0", "metrics.jsonl")
        written = [os.path.exists(os.path.join(root, f"{d}_rank1"))
                   for d in ("ckpt", "logs")]
        if [c["step"] for c in clis] != [N_DP_CLI] * N_DP or any(written) \
                or not os.path.exists(os.path.join(root, "ckpt_rank0",
                                                   str(N_DP_CLI))) \
                or not os.path.exists(logs0):
            fail(f"dp_cli: steps {[c['step'] for c in clis]}; rank 1 "
                 f"wrote (ckpt, logs) {written}; rank 0's snapshot and log")
        kernels.reset_launch_counts()
        run_cli(cli.main, base + dirs("single") + ["-st", "1"])
        with open(logs0) as f:
            dp_loss = json.loads(f.readline())["loss_total"]
        with open(os.path.join(root, "logs_single", "metrics.jsonl")) as f:
            one_loss = json.loads(f.readline())["loss_total"]
        cli_err = abs(dp_loss - one_loss) / abs(one_loss)
        if not cli_err <= DP_LOSS_TOL:
            fail(f"dp_cli: rank 0's first loss {dp_loss} vs the single "
                 f"process's {one_loss}: relative {cli_err:.3e}")
        check_counts(clis[0]["counts"], expected_launches(
            cmpc, B // 2, train=True), N_DP_CLI, f"cli_dp_train_bs{B // 2}")
        paths[f"cli_dp_train_bs{B // 2}"] = (
            clis[0]["counts"], N_DP_CLI,
            clis[0]["seconds"] * 1e3 / N_DP_CLI)
        out["cli"] = {"first_loss": dp_loss, "single_first_loss": one_loss,
                      "rel_err": cli_err, "seconds": clis[0]["seconds"]}
        log(f"[cli_dp] {card}: cli.main -m train -distributed, {N_DP} ranks "
            f"(torchrun's environment, gloo on one card), {N_DP_CLI} steps "
            f"at global bs={B}: rank 0 alone wrote logs and snapshots; its "
            f"first loss {dp_loss!r} vs the single-process CLI's "
            f"{one_loss!r} (relative {cli_err:.3e} <= {DP_LOSS_TOL}); "
            f"{clis[0]['seconds']:.1f} s for the run")

    nccl = got["nccl"][0][0]
    if not (nccl["control_equal"] and nccl["nccl_equal"]
            and nccl["backend"] == "nccl"
            and nccl["agreed"] == [False, True]):
        fail(f"dp_nccl: the one-rank NCCL step vs the step without a "
             f"group: {nccl}")
    out["nccl"] = nccl
    out["ranks_s"] = ranks_s
    log(f"[dp_nccl] {card}: CMPC_model bs={B} step under a one-rank "
        f"{nccl['backend']} group bit-equal to the step without one "
        f"(loss {nccl['loss']!r}; two steps without a group bit-equal too); "
        f"agree_any over its host-side gloo group {nccl['agreed']}; "
        f"the ranks' work took {ranks_s:.1f} s")
    return paths, out


def tp_rank(rank, init_file, root, results, release):
    """A rank of phase 14 (a spawned process; `tp_tasks`), reporting
    (rank, kind, payload) on `results`, or (rank, 'error', traceback)
    before it exits nonzero."""
    import traceback

    import torch
    import torch.multiprocessing  # noqa: F401  CUDA tensors through queues
    try:
        tp_tasks(torch, rank, init_file, root, results, release)
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise
    results.put((rank, "done", None))


def tp_tasks(torch, rank, init_file, root, results, release):
    """The ranks' work, N_TP ranks on cuda:0 over gloo laid out as
    TP_SHAPE: the flagship's bs=8 trainer under the layout (the 2 ranks
    of each model index holding bit-equal shards, checked, and after
    every step), then TP_STEPS steps, each rank on its data slot's rows.
    Before each step, the reduced gradient (reduce-scattered over the
    world as a mean, gathered) at check_train_routes' draws 1 to
    NOISE_DRAWS of the step's full weights, with the world's mean loss;
    then the timed `Trainer.step`, whose reduced gradient (taken by an
    optimizer pre-hook on the segment and gathered) and loss are draw 0.
    After each step the consolidated weights and moments; launches
    counted over the steps alone; each rank's bytes.  Rank 0 sends the
    readings and states (CUDA tensors, kept until `release` is set).
    Then a consolidated checkpoint under `root` (rank 0 writes)."""
    import torch.distributed as dist

    from cmpc_refseg_torch.api import build_trainer
    from cmpc_refseg_torch.ops import kernels
    from cmpc_refseg_torch.parallel.mesh import (all_gather_flat,
                                                 all_reduce_mean_,
                                                 check_replicated,
                                                 initialize_distributed,
                                                 make_mesh,
                                                 reduce_scatter_mean,
                                                 shard_batch)
    from cmpc_refseg_torch.train.checkpoint import save_checkpoint
    from cmpc_refseg_torch.train.optimizer import named_leaves
    from cmpc_refseg_torch.train.trainer import compute_gradients

    dev = initialize_distributed(f"file://{init_file}", N_TP, rank,
                                 backend="gloo", device=DEV)
    mesh = make_mesh(TP_SHAPE)
    keep = []

    def send(kind, payload):
        # rank 0's CUDA tensors stay alive until the parent has copied them
        keep.extend(t for t in payload if torch.is_tensor(t))
        results.put((rank, kind, payload))
    trainer = build_trainer("CMPC_model", device=dev, dtype="bfloat16",
                            batch_size=B, mesh=mesh)
    state, cfg = trainer.state, trainer.cfg
    zero = state.zero

    def stored():
        return [leaf for _, leaf in named_leaves(state.trainable)]
    check_replicated(stored(), "shards", group=mesh.data)
    engaged = [i for i, d in enumerate(zero.dims) if d is not None]
    local = [shard_batch(train_batch(cfg, B, i), mesh)
             for i in range(TP_STEPS)]
    segments = []
    state.optimizer.register_step_pre_hook(
        lambda *_: segments.append(zero.master.grad.clone()))
    # host ms of the step's two collective stages: the gather of the
    # engaged leaves before the forward, and the update (reduce-scatter,
    # Adam on the segment, all-gather, write-back)
    split = {"gather": [], "update": []}

    def timed(name):
        fn = getattr(zero, name)

        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            split[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return run
    times, losses, counts = [], [], {}
    for j, batch in enumerate(local):
        full = [leaf for _, leaf in named_leaves(
            zero.gather(state.trainable, requires_grad=False))]
        saved = [leaf.detach().clone() for leaf in full]
        for i in range(1, NOISE_DRAWS + 1):
            # the step's full weights times this draw, stored back as the
            # rank's shards
            draw_weights(torch, full, saved, i)
            zero.write_back(state.trainable, zero.flatten(full))
            tree = zero.gather(state.trainable)
            loss, _ = compute_gradients(state, cfg, batch, trainable=tree)
            grads = [leaf.grad for _, leaf in named_leaves(tree)]
            reduced = all_gather_flat(reduce_scatter_mean(
                zero.flatten(grads)))[:zero.numel]
            loss = loss.reshape(1).clone()
            all_reduce_mean_([loss])
            if rank == 0:
                send("tp_reading", (j, i, loss.item(), reduced, {}))
            del reduced, grads, tree
        draw_weights(torch, full, saved, 0)
        zero.write_back(state.trainable, zero.flatten(full))
        del full, saved
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        zero.gather, zero.update = timed("gather"), timed("update")
        t0 = time.perf_counter()
        metrics = trainer.step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        del zero.gather, zero.update
        for k, v in kernels.launch_counts().items():
            counts[k] = counts.get(k, 0) + v
        losses.append(float(metrics["loss_total"]))
        check_replicated(stored(), "shards after a step", group=mesh.data)
        reduced = all_gather_flat(segments[-1])[:zero.numel]
        whole = zero.consolidate()      # rank 0's alone
        if rank == 0:
            weights, mu, nu = (zero.flatten(t)[:zero.numel]
                               for t in whole[:3])
            send("tp_reading", (j, 0, losses[-1], reduced, {}))
            send("tp_after", (j, weights, mu, nu, whole[3]))
            del weights, mu, nu
        del reduced, whole
    adam = state.optimizer.state[zero.master]
    mb = {"adam_moments": sum(adam[k].numel() * adam[k].element_size()
                              for k in ("exp_avg", "exp_avg_sq")) / 1e6,
          "master_segment": zero.master.numel()
          * zero.master.element_size() / 1e6,
          "engaged_storage": sum(stored()[i].numel() * 4
                                 for i in engaged) / 1e6,
          "engaged_full": sum(math.prod(zero.shapes[i]) * 4
                              for i in engaged) / 1e6,
          "stored_total": sum(t.numel() * 4 for t in stored()) / 1e6}
    save_checkpoint(root, state, state.step)
    results.put((rank, "tp_steps", {
        "losses": losses, "times_ms": times, "split_ms": split,
        "step": state.step, "counts": counts, "mb": mb,
        "engaged": len(engaged),
        "segment": zero.segment, "numel": zero.numel,
        "groups": {"data": dist.get_process_group_ranks(mesh.data),
                   "model": dist.get_process_group_ranks(mesh.model)}}))
    del trainer, state, zero
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    if not release.wait(timeout=DP_TIMEOUT):
        raise RuntimeError("the parent never took the readings")


def run_tp(torch, kernels, cmpc, build_trainer, compute_gradients,
           named_leaves, card, train_ms):
    """Phase 14: tensor parallelism and ZeRO on the one card, N_TP ranks on
    cuda:0 over gloo in spawned processes (`tp_rank`), then the checks
    here: for the flagship at global bs=8, each of the TP_STEPS steps held
    against the single process on the same whole batch from the weights
    that step started from: its reduced gradient against the plain route
    by check_train_routes' rule (the layout as the route under test: draw
    0 the step's own gradient, the other draws read by the ranks), its
    loss against the single process's kernel route within DP_LOSS_TOL,
    and its update: the single process's `Trainer.step` whose optimizer
    takes the ranks' gradient must leave every weight and both of Adam's
    moments bit-equal to the ranks' consolidated state (a wrong segment,
    shard, lr or moment fails it), so each step starts from the ranks'
    weights.  Each rank's bytes against TP_WANT_MB (exactly the layout's
    sizes: the segment pads nothing, 76,055,608 dividing by 4); launches
    held at each rank's shapes; the consolidated checkpoint restored
    into a single-process trainer, every leaf bit-equal to the ranks'
    last state.  Step ms: four ranks share one card, so they show
    correctness, not scaling.  A rank that fails or outlives DP_TIMEOUT
    fails the phase."""
    import os
    import queue
    import tempfile

    import torch.multiprocessing as mp

    from cmpc_refseg_torch.train.checkpoint import restore_checkpoint

    path = f"tp_train_bs{B // 2}"
    ctx = mp.get_context("spawn")
    results, release = ctx.Queue(), ctx.Event()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        procs = [ctx.Process(target=tp_rank, args=(
            r, os.path.join(root, "rdzv"), os.path.join(root, "ckpt"),
            results, release)) for r in range(N_TP)]
        for p in procs:
            p.start()
        got, deadline = {}, time.perf_counter() + DP_TIMEOUT
        try:
            done = 0
            while done < N_TP:
                try:
                    rank, kind, payload = results.get(
                        timeout=max(1.0, deadline - time.perf_counter()))
                except queue.Empty:
                    fail(f"tp: the ranks did not finish within "
                         f"{DP_TIMEOUT} s (got {sorted(got)})")
                if kind == "error":
                    fail(f"tp: rank {rank} failed:\n{payload}")
                if kind == "done":
                    done += 1
                    continue
                if kind in ("tp_reading", "tp_after"):
                    payload = tuple(t.clone() if torch.is_tensor(t) else t
                                    for t in payload)
                got.setdefault(kind, {}).setdefault(rank, []).append(payload)
                if len(got.get("tp_steps", {})) == N_TP:
                    # every rank has sent all: every reading is copied
                    release.set()
        finally:
            release.set()
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.terminate()
        if any(p.exitcode != 0 for p in procs):
            fail(f"tp: rank exit codes {[p.exitcode for p in procs]}")
        ranks_s = time.perf_counter() - t0
        torch.cuda.synchronize()

        steps = [got["tp_steps"][r][0] for r in range(N_TP)]
        readings = {(j, i): r for j, i, *r in got.pop("tp_reading")[0]}
        afters = {j: r for j, *r in got.pop("tp_after")[0]}
        trainer = build_trainer("CMPC_model", device=DEV, dtype="bfloat16",
                                batch_size=B)
        reference = build_trainer("CMPC_model", device=DEV, dtype="float32",
                                  batch_size=B)
        tcfg = trainer.cfg
        leaves = [leaf for _, leaf in named_leaves(trainer.state.trainable)]
        ref_leaves = [leaf for _, leaf in named_leaves(
            reference.state.trainable)]
        sizes = [leaf.numel() for leaf in leaves]
        batches = [train_batch(tcfg, B, i) for i in range(TP_STEPS)]
        used = []      # the ranks' gradient, for the replay

        def tp_update(*_):
            with torch.no_grad():
                for leaf, g in zip(leaves, torch.split(used[0], sizes)):
                    leaf.grad.copy_(g.view_as(leaf))
        trainer.state.optimizer.register_step_pre_hook(tp_update)
        routes, single, replay = [], [], []
        for j, b in enumerate(batches):
            def tp_reading(i, j=j):
                loss, flat, stats = readings[j, i]
                return loss, [g.view_as(leaf).double() for leaf, g in
                              zip(leaves, torch.split(flat, sizes))], stats
            with torch.no_grad():
                for a, r in zip(leaves, ref_leaves):
                    r.copy_(a)
            reference.state.step = trainer.state.step
            routes.append(check_train_routes(
                torch, trainer, reference, compute_gradients, named_leaves,
                b, kernel=tp_reading))
            used[:] = [readings[j, 0][1]]
            single.append(float(trainer.step(b)["loss_total"]))
            weights, mu, nu, count = afters[j]
            adam = [trainer.state.optimizer.state[leaf] for leaf in leaves]
            differ = {}
            for what, want in (("weights", weights), ("exp_avg", mu),
                               ("exp_avg_sq", nu)):
                mine = leaves if what == "weights" else \
                    [st[what] for st in adam]
                differ[what] = [p for (p, _), a, w in zip(
                    named_leaves(trainer.state.trainable), mine,
                    torch.split(want, sizes))
                    if not torch.equal(a.detach().reshape(-1), w)]
            counts_equal = all(float(st["step"]) == count == j + 1
                               for st in adam)
            replay.append({k: len(v) for k, v in differ.items()})
            if any(differ.values()) or not counts_equal:
                fail(f"{path}: step {j + 1}: the single process's Adam fed "
                     f"the ranks' gradient differs from their consolidated "
                     f"state: {[(k, v[:3]) for k, v in differ.items()]}, "
                     f"Adam's counts equal {counts_equal}")
        del readings, ref_leaves, used, reference
        torch.cuda.empty_cache()
        errs = [abs(a - b) / abs(b) for a, b in zip(steps[0]["losses"],
                                                    single)]
        if not max(errs) <= DP_LOSS_TOL or steps[0]["step"] != TP_STEPS \
                or any(s["losses"] != steps[0]["losses"] for s in steps):
            fail(f"{path}: TP losses {[s['losses'] for s in steps]} vs the "
                 f"single process's from the same weights {single}: "
                 f"relative {errs} (<= {DP_LOSS_TOL}), step "
                 f"{steps[0]['step']}")
        for r, s in enumerate(steps):
            m = TP_SHAPE[1]
            want_groups = {"data": list(range(r % m, N_TP, m)),
                           "model": list(range(r - r % m, r - r % m + m))}
            if s["engaged"] != TP_ENGAGED or s["groups"] != want_groups or any(
                    abs(s["mb"][k] - v) > 1e-9 for k, v in
                    TP_WANT_MB.items()):
                fail(f"{path}: rank {r}: {s['engaged']} engaged leaves, "
                     f"groups {s['groups']} (want {want_groups}), MB "
                     f"{s['mb']} (want {TP_WANT_MB})")
            check_counts(s["counts"], config_launches(
                cmpc, tcfg, B // 2, train=True), TP_STEPS, f"{path} rank {r}")

        # the consolidated checkpoint in one process
        restored = build_trainer("CMPC_model", device=DEV, dtype="bfloat16",
                                 batch_size=B)
        restore_checkpoint(os.path.join(root, "ckpt"), restored.state)
        weights, mu, nu, count = afters[TP_STEPS - 1]
        r_leaves = [leaf for _, leaf in named_leaves(
            restored.state.trainable)]
        r_adam = [restored.state.optimizer.state[leaf] for leaf in r_leaves]
        ckpt_differ = [
            (what, p) for what, mine, want in (
                ("weights", r_leaves, weights),
                ("exp_avg", [st["exp_avg"] for st in r_adam], mu),
                ("exp_avg_sq", [st["exp_avg_sq"] for st in r_adam], nu))
            for (p, _), a, w in zip(named_leaves(restored.state.trainable),
                                    mine, torch.split(want, sizes))
            if not torch.equal(a.detach().reshape(-1), w)]
        ckpt_differ += [("frozen", p) for (p, a), (_, w) in zip(
            named_leaves(restored.state.frozen_f32),
            named_leaves(trainer.state.frozen_f32)) if not torch.equal(a, w)]
        if ckpt_differ or restored.state.step != TP_STEPS or any(
                float(st["step"]) != count for st in r_adam):
            fail(f"{path}: the consolidated checkpoint restored in one "
                 f"process differs: {ckpt_differ[:4]}, step "
                 f"{restored.state.step}")
        del restored, r_leaves, r_adam, afters, trainer, leaves
        torch.cuda.empty_cache()

    ms = statistics.median(steps[0]["times_ms"])
    out = {"routes": routes, "tp_losses": steps[0]["losses"],
           "single_losses": single, "loss_rel_errs": errs,
           "replay_leaves_differing": replay,
           "rank_step_ms": [s["times_ms"] for s in steps],
           "rank_split_ms": [s["split_ms"] for s in steps],
           "mb_per_rank": [s["mb"] for s in steps], "mb_want": TP_WANT_MB,
           "segment": steps[0]["segment"], "numel": steps[0]["numel"],
           "checkpoint_leaves_equal": len(sizes), "ranks_s": ranks_s}
    for j, r in enumerate(routes):
        log(f"[{path}] step {j + 1}: the layout's reduced gradient vs the "
            f"single process's plain route: loss relative "
            f"{r['loss_rel_err']:.3e}, worst resolved leaf "
            f"{r['worst_resolved_grad_rel_err']:.3e} "
            f"({r['worst_resolved_grad_leaf']}), leaf counts {r['counts']}")
    log(f"[{path}] {card}: CMPC_model 320x320 global bs={B} over {N_TP} "
        f"ranks on one card (gloo) as data x model = {TP_SHAPE}, bf16 "
        f"res4_blocks=23, min_dim 512 ({steps[0]['engaged']} "
        f"leaves split): {TP_STEPS} steps, each step's gradient by "
        f"check_train_routes' rule (above), losses {steps[0]['losses']} vs "
        f"the single process's from each step's weights {single} "
        f"(relative <= {max(errs):.3e} <= {DP_LOSS_TOL}), the single "
        f"process's Adam fed the ranks' gradient bit-equal to their "
        f"consolidated weights and moments after every step, the ranks of "
        f"each model index holding bit-equal shards; MB per rank "
        f"{json.dumps(steps[0]['mb'])} (want {json.dumps(TP_WANT_MB)}); "
        f"rank step ms {[[round(t, 3) for t in s['times_ms']] for s in steps]}"
        f", of which the gather of the engaged leaves "
        f"{[[round(t, 3) for t in s['split_ms']['gather']] for s in steps]}"
        f" and the update (reduce-scatter, Adam, all-gather, write-back) "
        f"{[[round(t, 3) for t in s['split_ms']['update']] for s in steps]}"
        f" (four ranks share one card: not scaling; phase 6's "
        f"single-process bs={B} step {train_ms:.3f}); the consolidated "
        f"checkpoint restored in one process bit-equal in all "
        f"{len(sizes)} leaves, both moments and the frozen backbone; the "
        f"ranks' work took {ranks_s:.1f} s")
    return {path: (steps[0]["counts"], TP_STEPS, ms)}, out


def voc_dataset(root, n, seed):
    """n fabricated VOC-style pairs under `root`, of VOC_SIZES in turn:
    JPEG images (smooth content, quality 90) and palette PNG labels (the VOC
    colormap) of 1-3 class boxes, each inside a 5-pixel band of 255 (VOC's
    void boundary); returns the list's lines."""
    import os

    import cv2
    from PIL import Image

    from cmpc_refseg_torch.tools.voc import make_voc_colormap
    rng = np.random.default_rng(seed)
    palette = make_voc_colormap().reshape(-1).tolist()
    lines = []
    for i in range(n):
        h, w = VOC_SIZES[i % len(VOC_SIZES)]
        small = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3), np.uint8)
        im = cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)
        lb = np.zeros((h, w), np.uint8)
        for _ in range(int(rng.integers(1, 4))):
            bh, bw = rng.integers(h // 6, h // 2), rng.integers(w // 6, w // 2)
            y, x = rng.integers(0, h - bh), rng.integers(0, w - bw)
            lb[y:y + bh, x:x + bw] = 255
            lb[y + 5:y + bh - 5, x + 5:x + bw - 5] = rng.integers(
                1, VOC_CLASSES)
        cv2.imwrite(os.path.join(root, f"im{i}.jpg"), im,
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
        label = Image.fromarray(lb, mode="P")
        label.putpalette(palette)
        label.save(os.path.join(root, f"lb{i}.png"))
        lines.append(f"im{i}.jpg lb{i}.png")
    return lines


def voc_calibrated_weights(torch, pb, root, lines, path):
    """Seeded weights with a trained backbone's activation scale, saved as a
    snapshot at `path`: every conv unit's folded BN set from its output's
    per-channel mean and variance over VOC_BS fabricated crops (scale
    1 / sqrt(var + 1e-3), offset -mean * scale: `fold_bn` of the data's
    statistics, unit by unit in forward order), and the head scaled to
    logits of unit deviation.  From the seed's identity BN the residual
    stream grows through ResNet-101's 33 blocks and the CE starts at ~21
    (ln 21 = 3.04); calibrated, the pre-activations have a trained net's
    scale, which the bf16 gradient check reads its rounding against."""
    import os

    from cmpc_refseg_torch.models import backbone as bb
    from cmpc_refseg_torch.ops.layers import conv2d_nchw
    from cmpc_refseg_torch.tools.voc import augment_pair, load_pair
    rng = np.random.default_rng(0)
    ims = []
    for line in lines[:VOC_BS]:
        im, lb = load_pair(*(os.path.join(root, p) for p in line.split()))
        ims.append(augment_pair(rng, im, lb, VOC_CROP, VOC_CROP,
                                scale=False, mirror=False)[0])
    params = pb.params_to_torch(pb.init_numpy(0, RES4, VOC_CLASSES),
                                device=DEV)
    real = bb._conv_bn

    def calibrating(unit, x, *, stride=1, dilation=1, **kw):
        y = conv2d_nchw(x, unit["w"], stride=stride, dilation=dilation)
        var, mean = torch.var_mean(y, dim=(0, 2, 3))
        unit["scale"].copy_(torch.rsqrt(var + 1e-3))
        unit["offset"].copy_(-mean * unit["scale"])
        return real(unit, x, stride=stride, dilation=dilation, **kw)
    bb._conv_bn = calibrating
    try:
        with torch.no_grad():
            c5 = bb.apply_backbone(params["backbone"], torch.as_tensor(
                np.stack(ims), device=DEV), taps=("c5",),
                res4_blocks=RES4)["c5"]
            std = pb.apply_voc_head(params["head"], c5).std()
            for unit in params["head"].values():
                unit["w"].div_(std)
    finally:
        bb._conv_bn = real
    pb.save_params(os.path.dirname(path), 0, params)
    os.replace(os.path.join(os.path.dirname(path), "model_step0.npz"), path)
    return {"c5_std": c5.std().item(), "logit_std_before": std.item()}


@contextlib.contextmanager
def timed_voc_steps(torch, pb):
    """For the enclosed runs, `VocTrainer.step` is wrapped: each step ends
    in a synchronize and records its device-synchronous ms; the first
    step's batch is kept."""
    real = pb.VocTrainer.step
    rec = {"ms": [], "batch": None}

    def step(self, im, labels):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(self, im, labels)
        torch.cuda.synchronize()
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        if rec["batch"] is None:
            rec["batch"] = (im.clone(), labels.clone())
        return out
    pb.VocTrainer.step = step
    try:
        yield rec
    finally:
        pb.VocTrainer.step = real


def voc_train_run(torch, pb, argv, n_steps, what):
    """`pb.run_train` of `argv` for 1 + n_steps steps on the card (the
    first a warm-up): its per-step losses, the steps' ms (the timed ones'
    median and range), images/s, the loop's ms per step (host laps, the
    data loading included), peak GB and the first batch."""
    args = pb.build_argparser().parse_args(
        list(argv) + ["--num-steps", str(1 + n_steps)])
    losses, laps = [], []

    def on_step(it, trainer, loss, ce):
        losses.append(float(loss))
        laps.append(time.perf_counter())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with timed_voc_steps(torch, pb) as rec:
        pb.run_train(args, on_step=on_step)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    if len(losses) != 1 + n_steps or not all(map(math.isfinite, losses)):
        fail(f"voc {what}: losses {losses}")
    ms = rec["ms"][1:]
    out = {"median_ms": statistics.median(ms), "min_ms": min(ms),
           "max_ms": max(ms),
           "images_per_s": args.batch_size * 1e3 / statistics.median(ms),
           "loop_ms": statistics.median(
               (b - a) * 1e3 for a, b in zip(laps[1:], laps[2:])),
           "peak_gb": peak, "losses": losses}
    log(f"[voc] {what}: {out['median_ms']:.3f} ms/step (steps 2-"
        f"{1 + n_steps}: {min(ms):.3f}-{max(ms):.3f}), "
        f"{out['images_per_s']:.1f} images/s, the loop {out['loop_ms']:.3f}"
        f" ms/step with the data, peak {peak:.2f} GB, losses {losses}")
    return out, rec["batch"]


def voc_grad_check(torch, pb, argv, batch):
    """The bf16 step against the f32 one from the same weights and batch:
    the loss within VOC_LOSS_TOL relative; each trainable leaf's gradient
    read at the weights and at NOISE_DRAWS draws of them times (1 +
    VOC_DRAW_EPS N(0, 1)), the same for both: the median of ||g_bf16 -
    g_32|| within VOC_NOISE_FACTOR x the median of ||g_32(draw) -
    g_32(weights)||, and at the weights ||g_bf16|| within half and twice
    ||g_32|| > 0.  Then two bf16 SGD steps, and the second replayed from
    the weights and momentum before it with the step's own gradients:
    m' = 0.9 m + g, w' = w - lr (1 - count / num_steps)^power x mult m',
    bit-equal to the step's weights and momentum."""
    args = pb.build_argparser().parse_args(list(argv) + ["--num-steps",
                                                         "1000"])
    dev = torch.device(DEV)
    params = pb.init_params(args, dev)
    cfg = pb.train_config(args)
    bf16 = pb.VocTrainer(params, {**cfg, "compute_dtype": torch.bfloat16})
    f32 = pb.VocTrainer(pb.init_params(args, dev),
                        {**cfg, "compute_dtype": None})
    leaves = [leaf for _, leaf in bf16.named]
    twins = [leaf for _, leaf in f32.named]
    saved = [leaf.detach().clone() for leaf in leaves]
    im, labels = batch

    def draw(i):
        with torch.no_grad():
            gen = torch.Generator(device=DEV).manual_seed(i)
            for a, b, old in zip(leaves, twins, saved):
                a.copy_(old)
                if i:
                    a.mul_(1 + VOC_DRAW_EPS * torch.randn(
                        a.shape, generator=gen, device=DEV))
                b.copy_(a)

    def grads(trainer):
        for leaf in (leaf for _, leaf in trainer.named):
            leaf.grad = None
        loss, _ = trainer.loss(im, labels)
        loss.backward()
        return loss.item(), [leaf.grad.double() for _, leaf in trainer.named]

    errs, noise, losses = [], [], []
    try:
        for i in range(NOISE_DRAWS + 1):
            draw(i)
            lb, gb = grads(bf16)
            lf, gf = grads(f32)
            if i == 0:
                g0, norms = gf, [(a.norm().item(), b.norm().item())
                                 for a, b in zip(gb, gf)]
            else:
                noise.append([(a - b).norm().item() for a, b in zip(gf, g0)])
            losses.append((lb, lf))
            errs.append([(a - b).norm().item() for a, b in zip(gb, gf)])
    finally:
        draw(0)
    names = ["/".join(p) for p, _ in bf16.named]
    rows = []
    for j, name in enumerate(names):
        err = statistics.median(e[j] for e in errs)
        nz = statistics.median(n[j] for n in noise)
        nb, nf = norms[j]
        rows.append({"leaf": name, "err": err / nf, "noise": nz / nf,
                     "ratio": err / max(nz, 1e-30),
                     "ok": nf > 0 and 0.5 <= nb / nf <= 2
                     and err <= VOC_NOISE_FACTOR * nz})
    loss_err = abs(losses[0][0] - losses[0][1]) / abs(losses[0][1])
    worst = max(rows, key=lambda r: r["ratio"])
    by = {r["leaf"]: r for r in rows}
    log(f"[voc] bf16 vs f32 gradients of {len(rows)} leaves, medians over "
        f"the weights and {NOISE_DRAWS} draws x (1 + 2^-9 N(0, 1)), over "
        f"||g_32||: conv1 {by['backbone/conv1/w']['err']:.3e} (f32's own "
        f"response {by['backbone/conv1/w']['noise']:.3e}), res5c/branch2c "
        f"{by['backbone/res5c/branch2c/w']['err']:.3e} "
        f"({by['backbone/res5c/branch2c/w']['noise']:.3e}), head/c0/w "
        f"{by['head/c0/w']['err']:.3e} ({by['head/c0/w']['noise']:.3e}); "
        f"largest ratio {worst['ratio']:.3f} ({worst['leaf']}, bound "
        f"{VOC_NOISE_FACTOR}); loss bf16 {losses[0][0]!r} vs f32 "
        f"{losses[0][1]!r} (relative {loss_err:.3e})")
    if not loss_err <= VOC_LOSS_TOL:
        fail(f"voc: the bf16 loss {losses[0][0]!r} vs f32 {losses[0][1]!r}: "
             f"relative {loss_err:.3e} > {VOC_LOSS_TOL}")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"voc: bf16 gradients of {len(bad)} leaves beyond "
             f"{VOC_NOISE_FACTOR}x the f32 response, first {bad[0]}")
    # the replay of a second step
    bf16.step(im, labels)
    mom = [bf16.optimizer.state[leaf]["momentum_buffer"].clone()
           for leaf in leaves]
    before = [leaf.detach().clone() for leaf in leaves]
    count = bf16.count
    bf16.step(im, labels)
    lr = cfg["lr"] * (1.0 - count / cfg["num_steps"]) ** cfg["power"]
    bad = []
    for (path, leaf), w, m in zip(bf16.named, before, mom):
        m2 = m.mul(cfg["momentum"]).add_(leaf.grad)
        want = w.add(m2, alpha=-lr * pb.lr_mult(path))
        if not (torch.equal(want, leaf.detach()) and torch.equal(
                m2, bf16.optimizer.state[leaf]["momentum_buffer"])):
            bad.append("/".join(path))
    if bad:
        fail(f"voc: the replayed SGD update differs from the step's in "
             f"{len(bad)} leaves, first {bad[0]}")
    out = {"leaves": len(rows), "largest_ratio": worst["ratio"],
           "largest_ratio_leaf": worst["leaf"],
           "err_conv1": by["backbone/conv1/w"]["err"],
           "noise_conv1": by["backbone/conv1/w"]["noise"],
           "err_worst": max(r["err"] for r in rows),
           "err_head_worst": max(r["err"] for r in rows
                                 if r["leaf"].startswith("head")),
           "bf16_vs_f32_loss_rel": loss_err, "replay_bit_equal": True}
    del bf16, f32, params
    return out


def voc_eval_check(torch, pb, argv, msc):
    """`--mode eval` over the VOC_SIZES images, single-scale or msc: ms per
    image (host laps, decode and padding included) and the confusion
    matrix counted on the card against one recomputed on the host from the
    same argmax and labels."""
    preds, laps = [], []

    def on_pred(i, pred, gt):
        torch.cuda.synchronize()
        laps.append(time.perf_counter())
        preds.append((pred.cpu().numpy(), gt.cpu().numpy()))
    real, got = pb.confusion, []

    def confusion(*a, **kw):
        got.append(real(*a, **kw))
        return got[-1]
    pb.confusion = confusion
    args = pb.build_argparser().parse_args(list(argv) + (
        ["--msc"] if msc else []))
    t0 = time.perf_counter()
    try:
        miou = pb.run_eval(args, on_pred=on_pred)
    finally:
        pb.confusion = real
    n = VOC_CLASSES
    host = np.zeros((n, n), np.int64)
    for pred, gt in preds:
        valid = gt < n
        host += np.bincount(gt[valid] * n + pred[valid],
                            minlength=n * n).reshape(n, n)
    card_conf = got[0].cpu().numpy()
    if len(preds) != len(VOC_SIZES) or not np.array_equal(card_conf, host):
        fail(f"voc eval (msc={msc}): the card's confusion matrix differs from "
             f"the host's over {len(preds)} images")
    ms = [(b - a) * 1e3 for a, b in zip([t0] + laps[:-1], laps)]
    return {"ms_per_image": statistics.median(ms[1:]), "first_ms": ms[0],
            "miou": miou, "pixels": int(host.sum())}


def voc_step_errors(got, want, before):
    """tests/test_torch_pretrain.py's step rule on one run, per leaf of the
    snapshots (keystr -> HWIO array): the error over the leaf's largest
    update; a leaf that does not move must be equal."""
    out = {}
    for name, w in want.items():
        delta = np.abs(w - before[name]).max()
        if not delta:
            out[name] = 0.0 if np.array_equal(got[name], w) else math.inf
            continue
        out[name] = float(np.abs(got[name] - w).max() / (
            delta + 2.0 ** -23 * np.abs(w).max()))
    return out


def voc_cpu_check(torch, pb, common, root, image):
    """The reduced geometry (res4_blocks VOC_SMALL_RES4, crop
    VOC_SMALL_CROP, batch VOC_SMALL_BS) in f32 on the card against the
    port's CPU run from the same weights: 2 train steps' losses within
    VOC_CPU_TOL relative, the step-2 snapshots by the step rule, and
    `eval_forward`'s logits of `image` (padded to its bucket) from that
    snapshot, msc off and on, within VOC_CPU_TOL of the largest."""
    import os

    from cmpc_refseg_torch.tools.voc import load_image, pad_to_bucket
    from cmpc_refseg_torch.train.optimizer import named_leaves
    small = list(common) + [
        "--mode", "train", "--res4-blocks", str(VOC_SMALL_RES4),
        "--crop-size", str(VOC_SMALL_CROP), "--batch-size",
        str(VOC_SMALL_BS), "--num-steps", "2", "--save-every", "1000"]
    losses, snaps = {}, {}
    for dev in (DEV, "cpu"):
        snap = os.path.join(root, f"small_{dev}")
        args = pb.build_argparser().parse_args(small + [
            "--snapshot-dir", snap, "--device", dev])
        losses[dev] = []
        pb.run_train(args, on_step=lambda it, tr, loss, ce, d=dev:
                     losses[d].append(float(loss)))
        with np.load(os.path.join(snap, "model_step2.npz")) as z:
            snaps[dev] = {k: z[k] for k in z.files}
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses[DEV],
                                                      losses["cpu"]))
    if len(losses[DEV]) != 2 or not loss_err <= VOC_CPU_TOL:
        fail(f"voc small: card losses {losses[DEV]} vs CPU {losses['cpu']}")
    init = {pb.keystr(p): v for p, v in named_leaves(pb.init_numpy(
        0, VOC_SMALL_RES4, VOC_CLASSES))}
    errors = voc_step_errors(snaps[DEV], snaps["cpu"], init)
    bad = [(n, e) for n, e in errors.items() if not e <= (
        VOC_HEAD_TOL if n.startswith("['head']") else VOC_RELU_FLIP_TOL)]
    if set(errors) != set(init) or bad:
        fail(f"voc small: the card's step-2 snapshot against the CPU's: "
             f"{bad[:3]}")
    pim, _ = pad_to_bucket(load_image(image))
    logits = {}
    for dev in (DEV, "cpu"):
        tree = pb.load_params_npz(
            os.path.join(root, f"small_{DEV}", "model_step2.npz"),
            pb.init_numpy(0, VOC_SMALL_RES4, VOC_CLASSES))
        params = pb.params_to_torch(tree, device=dev)
        x = torch.as_tensor(pim[None], device=dev)
        with torch.inference_mode():
            logits[dev] = [pb.eval_forward(params, x, VOC_CLASSES,
                                           VOC_SMALL_RES4, msc=m).cpu()
                           for m in (False, True)]
    logit_err = [compare(torch, a, b, VOC_CPU_TOL, f"voc small eval_forward "
                         f"msc={m}") for a, b, m in zip(
                             logits[DEV], logits["cpu"], (False, True))]
    return {"loss_rel": loss_err, "losses": losses[DEV],
            "worst_head_leaf": max(e for n, e in errors.items()
                                   if n.startswith("['head']")),
            "worst_backbone_leaf": max(e for n, e in errors.items()
                                       if not n.startswith("['head']")),
            "eval_forward_err": logit_err}


def run_convergence_short(torch, kernels, cmpc, root):
    """The convergence proof's main, short (CONV_ARGS), its record under
    `root`: a finite hold-out IoU, and the flagship's kernels launched as
    phase 3's train_bs8 and forward predict: CONV steps train steps and
    holdout / bs=8 forwards."""
    import os

    from cmpc_refseg_torch.tools import convergence_proof as cp
    args = cp.build_argparser().parse_args(list(CONV_ARGS))
    path = os.path.join(root, "convergence.json")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = cp.main(list(CONV_ARGS) + ["--out", path, "--device", DEV])
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    train = expected_launches(cmpc, args.batch_size, train=True)
    forward = expected_launches(cmpc, args.batch_size)
    forwards = args.holdout // args.batch_size
    check_counts(counts, {k: args.steps * train[k] + forwards * forward[k]
                          for k in train}, 1, "convergence proof")
    with open(path) as f:
        rec = json.load(f)
    if not math.isfinite(rec["value"]) or rec != res or \
            [c["step"] for c in rec["curve"]] != [args.steps]:
        fail(f"convergence proof: record {rec}")
    return {"holdout_iou": rec["value"], "wall_s": wall,
            "train_s": rec["wall_clock_s"], "launches": counts}


def run_visualize_check(torch, cli_root):
    """tools/visualize.py's main over N_VIS samples of phase 11's `unc` val
    set from phase 11's newest snapshot: every file written, and each
    sample's sigm PNG equal to `colorize` of Model.forward's sigm."""
    import os

    from PIL import Image

    from cmpc_refseg_torch import cli
    from cmpc_refseg_torch.tools import visualize as vis
    out_dir = os.path.join(cli_root, "visualize")
    argv = ["-d", "unc", "-t", "val", "-f", cli_root, "-ckpt_dir",
            os.path.join(cli_root, "ckpt"), "-out", out_dir, "-max",
            str(N_VIS), "-device", DEV]
    t0 = time.perf_counter()
    n = vis.main(argv)
    wall = time.perf_counter() - t0
    kinds = ["sigm.png", "overlay.png", "parse.json"] + [
        f"{k}_{lv}.png" for k in ("up", "gw") for lv in ("c3", "c4", "c5")]
    want = {f"{i:05d}_{k}" for i in range(N_VIS) for k in kinds}
    if n != N_VIS or set(os.listdir(out_dir)) != want:
        fail(f"visualize: {n} samples, files {sorted(os.listdir(out_dir))}")
    cfg, model = vis.load_model(vis.build_argparser().parse_args(argv))
    for i, sample in zip(range(N_VIS), cli.npz_eval_samples(
            cli_root, "unc", "val", cfg)):
        out = model.forward({k: sample[k] for k in ("im", "words",
                                                     "seq_len")})
        png = np.asarray(Image.open(os.path.join(out_dir,
                                                 f"{i:05d}_sigm.png")))
        if not np.array_equal(png, vis.colorize(
                out.sigm[0, :, :, 0].float().cpu().numpy())):
            fail(f"visualize: sample {i}'s sigm PNG is not colorize of "
                 "Model.forward's sigm")
    return {"samples": n, "files": len(want), "wall_s": wall}


def run_voc_phase(torch, kernels, cmpc, card, cli_root):
    """Phase 15: the VOC pretraining pipeline through the port's
    tools/pretrain_backbone.py main (`run_train` / `run_eval` /
    `--mode infer`) at full width on fabricated VOC-style data, the
    reduced geometry against the CPU, the convergence proof (short) and
    the visualisation tool (`cli_root`: phase 11's dataset and
    snapshots)."""
    import os
    import tempfile

    import cv2

    from cmpc_refseg_torch.tools import pretrain_backbone as pb
    from cmpc_refseg_torch.tools.voc import make_voc_colormap
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as root:
        lines = voc_dataset(root, N_VOC_TRAIN, 15)
        lists = {}
        for name, part in (("train", lines), ("val",
                                              lines[:len(VOC_SIZES)])):
            lists[name] = os.path.join(root, f"{name}.txt")
            with open(lists[name], "w") as f:
                f.write("\n".join(part) + "\n")
        init = os.path.join(root, "calibrated.npz")
        out["calibration"] = voc_calibrated_weights(torch, pb, root, lines,
                                                    init)
        common = ["--data-dir", root, "--num-classes", str(VOC_CLASSES),
                  "--seed", "0", "--print-every", "100000", "--device", DEV]
        full = common + ["--mode", "train", "--data-list", lists["train"],
                         "--batch-size", str(VOC_BS),
                         "--crop-size", str(VOC_CROP), "--restore", init,
                         "--learning-rate", str(VOC_LR)]
        runs = {}
        runs["sgd_bf16"], batch = voc_train_run(
            torch, pb, full + ["--bf16"], N_VOC_STEPS, "SGD --scope all bf16")
        torch.cuda.empty_cache()
        runs["sgd_f32"], _ = voc_train_run(torch, pb, full, N_VOC_STEPS,
                                           "SGD --scope all f32")
        torch.cuda.empty_cache()
        runs["msc_bf16"], _ = voc_train_run(
            torch, pb, full + ["--bf16", "--train-msc"], N_VOC_SHORT,
            "SGD --train-msc bf16")
        torch.cuda.empty_cache()
        runs["adam_head_bf16"], _ = voc_train_run(
            torch, pb, full + ["--bf16", "--scope", "head", "--opt", "adam"],
            N_VOC_SHORT, "head-only Adam bf16")
        torch.cuda.empty_cache()
        out["train"] = runs
        out["grads"] = voc_grad_check(torch, pb, full, batch)
        torch.cuda.empty_cache()
        ev = common + ["--mode", "eval", "--data-list", lists["val"],
                       "--restore", init]
        out["eval"] = voc_eval_check(torch, pb, ev, False)
        out["eval_msc"] = voc_eval_check(torch, pb, ev, True)
        image = os.path.join(root, "im0.jpg")
        png = os.path.join(root, "pred.png")
        t1 = time.perf_counter()
        pred = pb.main(common + ["--mode", "infer", "--image", image,
                                 "--out", png, "--restore", init])
        out["infer_s"] = time.perf_counter() - t1
        if pred.shape != VOC_SIZES[0] or not np.array_equal(
                cv2.imread(png), make_voc_colormap()[pred][:, :, ::-1]):
            fail(f"voc infer: prediction {pred.shape} and its PNG")
        log(f"[voc] eval of {len(VOC_SIZES)} images: "
            f"{out['eval']['ms_per_image']:.3f} ms per image, msc "
            f"{out['eval_msc']['ms_per_image']:.3f} (median of images 2-"
            f"{len(VOC_SIZES)}, decode and padding included); the card's "
            f"confusion matrices equal the host's; infer {out['infer_s']:.2f}"
            f" s for one image")
        torch.cuda.empty_cache()
        out["small_vs_cpu"] = voc_cpu_check(torch, pb, common + [
            "--data-list", lists["train"]], root, image)
        log(f"[voc] res4_blocks {VOC_SMALL_RES4}, crop {VOC_SMALL_CROP}, "
            f"bs={VOC_SMALL_BS}, f32: card vs CPU {json.dumps(out['small_vs_cpu'])}")
        torch.cuda.empty_cache()
        out["convergence"] = run_convergence_short(torch, kernels, cmpc,
                                                   root)
        torch.cuda.empty_cache()
    out["visualize"] = run_visualize_check(torch, cli_root)
    out["phase_s"] = time.perf_counter() - t0
    log(f"[voc] {card}: convergence proof {' '.join(CONV_ARGS)}: hold-out "
        f"IoU {out['convergence']['holdout_iou']}, {out['convergence']['wall_s']:.1f} s; "
        f"visualize {N_VIS} samples {out['visualize']['wall_s']:.1f} s; "
        f"phase 15 {out['phase_s']:.1f} s")
    return out


def converted_forward(torch, kernels, cmpc, ctc, tag, name):
    """Phase 16's conversion of config `name`: `reference_tensors` at full
    width through `convert_tensors` onto the card (wall s, bytes), then
    its bs=8 forward through `api.Model` on the kernel route, counted,
    against the plain route as phase 4 holds the flagship's; for the ASPP
    decoder, the converted BN moving statistics are the model state the
    forward reads (equal to the file's, and the initial statistics give
    other masks).  Returns (the summary, the paths entry, the raw
    converted params)."""
    from cmpc_refseg_torch.api import Model
    from cmpc_refseg_torch.config import get_config
    from cmpc_refseg_torch.models.model import (apply_model,
                                                init_model_state,
                                                prepare_params)

    overrides = {"batch_size": B, "compute_dtype": "bfloat16"}
    t0 = time.perf_counter()
    tensors = ctc.reference_tensors(get_config(name, **overrides))
    fabricate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg, params, state = ctc.convert_tensors(tensors.__getitem__, name,
                                             overrides, device=DEV)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    check_config(cfg, name, f"converted {name}")
    nbytes = tree_bytes(params) + tree_bytes(state)
    model = Model(cfg=cfg, params=prepare_params(params, cfg),
                  model_state=state, device=torch.device(DEV))
    feed = {k: torch.as_tensor(v, device=DEV)
            for k, v in make_batch(cfg, B, seed=16).items()}
    model.forward(feed)                       # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = model.forward(feed)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launch_counts()
    check_counts(counts, config_launches(cmpc, cfg, B), 1,
                 f"converted_{tag}_bs{B}")
    with torch.inference_mode():
        ref = apply_model(model.params, cfg, feed, model_state=state,
                          use_kernels=False)
    err = check_forward(torch, cfg, out, ref, B, f"converted {name}")
    rec = {"config": name, "fabricate_s": fabricate_s,
           "convert_wall_s": convert_s, "converted_bytes": nbytes,
           "reference_tensors": len(tensors),
           "reference_bytes": sum(v.nbytes for v in tensors.values()),
           "forward_ms": ms, "sigm_vs_plain_max_abs": err,
           "sigm_mean": out.sigm.float().mean().item(),
           "sigm_std": out.sigm.float().std().item(), "launches": counts}
    if cfg.decoder == "aspp_v3plus":
        scopes = {**{("aspp", k): v for k, v in ctc.ASPP_SCOPES.items()},
                  **{("decoder", k): v
                     for k, v in ctc.DECODER_BN_SCOPES.items()}}
        for (part, key), sc in scopes.items():
            for stat, tf_name in (("mean", "moving_mean"),
                                  ("var", "moving_variance")):
                want = tensors[f"{ctc.SCOPE}/{sc}/BatchNorm/{tf_name}"]
                for got, what in ((state, "converted"),
                                  (out.model_state, "the forward's")):
                    if not np.array_equal(
                            got[part][key][stat].cpu().numpy(), want):
                        fail(f"converted {name}: {what} {part}/{key} "
                             f"{stat} is not the file's {tf_name}")
        with torch.inference_mode():
            moved = apply_model(model.params, cfg, feed,
                                model_state=init_model_state(cfg,
                                                             device=DEV))
        rec["sigm_initial_statistics_max_abs"] = (
            moved.sigm - out.sigm).abs().max().item()
        if not rec["sigm_initial_statistics_max_abs"] > SIGM_TOL:
            fail(f"converted {name}: the initial BN statistics give the "
                 f"converted statistics' masks within "
                 f"{rec['sigm_initial_statistics_max_abs']:.3e}: the "
                 "forward does not read the model state")
    log(f"[reference] converted {name}: reference_tensors "
        f"{fabricate_s:.2f} s ({rec['reference_tensors']} tensors, "
        f"{rec['reference_bytes']} bytes), convert_tensors onto the card "
        f"{convert_s:.2f} s ({nbytes} bytes); bs={B} bf16 forward "
        f"{ms:.3f} ms, sigm vs plain max abs {err:.3e} <= {SIGM_TOL}, sigm "
        f"mean {rec['sigm_mean']:.4f} std {rec['sigm_std']:.4f}"
        + (f", vs the initial BN statistics "
           f"{rec['sigm_initial_statistics_max_abs']:.3e}"
           if "sigm_initial_statistics_max_abs" in rec else ""))
    del model, out, ref, tensors
    return rec, (counts, 1, ms), params


def run_reference_phase(torch, kernels, cmpc, card, eval_sps):
    """Phase 16: the reference-checkpoint path without JAX.  The flagship
    and CMPCv4_model converted from fabricated reference-named tensors at
    full width (`converted_forward`), then the parity rehearsal
    (`tools.parity_rehearsal.run(from_tensors=True, full_width=True)`)
    over its 8 COCO-size images: layout, batches, conversion on
    the host, step 0 saved, `cli -m test -d unc -c` on the card; the
    checkpoint's weights bit-equal to the flagship's conversion above, the printed table (without and with the CRF) within IOU_TOL of
    `evaluate(use_crf=True)` on those weights and batches, and the CLI
    again without -c.  `eval_sps` is phase 8's samples/s, printed
    beside."""
    import os

    from cmpc_refseg_torch import cli
    from cmpc_refseg_torch.config import get_config
    from cmpc_refseg_torch.tools import convert_tf_checkpoint as ctc
    from cmpc_refseg_torch.tools import parity_rehearsal as pr
    from cmpc_refseg_torch.train import evaluator as ev
    from cmpc_refseg_torch.train.checkpoint import FILE
    from cmpc_refseg_torch.train.optimizer import named_leaves

    t_phase = time.perf_counter()
    n_images = len(pr.COCO_SIZES)
    if n_images != B:
        fail(f"reference: the rehearsal's {n_images} images are not one "
             f"bs={B} batch (eval_bs8's shapes)")
    paths, out = {}, {}
    flagship = None
    for tag, name in REFERENCE:
        out[tag], paths[f"converted_{tag}_bs{B}"], params = \
            converted_forward(torch, kernels, cmpc, ctc, tag, name)
        if tag == "flagship":
            flagship = params
        del params
        torch.cuda.empty_cache()

    real_evaluate, eval_s = ev.evaluate, []

    def timed_evaluate(*a, **kw):
        t0 = time.perf_counter()
        r = real_evaluate(*a, **kw)
        eval_s.append(time.perf_counter() - t0)
        return r
    with tempfile.TemporaryDirectory() as root:
        ev.evaluate = timed_evaluate
        try:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rh = pr.run(root, from_tensors=True, full_width=True)
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            check_counts(counts, expected_launches(cmpc, B), 1,
                         "rehearsal_eval_bs8")
            paths["rehearsal_eval_bs8"] = (counts, 1, eval_s[-1] * 1e3)
            geometry = get_config(pr.MODEL)
            argv = ["-m", "test", "-d", "unc", "-t", "val", "-n", pr.MODEL,
                    "-f", rh.batches, "-ckpt_dir", rh.ckpt_dir,
                    "-emb_dir", os.path.join(root, "data"), "-bs", str(B),
                    "-T", str(geometry.num_steps), "-H", str(geometry.H),
                    "-W", str(geometry.W)]
            kernels.reset_launch_counts()
            _, text, nocrf_wall = run_cli(cli.main, argv)
            nocrf_counts = kernels.launch_counts()
            check_counts(nocrf_counts, expected_launches(cmpc, B), 1,
                         "rehearsal_eval_nocrf_bs8")
            paths["rehearsal_eval_nocrf_bs8"] = (nocrf_counts, 1,
                                                 eval_s[-1] * 1e3)
        finally:
            ev.evaluate = real_evaluate
        nocrf = pr.parse_table(text)
        if nocrf.get("no_crf") != rh.table["no_crf"] or "crf" in nocrf:
            fail(f"reference: the CLI without -c printed {nocrf}, with -c "
                 f"{rh.table}")
        # the checkpoint holds the flagship's conversion
        saved = torch.load(os.path.join(rh.ckpt_dir, "0", FILE),
                           map_location="cpu", weights_only=True, mmap=True)
        weights = dict(named_leaves(flagship))
        held = {**saved["trainable"], **saved["frozen"]}
        differ = [p for p, v in held.items()
                  if not torch.equal(v, weights[p].cpu())]
        if differ or held.keys() != weights.keys():
            fail(f"reference: the rehearsal's checkpoint differs from the "
                 f"conversion at {differ[:5]}")
        ckpt_bytes = os.path.getsize(os.path.join(rh.ckpt_dir, "0", FILE))
        del saved
        cfg, _ = cli.make_config(cli.build_argparser().parse_args(argv),
                                 torch.device(DEV))
        check_config(cfg, pr.MODEL, "rehearsal")
        samples = list(cli.npz_eval_samples(rh.batches, "unc", "val", cfg))
        t0 = time.perf_counter()
        direct = ev.evaluate(cfg, flagship, {}, iter(samples), use_crf=True,
                             device=DEV)
        direct_s = time.perf_counter() - t0
    iou_err = 0.0
    for section, r in direct.items():
        want = {"overall IoU": r["overall_iou"], "mean IoU": r["mean_iou"],
                **{f"precision@{k[5:]}": v for k, v in r.items()
                   if k.startswith("prec@")}}
        shown = rh.table.get(section, {})
        if set(shown) != set(want) or r["n"] != n_images:
            fail(f"reference: the rehearsal printed {shown} for {section}, "
                 f"evaluate gives {want} over {r['n']} samples")
        iou_err = max([iou_err] + [abs(shown[k] - v)
                                   for k, v in want.items()])
    if set(direct) != set(rh.table) or not iou_err <= IOU_TOL:
        fail(f"reference: the rehearsal printed {rh.table}, evaluate gives "
             f"{direct} (max abs {iou_err:.3e} > {IOU_TOL})")
    del flagship
    out["rehearsal"] = {
        "images": n_images, "wall_s": wall, "steps_s": rh.seconds,
        "save_ms": rh.seconds["save"] * 1e3, "checkpoint_bytes": ckpt_bytes,
        "cli_crf_wall_s": rh.seconds["evaluate"],
        "cli_crf_samples_per_s": n_images / rh.seconds["evaluate"],
        "evaluate_crf_s": eval_s[0],
        "cli_nocrf_wall_s": nocrf_wall,
        "cli_nocrf_samples_per_s": n_images / nocrf_wall,
        "evaluate_nocrf_s": eval_s[1],
        "direct_evaluate_crf_s": direct_s,
        "eval_samples_per_s_phase8": eval_sps, "table": rh.table,
        "printed_vs_evaluate_max_abs": iou_err}
    out["phase_s"] = time.perf_counter() - t_phase
    r = out["rehearsal"]
    log(f"[reference] {card}: parity rehearsal --from-tensors --full-width "
        f"over {n_images} COCO-size images: {wall:.1f} s (steps "
        f"{json.dumps({k: round(v, 3) for k, v in rh.seconds.items()})}); "
        f"step 0 saved in {r['save_ms']:.1f} ms ({ckpt_bytes} bytes); "
        f"cli -m test -c {r['cli_crf_samples_per_s']:.2f} samples/s "
        f"({r['cli_crf_wall_s']:.2f} s, evaluate {eval_s[0]:.2f} s), "
        f"without -c {r['cli_nocrf_samples_per_s']:.2f} samples/s "
        f"({nocrf_wall:.2f} s, evaluate {eval_s[1]:.2f} s) vs phase 8's "
        f"evaluate {eval_sps:.1f}; printed table within {iou_err:.1e} of "
        f"evaluate's: {json.dumps(rh.table)}; phase 16 "
        f"{out['phase_s']:.1f} s")
    return paths, out


def run_wide_phase(torch, kernels, cmpc, build_model, build_trainer,
                   apply_model, compute_gradients, named_leaves, card):
    """Phase 17: the flagship widened to WIDE_CFG (v_emb_dim 4104, so A = C
    = 4104; mlp_dim 1032) at 320x320, bs=WIDE_B, bf16, full depth, where
    every wrapper with a wide form launches it on its real call path: one
    forward (launches counted, each of WIDE_FORMS all wide; ms, peak GB,
    the device split by kernel) and sigm against the plain route (phase
    4's rule); then the train step, held by check_train_routes' rule on
    one batch, and one timed step (the dz pass wide as well)."""
    t0 = time.perf_counter()
    path, train_path = f"wide_bs{WIDE_B}", f"wide_train_bs{WIDE_B}"
    model = build_model("CMPC_model", device=DEV, dtype="bfloat16",
                        batch_size=WIDE_B, **WIDE_CFG)
    cfg = model.cfg
    if (cfg.H, cfg.res4_blocks, cfg.v_emb_dim, cfg.mlp_dim) != (
            H_IMG, RES4, WIDE_CFG["v_emb_dim"], WIDE_CFG["mlp_dim"]) or \
            not cmpc.pack_levels(WIDE_B, len(cfg.levels)):
        fail(f"unexpected widened config {cfg}")
    feed = {k: torch.as_tensor(v, device=DEV)
            for k, v in make_batch(cfg, WIDE_B, seed=3).items()}
    model.forward(feed)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    out = model.forward(feed)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t1) * 1e3
    counts, wide = kernels.launch_counts(), kernels.wide_launch_counts()
    fwd_peak = torch.cuda.max_memory_allocated() / 1e9
    check_counts(counts, expected_launches(cmpc, WIDE_B), 1, path,
                 wide=WIDE_FORMS)
    with torch.inference_mode():
        ref = apply_model(model.params, cfg, feed, use_kernels=False)
    sigm_err = check_forward(torch, cfg, out, ref, WIDE_B, path)
    del ref
    split = device_split_ms(torch, lambda: model.forward(feed), reps=3)
    wide_ms = sum(ms for name, ms in split.items()
                  if name.split("<")[0] in WIDE_KERNELS)
    log(f"[{path}] {card}: CMPC_model{WIDE_CFG} 320x320 bs={WIDE_B} bf16 "
        f"res4_blocks=23: {fwd_ms:.3f} ms/batch (one run), peak memory "
        f"{fwd_peak:.2f} GB; sigm vs plain max abs {sigm_err:.3e} <= "
        f"{SIGM_TOL}; launches {counts}, of them wide {wide}; the wide "
        f"forms' kernels {wide_ms:.3f} ms of the forward's device time "
        f"{sum(split.values()):.3f} ms")
    log(f"[{path}] device ms by kernel: {json.dumps(split)}")
    del model, out
    torch.cuda.empty_cache()

    trainer = build_trainer("CMPC_model", device=DEV, dtype="bfloat16",
                            batch_size=WIDE_B, **WIDE_CFG)
    reference = build_trainer("CMPC_model", device=DEV, dtype="float32",
                              batch_size=WIDE_B, **WIDE_CFG)
    batches = [train_batch(trainer.cfg, WIDE_B, i) for i in range(2)]
    routes = check_train_routes(torch, trainer, reference, compute_gradients,
                                named_leaves, batches[0])
    del reference
    torch.cuda.empty_cache()
    trainer.step(batches[0])                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    metrics = trainer.step(batches[1])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) * 1e3
    train_counts = kernels.launch_counts()
    train_wide = kernels.wide_launch_counts()
    step_peak = torch.cuda.max_memory_allocated() / 1e9
    check_counts(train_counts, config_launches(cmpc, cfg, WIDE_B, train=True),
                 1, train_path, wide=(*WIDE_FORMS, "mutan_bwd_dz"))
    loss = float(metrics["loss_total"])
    if not math.isfinite(loss):
        fail(f"{train_path}: non-finite loss {loss}")
    log(f"[{train_path}] {card}: {step_ms:.3f} ms/step (one step), peak "
        f"memory {step_peak:.2f} GB, loss {loss:.4f}; kernel vs plain route "
        f"on one batch: loss relative error {routes['loss_rel_err']:.3e} <= "
        f"{TRAIN_LOSS_TOL}; worst resolved gradient "
        f"{routes['worst_resolved_grad_rel_err']:.3e} <= {TRAIN_GRAD_TOL} "
        f"({routes['worst_resolved_grad_leaf']}); leaf counts "
        f"{routes['counts']}; launches {train_counts}, of them wide "
        f"{train_wide}")
    del trainer
    torch.cuda.empty_cache()
    summary = {"forward_ms": fwd_ms, "forward_peak_gb": fwd_peak,
               "sigm_err": sigm_err, "wide_launches": wide,
               "wide_kernels_ms": wide_ms, "device_ms": sum(split.values()),
               "step_ms": step_ms, "step_peak_gb": step_peak, "loss": loss,
               "train_wide_launches": train_wide,
               **{k: v for k, v in routes.items()
                  if k != "unresolved_leaves"},
               "held_to_noise": [r["leaf"] for r in
                                 routes["unresolved_leaves"]],
               "phase_s": time.perf_counter() - t0}
    return {path: (counts, 1, fwd_ms),
            train_path: (train_counts, 1, step_ms)}, summary


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA GPU")
    from cmpc_refseg_torch.api import build_model, build_service, build_trainer
    from cmpc_refseg_torch.config import get_config
    from cmpc_refseg_torch.models import aspp, cmpc
    from cmpc_refseg_torch.models.model import apply_model
    from cmpc_refseg_torch.ops import autograd, build, kernels
    from cmpc_refseg_torch.train.optimizer import named_leaves
    from cmpc_refseg_torch.train.trainer import compute_gradients

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    nvcc = subprocess.run([build.nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    log(f"[card] {card} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {kind} | nvcc {nvcc}")

    secs = build.build_all()
    log(f"[build] {secs:.1f} s for {list(build.SOURCES)} (one nvcc each, "
        "in parallel)")
    for name in build.SOURCES:
        log(f"[build] {name}, ptxas: "
            f"{json.dumps(ptxas_report(build.build_log(name)))}")

    if cmpc.pack_levels(B_LARGE, G) or not cmpc.pack_levels(B, G):
        fail(f"the packing rule no longer packs bs={B} and not bs={B_LARGE}:"
             " phase 3's paths need new batches")
    records = check_kernels(torch, kernels, cmpc, torch.device(DEV),
                            path_specs(get_config))
    edges = check_edges(torch, kernels, cmpc, torch.device(DEV))
    edges += odd_width_edges(torch, kernels, cmpc, torch.device(DEV))
    kernels.reset_launch_counts()   # from here on only phase 17 goes wide
    torch.cuda.empty_cache()
    # path -> (launch counts of its runs, runs, ms per run)
    paths = run_forward(torch, kernels, cmpc, build_model, apply_model, card)
    run_long_forward(torch, build_model, apply_model, card)
    torch.cuda.empty_cache()
    srv_paths, serving = run_serving(torch, np, kernels, cmpc, build_service,
                                     apply_model, card)
    paths.update(srv_paths)
    torch.cuda.empty_cache()
    train_paths, train = run_train(torch, kernels, autograd, cmpc,
                                   build_trainer, compute_gradients,
                                   named_leaves, card)
    paths.update(train_paths)
    torch.cuda.empty_cache()
    var_paths, variants = run_variants(torch, kernels, cmpc, aspp,
                                       build_model, apply_model, card)
    paths.update(var_paths)
    srv_paths, v6_serving = run_serving(
        torch, np, kernels, cmpc, build_service, apply_model, card,
        name="CMPCv6_model", path="v6_serving_bs1")
    paths.update(srv_paths)
    torch.cuda.empty_cache()
    train_paths, v4_train = run_train(
        torch, kernels, autograd, cmpc, build_trainer, compute_gradients,
        named_leaves, card, name="CMPCv4_model", path="v4_train_bs8",
        controls=mutan_faults(kernels))
    paths.update(train_paths)
    torch.cuda.empty_cache()
    eval_paths, evaluation = run_eval(torch, kernels, cmpc, card)
    paths.update(eval_paths)
    torch.cuda.empty_cache()
    ckpt_paths, ckpt = run_checkpoint(torch, kernels, cmpc, build_trainer,
                                      named_leaves, card)
    paths.update(ckpt_paths)
    torch.cuda.empty_cache()
    # phase 9: the text-encoder and lateral options
    opt_paths, options = run_variants(torch, kernels, cmpc, aspp,
                                      build_model, apply_model, card,
                                      variants=OPTIONS)
    paths.update(opt_paths)
    srv_paths, hsv_serving = run_serving(
        torch, np, kernels, cmpc, build_service, apply_model, card,
        name="CMPCv5_BiLSTM_HSV_model", path="v5_bilstm_hsv_serving_bs1")
    paths.update(srv_paths)
    torch.cuda.empty_cache()
    hsv_cfg = get_config("CMPCv5_BiLSTM_HSV_model")
    glove = (0.4 * np.random.default_rng(GLOVE_SEED).standard_normal(
        (hsv_cfg.vocab_size, hsv_cfg.glove_dim))).astype(np.float32)
    train_paths, hsv_train = run_train(
        torch, kernels, autograd, cmpc, build_trainer, compute_gradients,
        named_leaves, card, name="CMPCv5_BiLSTM_HSV_model",
        path="v5_bilstm_hsv_train_bs8", glove=glove)
    paths.update(train_paths)
    torch.cuda.empty_cache()
    train_paths, bert_train = run_train(
        torch, kernels, autograd, cmpc, build_trainer, compute_gradients,
        named_leaves, card, name="CMPCv4_BERT_model", path="bert_train_bs8")
    paths.update(train_paths)
    torch.cuda.empty_cache()
    # phase 10: the sentence fusion and detection head configs, conv5 and
    # grad_accum
    plus_paths, plus = run_variants(torch, kernels, cmpc, aspp, build_model,
                                    apply_model, card, variants=PLUS)
    paths.update(plus_paths)
    for tag, name, _ in PLUS:
        torch.cuda.empty_cache()
        srv_paths, plus[f"{tag}_serving_bs1"] = run_serving(
            torch, np, kernels, cmpc, build_service, apply_model, card,
            name=name, path=f"{tag}_serving_bs1")
        paths.update(srv_paths)
        torch.cuda.empty_cache()
        train_paths, plus[f"{tag}_train_bs8"] = run_train(
            torch, kernels, autograd, cmpc, build_trainer, compute_gradients,
            named_leaves, card, name=name, path=f"{tag}_train_bs8",
            controls=mutan_faults(kernels) if tag == "v5plus" else ())
        paths.update(train_paths)
    torch.cuda.empty_cache()
    train_paths, plus["v4conv5_train_bs8"] = run_train(
        torch, kernels, autograd, cmpc, build_trainer, compute_gradients,
        named_leaves, card, name="CMPCv4_model", path="v4conv5_train_bs8",
        overrides={"conv5": True})
    paths.update(train_paths)
    torch.cuda.empty_cache()
    accum_paths, plus[f"accum_train_bs{B // 2}"] = run_accum(
        torch, kernels, cmpc, build_trainer, compute_gradients, named_leaves,
        card)
    paths.update(accum_paths)
    torch.cuda.empty_cache()
    # phase 11: the command lines (their dataset and snapshots stay for
    # phase 15)
    cli_root = tempfile.TemporaryDirectory()
    cli_paths, cli_phase = run_cli_phase(torch, kernels, cmpc, card,
                                         train["median_ms"],
                                         evaluation["samples_per_s"],
                                         cli_root.name)
    paths.update(cli_paths)
    torch.cuda.empty_cache()
    # phase 12: the video model and the post-processing
    video_paths, video = run_video_phase(
        torch, kernels, autograd, cmpc, aspp, build_model, build_trainer,
        apply_model, compute_gradients, named_leaves, card)
    paths.update(video_paths)
    torch.cuda.empty_cache()
    # phase 13: the int8 backbone, VGG16-FCN and data parallelism
    t13 = time.perf_counter()
    int8_paths, int8 = run_int8(torch, kernels, cmpc, build_service, card,
                                serving, paths["forward_bs8"][2])
    paths.update(int8_paths)
    torch.cuda.empty_cache()
    vgg = run_vgg(torch, card)
    torch.cuda.empty_cache()
    dp_paths, dp = run_dp(torch, kernels, cmpc, build_trainer,
                          compute_gradients, named_leaves, card,
                          train["median_ms"])
    paths.update(dp_paths)
    log(f"[phase 13] {time.perf_counter() - t13:.1f} s")
    torch.cuda.empty_cache()
    # phase 14: tensor parallelism and ZeRO
    t14 = time.perf_counter()
    tp_paths, tp = run_tp(torch, kernels, cmpc, build_trainer,
                          compute_gradients, named_leaves, card,
                          train["median_ms"])
    paths.update(tp_paths)
    log(f"[phase 14] {time.perf_counter() - t14:.1f} s")
    torch.cuda.empty_cache()
    # phase 15: the VOC pretraining pipeline, the convergence proof and the
    # visualisation tool
    t15 = time.perf_counter()
    voc = run_voc_phase(torch, kernels, cmpc, card, cli_root.name)
    cli_root.cleanup()
    log(f"[phase 15] {time.perf_counter() - t15:.1f} s")
    torch.cuda.empty_cache()
    # phase 16: the reference-checkpoint path and the parity rehearsal
    ref_paths, reference = run_reference_phase(
        torch, kernels, cmpc, card, evaluation["samples_per_s"])
    paths.update(ref_paths)
    log(f"[phase 16] {reference['phase_s']:.1f} s")
    torch.cuda.empty_cache()
    # phase 17: the flagship widened past every main kernel's bound
    wide_paths, widened = run_wide_phase(
        torch, kernels, cmpc, build_model, build_trainer, apply_model,
        compute_gradients, named_leaves, card)
    paths.update(wide_paths)
    log(f"[phase 17] {widened['phase_s']:.1f} s")
    for rec in records:
        counts, runs, _ = paths[rec["path"]]
        rec["launches"], rec["runs"] = counts[rec["kernel"]], runs
        if not rec["launches"]:
            fail(f"{rec['name']}: no launch on its path")
    unheld = {f"{k}@{CLI_PATHS.get(path, path)}"
              for path, (counts, _, _) in paths.items()
              for k, n in counts.items() if n} - {r["name"] for r in records}
    if unheld:
        fail(f"launched on a path but not held at its shapes in phase 3: "
             f"{sorted(unheld)}")
    for path, (_, _, run_ms) in paths.items():
        held = CLI_PATHS.get(path, path)
        share = sum(r["ms"] * r["launches"] / r["runs"] for r in records
                    if r["path"] == held) / run_ms
        log(f"[{path}] the kernels take {share:.1%} of the {run_ms:.3f} ms "
            "run (kernel ms at this path's shapes x launches per run)")
    log(f"[kernels] edge records: {json.dumps(edges)}")
    log(f"[serving] {json.dumps(serving)}")
    log(f"[train] {json.dumps(train)}")
    log(f"[variants] {json.dumps(variants)}")
    log(f"[v6_serving_bs1] {json.dumps(v6_serving)}")
    log(f"[v4_train_bs8] {json.dumps(v4_train)}")
    log(f"[eval_bs8] {json.dumps(evaluation)}")
    log(f"[ckpt_v4] {json.dumps(ckpt)}")
    log(f"[options] {json.dumps(options)}")
    log(f"[v5_bilstm_hsv_serving_bs1] {json.dumps(hsv_serving)}")
    log(f"[v5_bilstm_hsv_train_bs8] {json.dumps(hsv_train)}")
    log(f"[bert_train_bs8] {json.dumps(bert_train)}")
    log(f"[plus] {json.dumps(plus)}")
    log(f"[cli] {json.dumps(cli_phase)}")
    log(f"[video] {json.dumps(video)}")
    log(f"[int8] {json.dumps(int8)}")
    log(f"[vgg16_fcn] {json.dumps(vgg)}")
    log(f"[dp] {json.dumps(dp)}")
    log(f"[tp] {json.dumps(tp)}")
    log(f"[voc] {json.dumps(voc)}")
    log(f"[reference] {json.dumps(reference)}")
    log(f"[widened] {json.dumps(widened)}")
    print(json.dumps({"kernels": records}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

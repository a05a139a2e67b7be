"""The command line of the port (reference: trainval_model.py argparse
surface, :337-403; the JAX package's cli.py, with the same flags).

Examples (mirroring trainval.sh):
  python -m cmpc_refseg_torch.cli -m train -d refvos -n CMPC_model -bs 8 \
      -im_dir .../JPEGImages -mask_dir .../Annotations -meta train_meta.json \
      -vocab data/vocabulary_refvos.txt -emb refvos
  python -m cmpc_refseg_torch.cli -m test -d unc -t val -n CMPC_model \
      -f ./cmpc

Runs on the CUDA device unless `-device cpu` is given, in bf16 there and
float32 on the CPU unless `-dtype` says otherwise; without a CUDA device
and without `-device cpu` it raises.  `-c` scores the DenseCRF-refined
masks beside the plain ones in test mode (``ops/densecrf.py``).

Data-parallel training, one process per device, launched by torchrun:
  torchrun --nproc_per_node N -m cmpc_refseg_torch.cli -m train \
      -distributed -bs 8 ...
`-distributed` joins the process group from torchrun's environment
(``parallel/mesh.py``) before any device use, on `cuda:LOCAL_RANK`, or
runs in the group that the calling process has joined already; `-bs`
is the global batch, each rank reads its shard of the data, the
validation runs sharded over the ranks and only rank 0 logs and writes
snapshots.  `-mesh N` (N > 1) must equal the world size.

torch is imported by the functions that run the model, not by the module:
the RefVOS reader's spawned workers import the main module, and must not
pay torch's import.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

# dataset -> (vocab size, default emb name) (trainval_model.py:27-44,168-180)
DATASET_VOCAB = {
    "referit": (8803, "referit"),
    "unc": (12112, "Gref"),
    "unc+": (12112, "Gref"),
    "Gref": (12112, "Gref"),
    "refvos": (12112, "refvos"),
}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("cmpc_refseg_torch")
    p.add_argument("-m", dest="mode", required=True,
                   choices=["train", "test"])
    p.add_argument("-d", dest="dataset", default="refvos")
    p.add_argument("-t", dest="split", default="val")
    p.add_argument("-n", dest="model_name", default="CMPC_model")
    p.add_argument("-f", dest="data_folder", default="./data")
    p.add_argument("-i", dest="max_iter", type=int, default=800_000)
    p.add_argument("-st", dest="stop_iter", type=int, default=700_000)
    p.add_argument("-s", dest="snapshot", type=int, default=100_000)
    p.add_argument("-bs", dest="batch_size", type=int, default=1)
    p.add_argument("-lr", dest="start_lr", type=float, default=2.5e-4)
    p.add_argument("-T", dest="num_steps", type=int, default=20)
    p.add_argument("-H", dest="H", type=int, default=320)
    p.add_argument("-W", dest="W", type=int, default=320)
    p.add_argument("-c", dest="use_crf", action="store_true",
                   help="test: also score DenseCRF-refined masks")
    p.add_argument("-v", dest="visualize", action="store_true")
    p.add_argument("-conv5", dest="conv5", action="store_true")
    p.add_argument("-emb", dest="emb_name", default=None)
    p.add_argument("-emb_dir", dest="emb_dir", default="data")
    p.add_argument("-im_dir", dest="im_dir", default=None)
    p.add_argument("-mask_dir", dest="mask_dir", default=None)
    p.add_argument("-meta", dest="meta", default=None)
    p.add_argument("-vocab", dest="vocab", default=None)
    p.add_argument("-ckpt_dir", dest="ckpt_dir", default="./checkpoints")
    p.add_argument("-log_dir", dest="log_dir", default="./logs")
    p.add_argument("-lastiter", dest="last_iter", type=int, default=0)
    p.add_argument("-pretrain", dest="pretrain", default=None,
                   help="checkpoint dir to warm-start from")
    p.add_argument("-resume", dest="resume", action="store_true",
                   help="auto-resume from the latest snapshot in -ckpt_dir "
                        "(crash recovery; replaces the reference's manual "
                        "-lastiter bookkeeping)")
    p.add_argument("-val_meta", dest="val_meta", default=None,
                   help="val metadata json for periodic in-training "
                        "validation (reference trainval_model_bert.py:107)")
    p.add_argument("-val_every", dest="val_every", type=int, default=5000)
    p.add_argument("-val_batches", dest="val_batches", type=int, default=32)
    p.add_argument("-dtype", dest="compute_dtype", default=None,
                   help="float32|bfloat16 (default: bf16 on CUDA, float32 "
                        "on the CPU)")
    p.add_argument("-device", dest="device", default=None,
                   help="cuda (default; raises without a CUDA device) or "
                        "cpu (the kernels' plain versions)")
    p.add_argument("-mesh", dest="mesh_devices", type=int, default=0,
                   help="data-parallel devices: 0 means the world size "
                        "(1 without -distributed); more than 1 must equal "
                        "the world size of a -distributed run")
    p.add_argument("-workers", dest="num_workers", type=int, default=0,
                   help="host input-pipeline worker PROCESSES "
                        "(0 = min(8, cpu_count); 1 = single prefetch "
                        "thread, deterministic order)")
    # model-dimension overrides (ablations / debugging / CI smoke runs)
    p.add_argument("-accum", dest="grad_accum", type=int, default=1,
                   help="gradient accumulation micro-steps per update")
    p.add_argument("-rnn_size", type=int, default=None)
    p.add_argument("-v_emb_dim", type=int, default=None)
    p.add_argument("-mlp_dim", type=int, default=None)
    p.add_argument("-glove_dim", type=int, default=None)
    p.add_argument("-res4_blocks", type=int, default=None)
    p.add_argument("-vocab_size", type=int, default=None)
    p.add_argument("-distributed", action="store_true",
                   help="data-parallel run under torchrun: join the process "
                        "group from its environment before any device use; "
                        "each rank reads batch_size / world_size samples a "
                        "step and only rank 0 logs and writes snapshots "
                        "(a process that has joined a group already runs "
                        "in that one)")
    return p


def check_mesh(args, world: int) -> None:
    """`-mesh N` with N > 1 must be the world size: the port runs one
    process per device."""
    if args.mesh_devices > 1 and args.mesh_devices != world:
        raise ValueError(
            f"-mesh {args.mesh_devices} with a world of {world} "
            f"process(es): the port runs one process per device; launch "
            f"with torchrun --nproc_per_node {args.mesh_devices} ... "
            "-distributed")


def load_glove(emb_dir: str, emb_name: str):
    path = os.path.join(emb_dir, f"{emb_name}_emb.npy")
    if os.path.isfile(path):
        return np.load(path)
    print(f"[warn] GloVe embedding not found at {path}; random init")
    return None


def make_config(args, device):
    """(config, emb name) of the run on `device` (a torch.device)."""
    from cmpc_refseg_torch.config import get_config
    vocab_size, emb_default = DATASET_VOCAB.get(args.dataset, (12112, "Gref"))
    emb_name = args.emb_name or emb_default
    dtype = args.compute_dtype or ("bfloat16" if device.type == "cuda"
                                   else "float32")
    overrides = {k: getattr(args, k) for k in
                 ("rnn_size", "v_emb_dim", "mlp_dim", "glove_dim",
                  "res4_blocks", "vocab_size")
                 if getattr(args, k, None) is not None}
    cfg = get_config(
        args.model_name, batch_size=args.batch_size,
        num_steps=args.num_steps, H=args.H, W=args.W,
        vocab_size=overrides.pop("vocab_size", vocab_size),
        start_lr=args.start_lr, conv5=args.conv5,
        compute_dtype=dtype, grad_accum=args.grad_accum, **overrides)
    return cfg, emb_name


class NpzCollator:
    """`read_collated(bs)` over an NpzReader of offline batches: the text,
    image and mask of `bs` samples, and their lengths 'seq_length' — the
    files' own where they carry it, else the count of nonzero tokens, as
    `npz_eval_samples` takes it.  (The JAX package's collator passes no
    length, so its `-m train` on npz batches raises for the LSTM
    encoders, which need one.)"""

    def __init__(self, inner):
        self.inner = inner
        self.num_batch = inner.num_samples

    def read_collated(self, bs):
        samples = [self.inner.read() for _ in range(bs)]
        keys = ["text_batch", "im_batch", "mask_batch"] + (
            ["seq_length"] if "seq_length" in samples[0] else [])
        out = {k: np.stack([np.asarray(s[k]) for s in samples], axis=0)
               for k in keys}
        if "seq_length" not in out:
            out["seq_length"] = (out["text_batch"] != 0).sum(-1).astype(
                np.int32)
        return out


def run_train(args, device):
    import torch.distributed as dist

    from cmpc_refseg_torch.data.refvos import RefVOSReader
    from cmpc_refseg_torch.parallel.mesh import (is_primary_process,
                                                 process_count,
                                                 process_index)
    from cmpc_refseg_torch.train.trainer import create_train_state, train_loop
    from cmpc_refseg_torch.utils.logging import MetricLogger

    cfg, emb_name = make_config(args, device)
    glove = load_glove(args.emb_dir, emb_name)
    mesh = dist.group.WORLD if process_count() > 1 else None

    # every rank draws the same epoch permutation and reads its own
    # shard_index::shard_count stride of it
    shard_kw = {"shard_index": process_index(),
                "shard_count": process_count()}
    if args.dataset == "refvos":
        workers = args.num_workers or min(8, os.cpu_count() or 1)
        reader = RefVOSReader(
            im_dir=args.im_dir, mask_dir=args.mask_dir,
            metadata_path=args.meta, vocab_path=args.vocab,
            T=cfg.num_steps, input_h=cfg.H, input_w=cfg.W,
            prefetch_num=4 * max(workers, 1), num_workers=workers,
            **shard_kw)
    else:
        from cmpc_refseg_torch.data.reader import NpzReader
        reader = NpzCollator(NpzReader(
            os.path.join(args.data_folder, args.dataset, args.split
                         + "_batch"),
            f"{args.dataset}_{args.split}", **shard_kw))

    state = None
    start_iter = args.last_iter
    if args.resume:
        from cmpc_refseg_torch.train.checkpoint import (latest_step,
                                                        restore_checkpoint)
        step = latest_step(args.ckpt_dir)
        if step is not None:
            state = create_train_state(0, cfg, glove, device=device)
            state = restore_checkpoint(args.ckpt_dir, state)
            start_iter = int(state.step)
            print(f"resumed from {args.ckpt_dir} at step {start_iter}")
        else:
            print(f"[resume] no snapshot in {args.ckpt_dir}; fresh start")
    elif args.pretrain:
        from cmpc_refseg_torch.train.checkpoint import restore_checkpoint
        state = create_train_state(0, cfg, glove, device=device)
        state = restore_checkpoint(args.pretrain, state)
        print(f"warm-started from {args.pretrain}")

    val_fn = None
    if args.val_meta and args.dataset == "refvos":
        from cmpc_refseg_torch.train.evaluator import evaluate_sharded
        from cmpc_refseg_torch.train.trainer import prepare_image_batch
        val_reader = RefVOSReader(
            im_dir=args.im_dir, mask_dir=args.mask_dir,
            metadata_path=args.val_meta, vocab_path=args.vocab,
            T=cfg.num_steps, input_h=cfg.H, input_w=cfg.W, shuffle=False)

        def val_fn(st):
            def batches():
                for _ in range(args.val_batches):
                    yield prepare_image_batch(
                        val_reader.read_collated(cfg.batch_size), cfg)
            res = evaluate_sharded(cfg, st.params(), st.model_state,
                                   batches(), mesh=mesh, device=device)
            if is_primary_process():
                print(f"[val] overall IoU {res['overall_iou']:.4f} "
                      f"mean IoU {res['mean_iou']:.4f} (n={res['n']})")
            return res

    logger = MetricLogger(args.log_dir) if is_primary_process() else None
    try:
        return train_loop(cfg, reader, max_iter=args.stop_iter, state=state,
                          glove=glove, device=device,
                          snapshot_every=args.snapshot,
                          checkpoint_dir=args.ckpt_dir, logger=logger,
                          start_iter=start_iter, val_fn=val_fn,
                          val_every=args.val_every if args.val_meta else 0)
    finally:
        if logger is not None:
            logger.close()
        if isinstance(reader, RefVOSReader):
            reader.close()


def npz_eval_samples(data_folder, dataset, split, cfg):
    """Eval sample iterator from offline npz batches (trainval_model.py
    test(): native-res image+mask in the npz; resize-pad at eval time)."""
    from cmpc_refseg_torch.data.image import IMAGE_MEAN_BGR, resize_and_pad
    from cmpc_refseg_torch.data.reader import NpzReader

    reader = NpzReader(os.path.join(data_folder, dataset, split + "_batch"),
                       f"{dataset}_{split}", shuffle=False)
    for _ in range(reader.num_samples):
        z = reader.read()
        mask = np.asarray(z["mask_batch"]) > 0
        im_native = np.asarray(z["im_batch"])
        im = resize_and_pad(im_native.astype(np.float32), cfg.H, cfg.W)
        im = im[..., ::-1] - IMAGE_MEAN_BGR
        text = np.asarray(z["text_batch"]).reshape(1, -1)
        seq_len = int((text != 0).sum())
        yield {
            "im": im[None].astype(np.float32),
            "words": text.astype(np.int32),
            "seq_len": np.asarray([seq_len], np.int32),
            "orig_size": mask.shape[:2],
            "target_native": mask,
            "im_native": im_native.astype(np.uint8),
        }


def run_test(args, device):
    from cmpc_refseg_torch.train.checkpoint import restore_checkpoint
    from cmpc_refseg_torch.train.evaluator import evaluate, print_results
    from cmpc_refseg_torch.train.trainer import create_train_state

    cfg, emb_name = make_config(args, device)
    glove = load_glove(args.emb_dir, emb_name)
    state = create_train_state(0, cfg, glove, device=device)
    if args.pretrain or os.path.isdir(args.ckpt_dir):
        try:
            state = restore_checkpoint(args.pretrain or args.ckpt_dir, state)
        except FileNotFoundError:
            print("[warn] no checkpoint found; evaluating random init")
    samples = npz_eval_samples(args.data_folder, args.dataset, args.split,
                               cfg)
    visualize_fn = None
    if args.visualize:
        # reference visualize_seg (trainval_model.py:306-334): dump the
        # native image, GT mask and predicted mask per sample
        from PIL import Image
        vis_dir = os.path.join(args.log_dir, "visualize")
        os.makedirs(vis_dir, exist_ok=True)

        def visualize_fn(n, sample, pred, sigm):
            Image.fromarray(np.asarray(sample["im_native"], np.uint8)).save(
                os.path.join(vis_dir, f"{n:05d}_im.png"))
            Image.fromarray((np.asarray(sample["target_native"]) > 0
                             ).astype(np.uint8) * 255).save(
                os.path.join(vis_dir, f"{n:05d}_gt.png"))
            Image.fromarray(pred.astype(np.uint8) * 255).save(
                os.path.join(vis_dir, f"{n:05d}_pred.png"))
    results = evaluate(cfg, state.params(), state.model_state, samples,
                       use_crf=args.use_crf, visualize_fn=visualize_fn,
                       device=device)
    print_results(results)
    return results


def main(argv=None):
    from cmpc_refseg_torch.convert import resolve_device

    args = build_argparser().parse_args(argv)
    if args.distributed:
        import torch.distributed as dist

        from cmpc_refseg_torch.parallel.mesh import (initialize_distributed,
                                                     local_device,
                                                     process_count)
        if dist.is_initialized():
            device = local_device(args.device)
        else:
            device = initialize_distributed(device=args.device)
        check_mesh(args, process_count())
    else:
        check_mesh(args, 1)
        device = resolve_device(args.device)
    if args.mode == "train":
        return run_train(args, device)
    return run_test(args, device)


if __name__ == "__main__":
    main()

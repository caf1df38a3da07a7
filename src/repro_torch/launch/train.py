"""Training launcher (PyTorch port of `repro/launch/train.py`).

    # one GPU: the full config (train_4k's 4,096 tokens, global batch 256)
    python -m repro_torch.launch.train --arch granite-3-2b --accum 64

    # the CPU: the smoke config at seq 64, batch 8, the same code path
    python -m repro_torch.launch.train --arch granite-3-2b --device cpu --steps 50

  --accum N           gradient-accumulation micro-batching
  --ckpt-dir/--ckpt-every   checkpoints under <ckpt-dir>/<config name>; a
                      second call resumes from the latest one

Left out for good: JAX's `--mesh single|multi` and `--no-fsdp` (TPU
meshes and the logical sharding rules, which have no torch object) and
its `LIBTPU_INIT_ARGS`. `--device` takes the place of `--mesh cpu`.
(int8 error-feedback gradient reduction lives in train/grad_compress.py.)
"""
from __future__ import annotations

import argparse
import os

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import for_model
from repro_torch.train.train_loop import train


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b", choices=list(ARCH_IDS))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    args = ap.parse_args(argv)

    if args.device == "cpu":
        cfg = get_config(args.arch).smoke_config()
        seq = 64 if args.seq is None else args.seq
        batch = 8 if args.batch is None else args.batch
    else:
        cfg = get_config(args.arch)
        seq = 4096 if args.seq is None else args.seq
        batch = 256 if args.batch is None else args.batch

    pipe = for_model(cfg, seq_len=seq, global_batch=batch, mode="markov")
    mgr = CheckpointManager(os.path.join(args.ckpt_dir, cfg.name))
    train(cfg, pipe, steps=args.steps, lr=args.lr, accum=args.accum,
          ckpt_manager=mgr, ckpt_every=args.ckpt_every,
          device=args.device)


if __name__ == "__main__":
    main()

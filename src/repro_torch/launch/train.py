"""Training launcher (PyTorch port of `repro/launch/train.py`).

    # a cluster: the full config on the production mesh, one rank a GPU
    torchrun --nnodes 32 --nproc-per-node 8 ... -m repro_torch.launch.train \
        --arch granite-3-2b --mesh single

    # one GPU: the full config (train_4k's 4,096 tokens, global batch 256)
    python -m repro_torch.launch.train --arch granite-3-2b --accum 64

    # the CPU: the smoke config at seq 64, batch 8, the same code path
    python -m repro_torch.launch.train --arch granite-3-2b --device cpu --steps 50

  --mesh none|single|multi   none: one device; single / multi: the (16, 16)
                      or (2, 16, 16) production mesh over the first 256 or
                      512 ranks torchrun started (NCCL on cuda, gloo on
                      cpu), parameters FSDP over "data" and TP over "model"
                      by the config's logical rules; ranks past the mesh
                      sit out (exit 0, no training, no checkpoint)
  --no-fsdp           disable ZeRO-style param sharding over "data"
  --accum N           gradient-accumulation micro-batching
  --ckpt-dir/--ckpt-every   checkpoints under <ckpt-dir>/<config name>; a
                      second call resumes from the latest one

`--device` takes the place of JAX's `--mesh cpu`; JAX's `LIBTPU_INIT_ARGS`
(TPU compiler flags) has no counterpart. (int8 error-feedback gradient
reduction lives in train/grad_compress.py.)
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config, get_rule_overrides
from repro_torch.data.pipeline import for_model
from repro_torch.launch.mesh import build_rules, make_production_mesh
from repro_torch.models.layers import set_logical_rules
from repro_torch.train.train_loop import train


def mesh_rules(arch: str, multi_pod: bool, batch: int, no_fsdp: bool) -> dict:
    """The logical rules `--mesh single|multi` trains under."""
    rules = build_rules(get_rule_overrides(arch), multi_pod=multi_pod, batch_size=batch)
    if no_fsdp:
        rules["embed"] = None
    return rules


def sits_out(mesh) -> bool:
    """True on a rank past `mesh`, which holds the process group's first
    ranks: it prints so and leaves the group. Every rank builds the mesh
    first (a collective)."""
    if mesh.get_coordinate() is not None:
        return False
    print(f"rank {dist.get_rank()} of {dist.get_world_size()} sits out: the mesh "
          f"{tuple(mesh.mesh.shape)} holds ranks 0-{mesh.mesh.numel() - 1}", flush=True)
    dist.destroy_process_group()
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b", choices=list(ARCH_IDS))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--mesh", default="none", choices=["none", "single", "multi"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-fsdp", action="store_true")
    args = ap.parse_args(argv)

    mesh = None
    if args.mesh == "none" and args.device == "cpu":
        cfg = get_config(args.arch).smoke_config()
        seq = 64 if args.seq is None else args.seq
        batch = 8 if args.batch is None else args.batch
    else:
        cfg = get_config(args.arch)
        seq = 4096 if args.seq is None else args.seq
        batch = 256 if args.batch is None else args.batch
    if args.mesh != "none":
        multi = args.mesh == "multi"
        n, shape = (512, (2, 16, 16)) if multi else (256, (16, 16))
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world < n:
            raise SystemExit(f"need {n} devices for mesh {shape}; have {world} — "
                             f"start {n} ranks with torchrun before --mesh {args.mesh}")
        if args.device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
        mesh = make_production_mesh(multi_pod=multi)
        if sits_out(mesh):
            return
        set_logical_rules(mesh_rules(args.arch, multi, batch, args.no_fsdp))

    pipe = for_model(cfg, seq_len=seq, global_batch=batch, mode="markov")
    mgr = CheckpointManager(os.path.join(args.ckpt_dir, cfg.name))
    try:
        train(cfg, pipe, steps=args.steps, lr=args.lr, accum=args.accum,
              ckpt_manager=mgr, ckpt_every=args.ckpt_every,
              device=args.device, mesh=mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()

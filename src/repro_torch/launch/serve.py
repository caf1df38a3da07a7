"""Serving launcher (PyTorch port of `repro/launch/serve.py`): batched
prefill + greedy decode of an architecture's smoke config, reporting
tokens/s.

    python -m repro_torch.launch.serve --arch granite-3-2b --batch 4 --new 32
    python -m repro_torch.launch.serve --arch granite-3-2b --device cpu

Parameters come from `init_params` with a generator seeded 0, the prompts
from the arch's token pipeline (`for_model(...).batch_at(0)`, labels
dropped); `--device` (default cuda) says where the engine runs. The
timed span ends when the ids are back on the host.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import for_model
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine


def main(argv=None) -> torch.Tensor:
    """Run the CLI → the generated (batch, new) int32 ids, on the CPU."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b", choices=list(ARCH_IDS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).smoke_config()
    if not cfg.has_decode:
        raise SystemExit(f"{args.arch} is encoder-only: no decode path")
    params = T.init_params(torch.Generator().manual_seed(0), cfg, device=args.device)
    pipe = for_model(cfg, seq_len=args.prompt_len, global_batch=args.batch)
    inputs = {k: v for k, v in pipe.batch_at(0).items() if k != "labels"}

    engine = ServeEngine(cfg, params,
                         max_seq=args.prompt_len + args.new + cfg.n_prefix_embeds,
                         device=args.device)
    t0 = time.time()
    out = engine.generate(inputs, n_new=args.new).cpu()
    dt = time.time() - t0
    toks = args.batch * args.new
    print(f"arch={cfg.name} generated {tuple(out.shape)} in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, incl. compile)")
    print("sample:", out[0][:16].numpy())
    return out


if __name__ == "__main__":
    main()

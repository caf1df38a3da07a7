"""End-to-end training example (PyTorch port of `examples/train_lm.py`):
train a ~100M-param granite-family model for a few hundred steps on the
synthetic markov stream, with checkpointing and resume.

    PYTHONPATH=src python examples/torch/train_lm.py --steps 300 [--device cuda|cpu]

Runs on the card unless `--device cpu` is given; the config, batch and
printed figures are the JAX example's. A second call with the same
`--ckpt` resumes from its latest checkpoint.
"""
import argparse

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import for_model
from repro_torch.train.train_loop import train
from repro_torch.utils import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default="artifacts/ckpt/train_lm_example_torch")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ~100M params: granite family, reduced width/depth
    cfg = get_config("granite-3-2b").replace(
        name="granite-100m", n_layers=6, d_model=512, n_heads=8,
        n_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=8192)
    n_params = 2 * cfg.vocab_padded * cfg.d_model + cfg.n_layers * (
        4 * cfg.d_model * cfg.d_model + 3 * cfg.d_model * cfg.d_ff)
    print(f"config {cfg.name}: ~{n_params/1e6:.0f}M params")

    pipe = for_model(cfg, seq_len=256, global_batch=16, mode="markov")
    mgr = CheckpointManager(args.ckpt, keep=2)
    params, _, losses = train(cfg, pipe, steps=args.steps, lr=1e-3,
                              accum=2, ckpt_manager=mgr, ckpt_every=100,
                              log_every=20, device=dev)
    print(f"first-10 mean loss {sum(losses[:10])/10:.3f} → "
          f"last-10 mean loss {sum(losses[-10:])/10:.3f}")


if __name__ == "__main__":
    main()

"""Deterministic, resumable, host-shardable synthetic data pipeline
(PyTorch port of `repro/data/pipeline.py`).

Every batch is a pure function of (seed, step, shard) — `batch_at(step)` —
so resume-after-preemption needs only the step counter (saved in the
checkpoint), and each data-parallel host can produce exactly its shard
without coordination.

Token stream modes:
- "markov": tokens follow the noisy affine recurrence
  x_{t+1} = (31·x_t + 7 + ε) mod V, ε ∈ {0, 1, 2}, so a small LM
  measurably learns (loss drops within a few hundred steps);
- "uniform": i.i.d. tokens (throughput benchmarking).

The draws come from a CPU `torch.Generator` seeded from (seed, step,
shard), so the stream is not JAX's (`jax.random` threefry with
`fold_in`): the two packages give different batches for one seed, with
the same laws. Tests that compare training across the packages feed both
the same numpy batches. Batches are tensors on the pipeline's device, the
CPU unless asked otherwise; the trainer moves them.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.utils import Device


@dataclass(frozen=True)
class PipelineSpec:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mode: str = "markov"
    frontend: str = ""          # "", "audio", "vision"
    d_model: int = 0
    n_prefix: int = 0


def for_model(cfg: ModelConfig, seq_len: int, global_batch: int,
              seed: int = 0, mode: str = "markov") -> "TokenPipeline":
    return TokenPipeline(PipelineSpec(
        vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=global_batch,
        seed=seed, mode=mode, frontend=cfg.frontend, d_model=cfg.d_model,
        n_prefix=cfg.n_prefix_embeds))


def _generator(seed: int, step: int, shard: int) -> torch.Generator:
    digest = hashlib.blake2b(f"{seed}:{step}:{shard}".encode(), digest_size=8).digest()
    return torch.Generator().manual_seed(int.from_bytes(digest, "little") >> 1)


class TokenPipeline:
    def __init__(self, spec: PipelineSpec, device: Device = "cpu"):
        self.spec = spec
        self.device = torch.device(device)

    def _tokens(self, gen: torch.Generator, batch: int) -> torch.Tensor:
        s = self.spec
        if s.mode == "uniform":
            return torch.randint(0, s.vocab_size, (batch, s.seq_len + 1), generator=gen)
        # markov: x_{t+1} = (a*x_t + c + eps) mod V, eps in {0, 1, 2}
        x = torch.randint(0, s.vocab_size, (batch,), generator=gen)
        eps = torch.randint(0, 3, (batch, s.seq_len + 1), generator=gen)
        a, c = 31, 7
        seq = torch.empty((batch, s.seq_len + 1), dtype=torch.int64)
        for t in range(s.seq_len + 1):
            x = (a * x + c + eps[:, t]) % s.vocab_size
            seq[:, t] = x
        return seq

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        """Pure: the batch (dict of tensors) for global step `step`.

        shard/n_shards slice the global batch for per-host data loading.
        """
        s = self.spec
        if s.global_batch % n_shards:
            raise ValueError(f"global batch {s.global_batch} does not split "
                             f"into {n_shards} shards")
        b_local = s.global_batch // n_shards
        gen = _generator(s.seed, step, shard)
        toks = self._tokens(gen, b_local).to(torch.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if s.frontend == "audio":
            out = {"frames": torch.randn((b_local, s.seq_len, s.d_model), generator=gen),
                   "labels": out["labels"]}
        elif s.frontend == "vision":
            out["patches"] = torch.randn((b_local, s.n_prefix, s.d_model), generator=gen)
        return {k: v.contiguous().to(self.device) for k, v in out.items()}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

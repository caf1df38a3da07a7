"""The port's data pipeline (`repro_torch.data.pipeline`) on the CPU.

`tests/test_data_pipeline.py` case for case on the port, plus the laws
the port keeps where its stream is not JAX's (a CPU `torch.Generator`
seeded from (seed, step, shard) in place of `jax.random`): the Markov
recurrence x_{t+1} = (31·x_t + 7 + ε) mod V with ε ∈ {0, 1, 2} on every
row, the same spec fields and batch layout as JAX's, and batches on the
pipeline's device.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import PipelineSpec, TokenPipeline, for_model  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers on the machine's cores, and threads that wait on each other
    there cost more than they give."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------- tests/test_data_pipeline.py, case for case

def test_deterministic_and_resumable():
    p = TokenPipeline(PipelineSpec(vocab_size=1000, seq_len=32, global_batch=8))
    b1 = p.batch_at(7)
    b2 = p.batch_at(7)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].device.type == "cpu" and b1["tokens"].dtype == torch.int32
    b3 = p.batch_at(8)
    assert not torch.equal(b1["tokens"], b3["tokens"])


def test_labels_are_next_tokens():
    p = TokenPipeline(PipelineSpec(vocab_size=1000, seq_len=32, global_batch=4))
    b = p.batch_at(0)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_host_sharding_partitions_batch():
    p = TokenPipeline(PipelineSpec(vocab_size=1000, seq_len=16, global_batch=8))
    shards = [p.batch_at(3, shard=i, n_shards=4) for i in range(4)]
    assert all(s["tokens"].shape == (2, 16) for s in shards)
    # shards are distinct
    assert not torch.equal(shards[0]["tokens"], shards[1]["tokens"])


def test_tokens_in_vocab_range():
    p = TokenPipeline(PipelineSpec(vocab_size=101, seq_len=64, global_batch=4))
    b = p.batch_at(0)
    assert b["tokens"].min() >= 0 and b["tokens"].max() < 101


def test_modality_batches():
    cfg = get_config("hubert-xlarge").smoke_config()
    p = for_model(cfg, seq_len=16, global_batch=2)
    b = p.batch_at(0)
    assert "frames" in b and b["frames"].shape == (2, 16, cfg.d_model)
    cfg = get_config("paligemma-3b").smoke_config()
    p = for_model(cfg, seq_len=16, global_batch=2)
    b = p.batch_at(0)
    assert b["patches"].shape == (2, cfg.n_prefix_embeds, cfg.d_model)


# ---------------------------------------------------------- the port's laws

@pytest.mark.parametrize("vocab", [64, 1000, 49_155])
def test_markov_recurrence_holds_on_every_row(vocab):
    p = TokenPipeline(PipelineSpec(vocab_size=vocab, seq_len=257, global_batch=6, seed=3))
    b = p.batch_at(11)
    seq = torch.cat([b["tokens"], b["labels"][:, -1:]], dim=1).long()
    eps = (seq[:, 1:] - (31 * seq[:, :-1] + 7)) % vocab
    assert bool(((eps >= 0) & (eps <= 2)).all())
    assert set(eps.unique().tolist()) == {0, 1, 2}     # every step of noise occurs


def test_uniform_mode_covers_the_vocabulary():
    p = TokenPipeline(PipelineSpec(vocab_size=16, seq_len=512, global_batch=4, mode="uniform"))
    b = p.batch_at(0)
    assert set(b["tokens"].unique().tolist()) == set(range(16))


def test_batch_layout_matches_jax():
    """Keys, shapes and dtypes as JAX's batches (values differ: another
    random stream), for text, audio and vision configs, sharded too."""
    for arch in ("granite-3-2b", "hubert-xlarge", "paligemma-3b"):
        jb = jpipe.for_model(jget_config(arch).smoke_config(), 16, 8).batch_at(2, 1, 2)
        tb = for_model(get_config(arch).smoke_config(), 16, 8).batch_at(2, 1, 2)
        assert set(jb) == set(tb)
        for k in jb:
            assert tuple(jb[k].shape) == tuple(tb[k].shape), (arch, k)
            assert str(np.asarray(jb[k]).dtype) == str(tb[k].dtype).replace("torch.", "")
    assert [f.name for f in dataclasses.fields(jpipe.PipelineSpec)] == \
        [f.name for f in dataclasses.fields(PipelineSpec)]


def test_seed_changes_the_stream_and_iteration_walks_steps():
    a = TokenPipeline(PipelineSpec(vocab_size=1000, seq_len=16, global_batch=2, seed=0))
    b = TokenPipeline(PipelineSpec(vocab_size=1000, seq_len=16, global_batch=2, seed=1))
    assert not torch.equal(a.batch_at(0)["tokens"], b.batch_at(0)["tokens"])
    it = iter(a)
    for step in range(3):
        assert torch.equal(next(it)["tokens"], a.batch_at(step)["tokens"])


def test_uneven_shards_are_refused():
    p = TokenPipeline(PipelineSpec(vocab_size=10, seq_len=4, global_batch=6))
    with pytest.raises(ValueError, match="does not split"):
        p.batch_at(0, shard=0, n_shards=4)

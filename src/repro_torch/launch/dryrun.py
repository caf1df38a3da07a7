"""The card's roofline constants and the dry run's one-line summary
(PyTorch port of what `repro/launch/ann_dryrun.py` imports from
`repro/launch/dryrun.py`: `PEAK_FLOPS`, `HBM_BW`, `ICI_BW`, `fmt_summary`).

JAX's constants are a TPU v5e's; these are one NVIDIA H100 SXM's. A
collective's rate depends on where its group lies:

- inside one node of 8 cards, NVLink: 450e9 B/s each way per card;
- across nodes, the card's own network port: 400 Gb/s NDR InfiniBand,
  50e9 B/s each way, one port a card as in NVIDIA's DGX H100.

The ANN dry run's 256 and 512 shards are 32 and 64 nodes of 8, so every
ring step of their all-gather that leaves a node runs at the network's
rate, and a ring is as fast as its slowest step: `collective_bw` gives
the network's rate to any group of more than 8 cards.

The LM cells of JAX's `dryrun.py` (`run_cell`, over `specs.py` and
`mesh.py`'s sharding rules) wait for the slice that ports the LM's FSDP +
TP sharding onto a torch `DeviceMesh`; they will count their per-device
program with `launch/op_analysis.py`, as the ANN dry run does.
"""
from __future__ import annotations

# The H100 SXM's published dense peaks (NVIDIA's data sheet; no sparsity),
# for the dtypes the port computes in. Its TF32 peak, 495e12, prices no
# product: the port keeps TF32 off.
PEAK_FLOPS = {
    "bfloat16": 989e12,             # tensor cores
    "float32": 67e12,               # outside the tensor cores
}
HBM_BW = 3.35e12                    # bytes/s, the H100 SXM's HBM3
NVLINK_BW = 450e9                   # bytes/s each way per card, inside a node
NET_BW = 50e9                       # bytes/s: 400 Gb/s NDR, one port a card
NODE_CARDS = 8


def collective_bw(n_chips: int) -> float:
    """Bytes/s of one card's collective traffic in a group of n_chips:
    NVLink inside one node, the network port beyond it."""
    return NVLINK_BW if n_chips <= NODE_CARDS else NET_BW


def compute_s(flops_by_dtype: dict) -> float:
    """Seconds of the products, each dtype's FLOPs at its own peak. f32
    products run outside the tensor cores: the port keeps TF32 off
    (`utils.set_f32_precision`)."""
    return sum(f / PEAK_FLOPS[dt] for dt, f in flops_by_dtype.items())


def fmt_summary(r: dict) -> str:
    """JAX's one-line summary of a dry-run result."""
    if "skipped" in r:
        return (f"{r['arch']:22s} {r['shape']:12s} {r['mesh']:6s} "
                f"SKIP ({r['skipped']})")
    rf = r["roofline"]
    mem_gb = r["memory"]["peak_bytes"] / 2**30
    return (f"{r['arch']:22s} {r['shape']:12s} {r['mesh']:6s} "
            f"compile {r['compile_s']:6.1f}s mem {mem_gb:6.2f}GiB "
            f"compute {rf['compute_s']:.3g}s mem-term {rf['memory_s']:.3g}s "
            f"coll {rf['collective_s']:.3g}s → {rf['dominant']}"
            f" useful={rf['useful_flops_ratio']:.2f}")

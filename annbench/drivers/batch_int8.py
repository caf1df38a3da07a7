"""Closed-loop batch search (ann-benchmarks' batch mode) over an index
whose rows are held in a primary partition and two SOAR spills, with int8
rerank rows.

Set-up, the window, the traced slice and the end-to-end metrics are
`drivers/batch.py`'s, unedited: `qps` over the whole window, `recall10`
against exact f32 inner-product neighbours of the benchmark's own vectors.

Correctness (`numbers`):

- the rerank rows the engine serves, against the plain quantization of
  the benchmark's vectors (`reference/int8.py`): `int8_bad`, rows whose
  codes or scale differ bit for bit (served f32 rows: rows that are not
  the plain rows dequantized), and `rerank_bytes_a_row`, the served rerank
  table's bytes over its row capacity (d + 4 for int8 codes and a scale);
- the index, against the benchmark's vectors and the index's codebooks
  (`reference/spills.py`): `assign_gap`, `spill_gap` over both spills,
  `code_gap`, `slot_bad` (every row held exactly three times);
- every distinct set of answers the window returned (`compare.answers`),
  against `reference/search.py::ann_search` over the index with the plain
  rows dequantized as its rerank rows: `score_err` (a returned score
  against ⟨q, row⟩ of the dequantized row), `rank_gap`, `miss_share`,
  `bad_ids`, `dup_ids`, on the configuration's `check_sample` queries.

The control puts the reference at TF32 in the program's place: its own
columns and codes, its quantization of the vectors rounded to TF32, and
its search at TF32.
"""
from __future__ import annotations

from pathlib import Path

import torch

from annbench import compare, harness, program
from annbench.reference import int8 as ri
from annbench.reference import search as ref
from annbench.reference import spills as rs
from annbench.reference.precision import tf32_round

batch = harness.load(Path(__file__).with_name("batch.py"))
setup, window, traced, end_to_end = batch.setup, batch.window, batch.traced, batch.end_to_end


def served_rerank(engine, want: ri.Rows) -> dict:
    """`int8_bad` and `rerank_bytes_a_row` of the table the engine serves:
    int8 codes and scales (`q`, `scale`), or f32 rows."""
    table = engine.index.rerank
    n = want.q.shape[0]
    if hasattr(table, "q") and hasattr(table, "scale"):
        bad = ri.bad_rows(table.q[:n], table.scale[:n], want)
        nbytes = table.q.numel() * table.q.element_size() \
            + table.scale.numel() * table.scale.element_size()
        cap = table.q.shape[0]
    else:
        rows = table[:n].to(torch.float32)
        bad = int((rows.view(torch.int32) != ri.dequantize(want).view(torch.int32)).any(1).sum())
        nbytes, cap = table.numel() * table.element_size(), table.shape[0]
    return {"int8_bad": bad, "rerank_bytes_a_row": nbytes / cap}


def numbers(ctx, control: bool = False) -> dict:
    s, cfg = ctx.state, ctx.cfg
    v = s["v"]
    X = v.X
    e, ix = cfg["engine"], cfg["index"]
    lam, spills = float(ix["lam"]), int(ix["n_spills"])
    want = ri.quantize(X)
    rows = ri.dequantize(want)
    st = program.index_state(s["engine"], rows)
    if control:
        out = rs.index_control(X, st.centroids, st.pq_centers, lam, spills)
        tf = ri.quantize(tf32_round(X))
        out.update(int8_bad=ri.bad_rows(tf.q, tf.scale, want),
                   rerank_bytes_a_row=float(tf.q.shape[1] + 4))
    else:
        point, part, slot = compare.slots(st.part_ids)
        codes = st.part_codes.reshape(-1, st.part_codes.shape[-1])[slot]
        out = rs.index(X, st.centroids, st.pq_centers, point, part, codes, lam, 1 + spills)
        out.update(served_rerank(s["engine"], want))
    sel = batch.sample(ctx).to(v.Q.device)
    Q = v.Q[sel]
    kw = dict(top_t=e["top_t"], budget=e["rerank_budget"], k=cfg["search"]["k"])
    ref_ids, _ = ref.ann_search(st, Q, **kw)
    if control:
        sets = [ref.ann_search(st, Q, prec="tf32", **kw)]
    else:
        sel_np = sel.cpu().numpy()
        sets = [(torch.from_numpy(a[0][sel_np]), torch.from_numpy(a[1][sel_np]))
                for a in ctx.rec["answers"]]
    out.update(compare.worst(*(compare.answers(rows, Q, i, sc, ref_ids) for i, sc in sets)))
    return out

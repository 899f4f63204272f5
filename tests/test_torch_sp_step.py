"""The sharding plan's train step and decode step, and sequence
sharding (`distributed.sp`), on a 4-rank gloo (2, 2) ("data", "model")
mesh, against the unsharded port on the same seeded weights and batch.

One spawn (`launch.mesh.spawn`, tests/torch_plan_ranks.py, no jax),
four cells of float32 smoke configs, batch 4 x 32: SmolLM-135M (3 query
heads, 1 KV head: the axis does not split the heads, so each rank
attends over its share of the (batch row, KV head) groups; the decode
cache split over its sequence), Command-R-35B (8 query heads, 2 KV
heads: attention on each rank's heads, the cache split over its heads),
SmolLM-135M with 4 query heads on its 1 KV head (the query heads split
over the TP axis, the KV head repeated to its width, so that each rank's
2 query heads find theirs locally; the cache split over its sequence),
and Command-R-35B again on a (1, 4) mesh of the same ranks (its 2 KV
heads repeated to the 4-wide TP axis: rank r's query heads 2r, 2r + 1
must meet KV head r // 2).

Bounds: the loss within 1e-5 relative; every parameter after the step
within 1e-4 (absolute; the leaves are at most ~0.5, and AdamW's first
step moves a parameter by about lr = 3e-4 whatever its gradient's size,
so a zero-initialised bias is judged on that scale, not relative to
its own largest entry); the decode logits within 1e-5 of their largest
entry and the cache entry the step writes within 1e-6.
`seq_constraint` gives (Shard(0), Shard(1)) with the values unchanged,
skips an odd sequence length, and passes a plain tensor through.
"""
from __future__ import annotations

import os
import sys

from repro_torch.launch.mesh import spawn

HERE = os.path.dirname(os.path.abspath(__file__))
# (name, arch, batch, seq, config overrides, mesh: None for (2, 2))
CELLS = [("smollm-135m", "smollm-135m", 4, 32, {}, None),
         ("command-r-35b", "command-r-35b", 4, 32, {}, None),
         ("kv-repeat", "smollm-135m", 4, 32, {"num_heads": 4}, None),
         ("kv-repeat-tp4", "command-r-35b", 4, 32, {}, (1, 4))]


def test_plan_step_and_decode_on_gloo_2x2():
    sys.path.insert(0, HERE)
    try:
        from torch_plan_ranks import plan_cells
        got = spawn(plan_cells, 4, "gloo", "cpu", 2, 2, CELLS, timeout=300)
    finally:
        sys.path.remove(HERE)
    for rank, out in enumerate(got):
        seq = out["seq"]
        assert seq["placements"] == ["S(0)", "S(1)"], seq
        assert seq["named"] == ["S(1)", "S(2)"], seq
        assert seq["odd"] == ["S(0)", "R"], seq
        assert seq["equal"] and seq["plain"], seq
        for arch, *_ in CELLS:
            r = out[arch]
            want, loss = r["loss"]
            assert abs(loss - want) <= 1e-5 * abs(want), (rank, arch, r)
            gw, g = r["grad_norm"]
            assert abs(g - gw) <= 1e-5 * gw, (rank, arch, r)
            assert r["param_err"] <= 1e-4, (rank, arch, r)
            assert r["decode_err"] <= 1e-5, (rank, arch, r)
            assert r["cache_err"] <= 1e-6, (rank, arch, r)
            # ZeRO-1: m of the embedding split over data on its width and
            # over model on its vocab (over data too, when data is 1)
            assert r["m_placements"] == ["S(1)", "S(0)"], (arch, r)
        assert out["smollm-135m"]["cache_placements"] == ["S(0)", "S(2)"]
        assert out["command-r-35b"]["cache_placements"] == ["S(0)", "S(1)"]
        assert out["kv-repeat"]["cache_placements"] == ["S(0)", "S(2)"]
        assert [(out[a]["attn_split"], out[a]["kv_repeat"]) for a, *_ in
                CELLS] == [("groups", True), ("heads", False),
                           ("heads", True), ("heads", True)]

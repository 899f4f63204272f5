"""Roofline terms per (arch x shape x mesh) from the dry-run records
(`launch.dryrun`), priced for the H100 (the port's
`repro.analysis.roofline`).

    compute term    = FLOPs_per_device / peak FLOP/s
    memory term     = bytes_per_device / HBM bandwidth
    collective term = wire_bytes_per_device / link bandwidth

Hardware model, one H100 SXM (datasheet figures, not measured here):
989e12 FLOP/s dense bf16 on the tensor cores, 3.35e12 B/s of HBM3 (the
bounds the port's kernel table uses), and one link rate of 50e9 B/s a
GPU: one 400 Gb/s NDR InfiniBand link each. A 16-wide ``model`` axis
spans two 8-GPU nodes, so its rings cross the network, and the slower
link sets the ring's pace (NVLink within a node runs at 450e9 B/s a
direction).

Wire-byte multipliers per collective kind (ring algorithms):
    all-reduce      2x tensor bytes   (reduce-scatter + all-gather phases)
    all-gather      1x gathered bytes
    reduce-scatter  1x output shard bytes
    all-to-all      1x
    collective-permute 1x

Two memory columns:
  * mem(ops): every eager op's bytes (`analysis.counts`), with the flash
    forward at its kernel's ideal stream;
  * mem(kernel): mem(ops) less the kernel-scope bytes, plus the analytic
    ideal stream of every attention and scan region (inputs and outputs
    once a pass), the reference's kernel credit.

MODEL_FLOPS uses 6 N_active D (train), 2 N_active D (prefill) or 2
N_active B (decode); its ratio to the counted FLOPs exposes replicated
attention, remat and masked-block overheads.
"""
from __future__ import annotations

import glob
import json
import math
import os
from typing import Dict, List, Optional

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 50e9

WIRE_MULT = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def wheel_kernel_roofline(name: str, rows: int, bytes_hbm: float,
                          flops: float, measured_us: Optional[float] = None
                          ) -> Dict:
    """Roofline attribution of one delivery-wheel kernel invocation:
    `bytes_hbm` / `flops` are the analytic totals of its ideal stream
    (inputs and outputs once) and arithmetic, priced by the model above;
    the dominant term's time is the kernel's floor (``ideal_us``).
    `measured_us`, when given, is a measured time, and the ratio records
    how far it sits above the floor."""
    t_mem = bytes_hbm / HBM_BW
    t_comp = flops / PEAK_FLOPS
    ideal_us = max(t_mem, t_comp) * 1e6
    row = {
        "kernel": name,
        "rows": int(rows),
        "bytes_hbm": float(bytes_hbm),
        "flops": float(flops),
        "t_mem_us": round(t_mem * 1e6, 4),
        "t_compute_us": round(t_comp * 1e6, 4),
        "dominant": "memory" if t_mem >= t_comp else "compute",
        "ideal_us": round(ideal_us, 4),
    }
    if measured_us is not None:
        row["measured_us"] = round(float(measured_us), 2)
        row["us_per_row"] = round(float(measured_us) / max(rows, 1), 4)
        row["measured_over_ideal"] = round(
            float(measured_us) / max(ideal_us, 1e-9), 1)
    return row


def _walk(tree, keys=()):
    """(the dict keys on the path, leaf) of every leaf of a tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, keys + (k,))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _walk(v, keys)
    else:
        yield keys, tree


def active_params(cfg) -> float:
    """Matmul parameters touched a token (MoE: top-k + shared only)."""
    from repro_torch.models.model import abstract_params

    total = 0.0
    moe_total = 0.0
    for keys, leaf in _walk(abstract_params(cfg)):
        n = float(math.prod(leaf.shape))
        if "router" in keys or any("norm" in str(k) for k in keys):
            continue
        if any(k in ("w_gate", "w_up", "w_down") for k in keys) \
                and len(leaf.shape) >= 3 and cfg.moe is not None \
                and leaf.shape[-3] == cfg.moe.n_experts:
            moe_total += n
            continue
        total += n
    if cfg.moe is not None and moe_total:
        total += moe_total * cfg.moe.top_k / cfg.moe.n_experts
    return total


def model_flops(cfg, shape, n_active: float) -> float:
    d_tokens = shape.seq_len * shape.global_batch
    if shape.kind == "train":
        return 6.0 * n_active * d_tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * d_tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token a stream


def analytic_kernel_bytes(cfg, shape, n_devices: int) -> float:
    """Ideal HBM stream of the kernel regions, per device: attention
    reads q, k, v and writes o once a pass; passes = 1 (inference) or
    ~3 (forward, backward, remat recompute). Scan mixers: a, u read and
    h written."""
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1
    dt = 2  # bf16
    passes = 3 if shape.kind == "train" else 1
    per_layer = 0.0
    for pat, n in cfg.segments():
        for bd in pat:
            if bd.mixer in ("attn", "swa", "bidir", "mla", "dec"):
                hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.hd
                if bd.mixer == "mla":
                    hkv = cfg.num_heads
                    dh = cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim
                per_layer += n * (2 * b * s * hq * dh
                                  + 2 * b * s * hkv * dh) * dt
            elif bd.mixer == "rglru":
                w = cfg.rec_width or cfg.d_model
                per_layer += n * 3 * b * s * w * dt
            elif bd.mixer == "mlstm":
                per_layer += n * 5 * b * s * 2 * cfg.d_model * dt
    return passes * per_layer / n_devices


def load_records(directory: str) -> List[Dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(f) as fh:
            out.append(json.load(fh))
    return out


def roofline_row(rec: Dict) -> Optional[Dict]:
    from repro_torch.configs import base as cbase
    from repro_torch.configs.registry import get_config

    if rec.get("status") != "OK":
        return None
    cfg = get_config(rec["arch"])
    shape = {s.name: s for s in cbase.ALL_SHAPES}[rec["shape"]]
    chips = rec.get("n_devices", 512 if rec["multi_pod"] else 256)
    flops_dev = rec["cost"]["flops"]
    bytes_dev = rec["cost"]["bytes_accessed"]
    kscope = rec["cost"].get("kernel_scope_bytes", 0.0)
    kideal = analytic_kernel_bytes(cfg, shape, chips)
    wire = sum(WIRE_MULT.get(k, 1.0) * v
               for k, v in rec["collectives"].items())

    t_comp = flops_dev / PEAK_FLOPS
    t_mem_ops = bytes_dev / HBM_BW
    t_mem_k = max(bytes_dev - kscope + kideal, 0.0) / HBM_BW
    t_coll = wire / LINK_BW

    n_act = active_params(cfg)
    mflops = model_flops(cfg, shape, n_act)
    useful = mflops / max(flops_dev * chips, 1.0)

    terms = {"compute": t_comp, "memory": t_mem_k, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    step_time = max(terms.values())
    mfu = (mflops / chips / max(step_time, 1e-12)) / PEAK_FLOPS
    return {
        "arch": rec["arch"], "shape": rec["shape"],
        "mesh": "2x16x16" if rec["multi_pod"] else "16x16",
        "chips": chips,
        "t_compute_s": t_comp, "t_mem_ops_s": t_mem_ops,
        "t_mem_kernel_s": t_mem_k, "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops": mflops, "counted_flops_total": flops_dev * chips,
        "useful_ratio": useful,
        "roofline_mfu": mfu,
    }


def advice(row: Dict) -> str:
    d = row["dominant"]
    if d == "compute":
        if row["useful_ratio"] < 0.4:
            return ("compute-bound with low useful ratio: cut replicated "
                    "or masked-block attention work and remat recompute "
                    "(save-attention-output policy)")
        return "compute-bound near useful peak: only faster arithmetic helps"
    if d == "memory":
        return ("HBM-bound: fuse the largest streams, shrink activation "
                "round-trips (fused kernels, bigger blocks)")
    return ("collective-bound: overlap the gradient reduction with the "
            "backward, shard optimizer state, gate/compress sync "
            "(threshold mode)")


def table(records: List[Dict], multi_pod: Optional[bool] = None) -> str:
    rows = []
    for r in records:
        if multi_pod is not None and r.get("multi_pod") != multi_pod:
            continue
        row = roofline_row(r)
        if row:
            rows.append(row)
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    hdr = ("| arch | shape | mesh | compute s | mem(ops) s | mem(kernel) s | "
           "collective s | dominant | useful | roofline-MFU |")
    lines = [hdr, "|" + "---|" * 10]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['t_compute_s']:.3e} | {r['t_mem_ops_s']:.3e} "
            f"| {r['t_mem_kernel_s']:.3e} | {r['t_collective_s']:.3e} "
            f"| **{r['dominant']}** | {r['useful_ratio']:.2f} "
            f"| {r['roofline_mfu']*100:.1f}% |")
    return "\n".join(lines)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/torch/dryrun")
    ap.add_argument("--out", default="results/torch/roofline.md")
    args = ap.parse_args(argv)
    recs = load_records(args.dir)
    md = ["# Roofline table, H100 datasheet rates (single-pod 16x16)", "",
          table(recs, multi_pod=False), "",
          "# Roofline table, H100 datasheet rates (multi-pod 2x16x16)", "",
          table(recs, multi_pod=True), ""]
    skips = [r for r in recs if r.get("status") == "SKIP"]
    if skips:
        md.append("## Skipped cells (full-attention archs at 500k)")
        for r in skips:
            md.append(f"- {r['arch']} x {r['shape']} "
                      f"({'mp' if r['multi_pod'] else 'sp'})")
    fails = [r for r in recs if r.get("status") == "FAIL"]
    if fails:
        md.append("## Failed cells (the op DTensor could not place)")
        for r in fails:
            md.append(f"- {r['arch']} x {r['shape']} "
                      f"({'mp' if r['multi_pod'] else 'sp'}): "
                      f"{r.get('op') or r['error'][:120]}")
    txt = "\n".join(md)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(txt)
    print(txt)


if __name__ == "__main__":
    main()

"""Roofline analysis of a dry run on H100s (no card needed); port of
`repro.launch.analysis`.

Terms, per device:
    t_compute = dot FLOPs            / 989e12 FLOP/s  (bfloat16 dense)
    t_memory  = bytes                / 3.35e12 B/s    (HBM3)
    t_coll    = collective bytes     / the collective bandwidth below

The figures are NVIDIA's H100 SXM5 datasheet peaks: 989.4 TFLOP/s of
dense bfloat16 tensor-core math (1,979 with 2:4 sparsity, which nothing
here uses) and 3.35 TB/s of HBM3.  A collective moves over NVLink 4
within a node of eight H100s: 900 GB/s per GPU both ways together, so
450e9 B/s each way.  A mesh larger than one node crosses nodes, and its
ring runs at the slowest link, one 400 Gb/s NDR InfiniBand adapter per
GPU: 50e9 B/s.  Both production meshes (256 and 512 devices) take the
second.  The bytes come from the walker (`launch.op_cost`): the eager
program's traffic, op by op, unfused.

collective bytes follow the reference's result-size convention (the
summed result sizes of all-reduce / all-gather / reduce-scatter /
all-to-all / collective-permute; a ring's 2(n-1)/n factor is uniform
across variants, so comparisons are exact).

MODEL_FLOPS = 6·N·D (dense train), 6·N_active·D (MoE), 2·N·D forward-only,
2·N_active·B for one decode token a sequence; MODEL_FLOPS / dot FLOPs is
the useful-compute fraction.  Attention's FLOPs are left out of
MODEL_FLOPS, so the ratio is conservative.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np

PEAK_FLOPS = 989e12        # bfloat16 dense, FLOP/s per H100 SXM
HBM_BW = 3.35e12           # HBM3, B/s per H100 SXM
NVLINK_BW = 450e9          # NVLink 4, B/s per GPU each way, within a node
NODE_BW = 50e9             # 400 Gb/s NDR InfiniBand, B/s per GPU, across
GPUS_PER_NODE = 8

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def collective_bw(n_devices: int) -> float:
    """The bandwidth a collective over `n_devices` runs at: NVLink within
    one node, InfiniBand once the devices span nodes."""
    return NVLINK_BW if n_devices <= GPUS_PER_NODE else NODE_BW


def memory_summary(walk: Mapping) -> Dict[str, float]:
    """Argument, output and temp bytes per device from the walker's record
    (`op_cost.analyze(...)["memory"]`, or the same keys), and their peak:
    arguments + the peak of live intermediates."""
    mem = walk.get("memory", walk)
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes")
    out = {k: float(mem.get(k, 0.0)) for k in keys}
    out["peak_bytes_estimate"] = float(mem.get(
        "peak_bytes_estimate",
        out["argument_size_in_bytes"] + out["output_size_in_bytes"]
        + out["temp_size_in_bytes"]))
    return out


def roofline(cost: Dict[str, float], coll: Dict[str, float],
             n_devices: int) -> Dict[str, float]:
    """The three H100 terms of one step and the dominant one; `cost` and
    `coll` per device, as the walker gives them."""
    flops_g = cost["flops_per_device"] * n_devices
    bytes_g = cost["bytes_per_device"] * n_devices
    coll_g = sum(coll.get(k, 0.0) for k in COLLECTIVES) * n_devices
    t_c = flops_g / (n_devices * PEAK_FLOPS)
    t_m = bytes_g / (n_devices * HBM_BW)
    t_x = coll_g / (n_devices * collective_bw(n_devices))
    dom = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))[1]
    return {
        "hlo_flops_global": flops_g,
        "hlo_bytes_global": bytes_g,
        "collective_bytes_global": coll_g,
        "t_compute_s": t_c,
        "t_memory_s": t_m,
        "t_collective_s": t_x,
        "dominant": dom,
        "bound_step_time_s": max(t_c, t_m, t_x),
    }


# ---------------------------------------------------------------------------
# model FLOPs accounting
# ---------------------------------------------------------------------------
def count_params(defs: Dict) -> Tuple[int, int]:
    """(total, active) parameter counts from ParamDefs (embeddings
    included: they are matmul'd in the loss)."""
    total = 0
    for d in defs.values():
        total += int(np.prod(d.shape))
    return total, total


def count_active_params(defs: Dict, cfg) -> int:
    """Params one token uses: each routed-expert tensor scaled by
    top_k / n_experts; shared experts, the router and the rest count
    fully."""
    active = 0
    for path, d in defs.items():
        n = int(np.prod(d.shape))
        if "/moe/w" in path or path.startswith("moe/w") or "/moe/" in path:
            if "/shared" not in path and "router" not in path:
                n = int(n * cfg.top_k / max(cfg.n_experts, 1))
        active += n
    return active


def model_flops(cfg, defs, cell, n_new_tokens: int = 1) -> Dict[str, float]:
    """MODEL_FLOPS: 6·N·D train, 2·N·D forward (prefill), 2·N_active·B
    for decode (one token per sequence in the batch)."""
    total, _ = count_params(defs)
    active = count_active_params(defs, cfg)
    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        return {"params": total, "active_params": active,
                "model_flops": 6.0 * active * B * S}
    if cell.kind == "prefill":
        return {"params": total, "active_params": active,
                "model_flops": 2.0 * active * B * S}
    return {"params": total, "active_params": active,
            "model_flops": 2.0 * active * B * n_new_tokens}

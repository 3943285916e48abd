"""Multi-pod dry run of the port; counterpart of `repro.launch.dryrun`.

For every (architecture × input shape) cell — and the LP solver's own
workload — walk one production step as one device of:
  * the single-pod mesh  (16, 16)        ("data", "model")       256 devices
  * the multi-pod mesh   (2, 16, 16)     ("pod", "data", "model") 512 devices

The reference lowers and compiles on 256 / 512 fake host devices.  Here a
process group of the mesh's size runs in this one process on torch's
"fake" backend (`launch.mesh.fake_ranks`: every collective returns at
once), the params, optimizer state and inputs are `meta` tensors (no
storage) placed as DTensors by the logical sharding rules
(`repro_torch.sharding`), and the step runs once, eagerly, under the
per-device op walker (`launch.op_cost`): dot FLOPs, bytes, collective
bytes and memory of rank 0, and from them the H100 roofline
(`launch.analysis`).  A failure here is a bug in the sharding design.
Nothing runs on a card.

The LP cell (`lower_lp`) reckons one rank's slab of the 100,000 × 10,000
instance (width 32, rows padded to the rank count) with the launch census
(`launch.census`): its kernels' bytes and the all-reduce of m·J + 2
floats a `DistributedMatchingObjective` makes an evaluation.  It launches
no kernel.

Results go to build/dryrun/<mesh>/<cell>.json, cached by cell key
(--force recomputes):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch lp-matching

Exit 1 on any FAIL.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from types import SimpleNamespace
from typing import Dict, Optional

import torch

from .. import sharding
from ..configs import arch_ids, get_config
from ..models import SHAPES, build_model, cell_applicable
from ..models.layers import ShapeDtype
from . import analysis, op_cost
from .mesh import MeshSpec, device_mesh, fake_ranks, make_production_mesh

RESULTS = os.path.normpath(os.path.join(os.path.dirname(__file__),
                                        "../../../build/dryrun"))


def _place(tree, specs, mesh):
    """A tree of `ShapeDtype`s (or meta tensors) -> the same tree of meta
    DTensors on `mesh`, each placed by its spec (shape-fitted)."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, (ShapeDtype, torch.Tensor)):
        shape = tuple(tree.shape)
        t = torch.empty(shape, dtype=tree.dtype, device="meta")
        spec = sharding.sanitize_spec(specs, shape, mesh)
        return distribute_tensor(t, mesh, sharding.placements_for(spec, mesh))
    if isinstance(tree, dict):
        return {k: _place(tree[k], specs[k], mesh) for k in tree}
    return type(tree)(_place(t, s, mesh) for t, s in zip(tree, specs))


@contextlib.contextmanager
def _greedy_plans(ndim: int):
    """On a mesh of more than 2 dims, DTensor's redistributions planned
    greedily.  Its min-cost planner, which it must use for a dim sharded
    over several mesh dims (the multi-pod "batch") and which its sharding
    propagation calls for every strategy it weighs, searches a graph that
    grows with the mesh's dims: one bmm of a train step took 157 s on the
    (2, 16, 16) mesh.  Greedy plans take a worse strategy at times, so the
    multi-pod counts overstate what a better plan moves.  A 2-D mesh keeps
    the min-cost planner (its counts are the ones held to the
    reference's)."""
    import torch.distributed.tensor._redistribute as redist

    plan = getattr(redist, "_gen_transform_infos_non_cached", None)
    if ndim <= 2 or plan is None:
        yield
        return

    def greedy(src, dst, use_graph_based_transform=None):
        try:
            planner = redist.get_redistribute_planner(src.device_mesh,
                                                      src.tensor_meta)
            return planner.generate_greedy_transform_infos(src, dst)
        except Exception:        # a plan only the min-cost planner finds
            return plan(src, dst, use_graph_based_transform)

    redist._gen_transform_infos.cache_clear()
    redist._gen_transform_infos_non_cached = greedy
    try:
        yield
    finally:
        redist._gen_transform_infos_non_cached = plan
        redist._gen_transform_infos.cache_clear()


def _walk(fn, *args, extra_arg_bytes: int = 0) -> Dict:
    """fn(*args) once under the walker, plain tensors taken as
    replicated; its counts, memory, and the seconds it took."""
    from torch.distributed.tensor.experimental import implicit_replication

    t0 = time.time()
    with implicit_replication():
        walk = op_cost.analyze(fn, *args)
    walk["walk_s"] = time.time() - t0
    walk["memory"]["argument_size_in_bytes"] += extra_arg_bytes
    walk["memory"]["peak_bytes_estimate"] += extra_arg_bytes
    return walk


def _record(walk: Dict, n_dev: int) -> Dict:
    cost = {"flops_per_device": walk["flops_per_device"],
            "bytes_per_device": walk["bytes_per_device"]}
    coll = {**walk["collectives"], "count": walk["collective_count"]}
    mem = analysis.memory_summary(walk)
    return {"memory": mem, "cost": cost, "collectives": coll,
            "roofline": analysis.roofline(cost, coll, n_dev),
            "hbm_per_device_gb": mem["peak_bytes_estimate"] / 1e9}


def lower_cell(arch: str, shape_name: str, mesh: MeshSpec,
               moe_impl: str = "einsum", extra_rules: Optional[dict] = None,
               overrides: Optional[dict] = None) -> Dict:
    """Walk one (arch × shape) cell as rank 0 of `mesh`; return metrics.

    `overrides` applies dataclasses.replace on the ModelConfig (e.g.
    {"n_heads": 64} for the head-padding variant)."""
    from ..optim import AdamW, OptState, cosine_schedule
    from ..training.trainer import TrainState, make_train_step

    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cell = SHAPES[shape_name]
    ok, why = cell_applicable(cfg, cell)
    if not ok:
        return {"status": "SKIP", "reason": why}
    model = build_model(cfg, moe_impl=moe_impl)
    rules = dict(extra_rules or {})
    if cell.kind == "decode":
        # serving layout: no ZeRO-3 weight gathers per generated token
        rules = {**sharding.SERVING_RULES, **rules}
    with fake_ranks(mesh.size), _greedy_plans(len(mesh.dims)):
        # typed "cuda", the devices it stands for (no tensor is on a card:
        # all are meta); on a "cpu" mesh DTensor turns each all-to-all into
        # an all-gather, as gloo has no all-to-all
        dm = device_mesh(mesh, "cuda")
        with sharding.use_mesh_rules(dm, rules or None):
            defs = model.param_defs()
            params_ps = model.param_pspecs()
            params = _place(model.abstract_params(), params_ps, dm)
            in_specs = model.input_specs(cell)
            if cell.kind == "train":
                opt = AdamW(state_dtype=cfg.optstate_dtype)
                step = make_train_step(model.loss, opt,
                                       cosine_schedule(3e-4, 100, 10000),
                                       microbatches=cfg.microbatches,
                                       accum_dtype=cfg.accum_dtype)
                sdt = getattr(torch, cfg.optstate_dtype)
                moments = {k: ShapeDtype(d.shape, sdt)
                           for k, d in defs.items()}
                scalar = ShapeDtype((), torch.int32)
                state = TrainState(
                    step=_place(scalar, (), dm),
                    params=params,
                    opt_state=OptState(
                        count=_place(scalar, (), dm),
                        mu=_place(moments, params_ps, dm),
                        nu=_place(moments, params_ps, dm)))
                batch = _place(in_specs, model.input_pspecs(cell), dm)
                walk = _walk(step, state, batch)
            elif cell.kind == "prefill":
                batch = _place(in_specs, model.input_pspecs(cell), dm)
                walk = _walk(model.prefill, params, batch)
            else:
                caches = _place(in_specs["caches"], model.cache_pspecs(), dm)
                tokens = _place(in_specs["tokens"],
                                sharding.spec_for(("cache_batch", None)), dm)
                # pos is a Python int to the port's decode; the reference
                # passes an int32 scalar, 4 argument bytes
                walk = _walk(model.decode_step, params, caches, tokens,
                             cell.seq_len // 2, extra_arg_bytes=4)
    mf = analysis.model_flops(cfg, defs, cell)
    rec = _record(walk, mesh.size)
    return {
        "status": "OK", "arch": arch, "shape": shape_name,
        "kind": cell.kind, "mesh": list(mesh.dims),
        "axes": list(mesh.axis_names), "n_devices": mesh.size,
        "moe_impl": moe_impl, "walk_s": walk["walk_s"], **rec,
        "model_flops": mf,
        "useful_compute_ratio": (mf["model_flops"] / max(
            rec["roofline"]["hlo_flops_global"], 1.0)),
        "fallbacks": walk["fallbacks"],
    }


def _rank_slab(rows: int, width: int, m: int, J: int, seed: int = 0):
    """Rank 0's slab of the dry-run instance, every entry real: float32
    a, c, ub, s, int32 destinations, a bool mask (the reference's
    abstract slab's dtypes)."""
    from ..core.types import Slab

    g = torch.Generator().manual_seed(seed)
    f32 = torch.float32
    return Slab(
        a_vals=torch.rand((rows, width, m), generator=g, dtype=f32),
        c_vals=-torch.rand((rows, width), generator=g, dtype=f32),
        dest_idx=torch.randint(0, J, (rows, width), generator=g,
                               dtype=torch.int32),
        mask=torch.ones((rows, width), dtype=torch.bool),
        ub=torch.ones((rows, width), dtype=f32),
        s=torch.ones((rows,), dtype=f32),
        source_ids=torch.arange(rows, dtype=torch.int32))


def lower_lp(mesh: MeshSpec, sources: int = 100_000,
             destinations: int = 10_000,
             lambda_axis: Optional[str] = None) -> Dict:
    """Dry-run the LP solver's distributed dual-ascent iteration: one
    evaluation of rank 0's slab, every rank a source shard (rows padded
    to the rank count), one bucket at width 32, reckoned by the launch
    census in `aligned` mode.  The arguments are what the evaluation
    reads (the slab but its source ids, b and λ), as the reference's jit
    keeps only the arguments it uses.  Dot FLOPs are the multiply-adds the
    reference's dots do: forming u (2·m an entry), Ax (2·m a real entry)
    and ⟨λ, grad⟩ (2·m·J); `operations_per_device` is the census's count
    of every float32 operation."""
    from ..core.objectives import MatchingObjective
    from ..core.types import LPData
    from . import census

    t0 = time.time()
    n_dev, m, w = mesh.size, 1, 32
    rows = -(-sources // n_dev)
    slab = _rank_slab(rows, w, m, destinations)
    b = torch.zeros((m, destinations), dtype=torch.float32)
    shards = mesh.shape[lambda_axis] if lambda_axis else 1
    others = mesh.size // shards          # ranks along the other axes
    # λ-sharded, the local sweep forms the whole (m, J) Ax before the
    # reduce-scatter; replicated, one all_reduce sums (Ax, cᵀx, ‖x‖²)
    local = MatchingObjective(
        LPData(slabs=(slab,), b=b), ax_mode="aligned",
        ax_reducer=None if lambda_axis else (lambda parts: parts))
    # the attributes of a DistributedMatchingObjective the census reads
    obj = SimpleNamespace(
        local=local, _shards=shards,
        _lam_group=object() if shards > 1 else None,
        _other_group=object() if shards > 1 and others > 1 else None)
    cen = census.evaluation_census(obj)
    kinds = census.collective_kinds(obj)
    real = int(slab.mask.sum())
    lam_cols = destinations // shards
    flops = 2 * m * (rows * w + real + destinations)
    read = [slab.a_vals, slab.c_vals, slab.dest_idx, slab.mask, slab.ub,
            slab.s]
    arg = sum(t.numel() * t.element_size() for t in read)
    arg += (m * lam_cols + m * destinations) * 4      # λ, b
    walk = {
        "flops_per_device": float(flops),
        "bytes_per_device": float(cen["bytes_per_iteration"]),
        "collectives": {k: float(kinds.get(k, 0))
                        for k in op_cost.COLLECTIVES},
        "collective_count": sum(1 for v in kinds.values() if v),
        "memory": {
            "argument_size_in_bytes": float(arg),
            "output_size_in_bytes": float(m * lam_cols * 4 + 4),
            "temp_size_in_bytes": float(
                census.runner_memory(obj, ())["temp_bytes"]),
        },
    }
    rec = _record(walk, n_dev)
    return {
        "status": "OK", "arch": "lp-matching",
        "shape": f"I{sources}_J{destinations}"
                 + (f"_lam-{lambda_axis}" if lambda_axis else ""),
        "kind": "solve", "mesh": list(mesh.dims),
        "axes": list(mesh.axis_names), "n_devices": n_dev,
        "walk_s": time.time() - t0, **rec,
        "operations_per_device": float(cen["flops_per_iteration"]),
        "kernels": cen["kernels"],
    }


def cell_path(mesh_name: str, arch: str, shape: str, moe_impl: str) -> str:
    tag = f"_{moe_impl}" if moe_impl != "einsum" else ""
    return os.path.join(RESULTS, mesh_name, f"{arch}__{shape}{tag}.json")


def run_cells(archs, shapes, meshes, moe_impl="einsum", force=False,
              extra_rules=None, tag="", overrides=None):
    summary = []
    for mesh_name in meshes:
        mesh = make_production_mesh(multi_pod=(mesh_name == "multipod"))
        os.makedirs(os.path.join(RESULTS, mesh_name), exist_ok=True)
        for arch in archs:
            arch_shapes = ["solve"] if arch.startswith("lp-") else shapes
            for shape in arch_shapes:
                path = cell_path(mesh_name, arch, shape, moe_impl)
                if tag:
                    path = path.replace(".json", f"_{tag}.json")
                if os.path.exists(path) and not force:
                    print(f"[cache] {mesh_name}/{arch}/{shape}")
                    with open(path) as f:
                        summary.append(json.load(f))
                    continue
                print(f"[walk] {mesh_name}/{arch}/{shape} ...", flush=True)
                try:
                    if arch == "lp-matching":
                        res = lower_lp(mesh)
                    elif arch == "lp-matching-lamsharded":
                        res = lower_lp(mesh, lambda_axis="model")
                    else:
                        res = lower_cell(arch, shape, mesh, moe_impl,
                                         extra_rules, overrides)
                except Exception as e:  # a failure here is a sharding bug
                    res = {"status": "FAIL", "arch": arch, "shape": shape,
                           "mesh": mesh_name, "error": str(e),
                           "traceback": traceback.format_exc()}
                    print(f"[FAIL] {arch}/{shape}: {e}")
                res.setdefault("arch", arch)
                res.setdefault("shape", shape)
                res["mesh_name"] = mesh_name
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                if res["status"] == "OK":
                    r = res["roofline"]
                    print(f"[ok] {arch}/{shape} {mesh_name}: "
                          f"t_c={r['t_compute_s']:.4f}s "
                          f"t_m={r['t_memory_s']:.4f}s "
                          f"t_x={r['t_collective_s']:.4f}s "
                          f"dom={r['dominant']} "
                          f"hbm={res['hbm_per_device_gb']:.2f}GB "
                          f"walk={res['walk_s']:.0f}s", flush=True)
                summary.append(res)
    return summary


def _parse_overrides(items):
    out = {}
    for ov in items:
        k, v = ov.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                pass
        out[k] = v
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all",
                    help="arch id | all | lp-matching | lp-matching-lamsharded")
    ap.add_argument("--shape", default="all", help="shape name | all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multipod", "both"])
    ap.add_argument("--moe-impl", default="einsum",
                    choices=["einsum", "gather"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="suffix for variant runs")
    ap.add_argument("--override", action="append", default=[],
                    help="ModelConfig override key=value")
    args = ap.parse_args(argv)
    overrides = _parse_overrides(args.override)
    archs = arch_ids() if args.arch == "all" else [args.arch]
    if args.arch == "all":
        archs = archs + ["lp-matching", "lp-matching-lamsharded"]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = (["single", "multipod"] if args.mesh == "both"
              else [args.mesh])
    summary = run_cells(archs, shapes, meshes, args.moe_impl, args.force,
                        tag=args.tag, overrides=overrides or None)
    n_ok = sum(1 for s in summary if s["status"] == "OK")
    n_skip = sum(1 for s in summary if s["status"] == "SKIP")
    n_fail = sum(1 for s in summary if s["status"] == "FAIL")
    print(f"\n== dry-run complete: {n_ok} OK, {n_skip} SKIP (documented), "
          f"{n_fail} FAIL ==")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())

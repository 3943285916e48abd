"""LP-based MoE routing: the DuaLip solver as a framework feature; the port
of the reference's `examples/moe_lp_routing.py`.

Token -> expert assignment is a matching LP (BASE-layers style):
  sources      = tokens (one block each, simplex budget top_k)
  destinations = experts
  value c_ij   = router affinity of token i for expert j (we MAXIMIZE it)
  capacity b_j = per-expert token budget  (the complex constraint Ax <= b)

The solver's near-balanced soft assignment is compared with greedy top-k
routing on expert load balance and captured affinity.

    PYTHONPATH=src python -m repro_torch.examples.moe_lp_routing [--device cpu]

`route(affinity, top_k, device)` takes any (tokens, experts) affinity;
`main` draws one from `numpy.random.default_rng(0)` (the reference draws
it with `jax.random`, so its numbers differ from the reference's print).
The objective runs `ax_mode="scatter"` (K3), the mode the reference's
default runs.
"""
import numpy as np
import torch

from ..convert import resolve_device
from ..core import (LPData, MatchingObjective, Maximizer, SolveConfig, Slab,
                    precondition)
from ._common import emit, fail, launch_counts, launches_since, parser

T, E, TOPK = 1024, 16, 2


def make_affinity(seed: int = 0) -> np.ndarray:
    """Skewed float32 router affinities, a few "hot" experts, like a real
    undertrained router: softmax(N(0, 1) + linspace(1.5, 0, E))."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((T, E)).astype(np.float32)
              + np.linspace(1.5, 0, E, dtype=np.float32)[None, :])
    z = np.exp(logits - logits.max(axis=-1, keepdims=True))
    return (z / z.sum(axis=-1, keepdims=True)).astype(np.float32)


def imbalance(load) -> float:
    return float(load.max() / max(load.mean(), 1e-9))


def routing_lp(affinity: np.ndarray, top_k: int, dev) -> LPData:
    """The routing problem as a matching LP, row-normalized: x_ij in [0,1],
    the fraction of token i's slot budget on expert j;
      per-token simplex: sum_j x_ij <= top_k           (simple)
      per-expert capacity: sum_i x_ij <= T*top_k/E     (complex)
    one (tokens, experts) slab, value -affinity."""
    n_tok, n_exp = affinity.shape
    aff = np.asarray(affinity, np.float64)
    slab = Slab(
        a_vals=torch.ones((n_tok, n_exp, 1), dtype=torch.float32, device=dev),
        c_vals=torch.as_tensor((-aff).astype(np.float32), device=dev),
        dest_idx=torch.as_tensor(np.tile(np.arange(n_exp, dtype=np.int32),
                                         (n_tok, 1)), device=dev),
        mask=torch.ones((n_tok, n_exp), dtype=torch.bool, device=dev),
        ub=torch.ones((n_tok, n_exp), dtype=torch.float32, device=dev),
        s=torch.full((n_tok,), float(top_k), dtype=torch.float32, device=dev),
        source_ids=torch.arange(n_tok, dtype=torch.int32, device=dev),
    )
    capacity = n_tok * top_k / n_exp
    lp = LPData(slabs=(slab,), b=torch.full((1, n_exp), capacity,
                                            dtype=torch.float32, device=dev))
    return precondition(lp, row_norm=True)[0]


def route(affinity: np.ndarray, top_k: int = TOPK, device="cuda") -> dict:
    """Greedy top-k routing against the LP's on one (tokens, experts)
    float32 affinity: loads, captured affinity and imbalance of each."""
    dev = resolve_device(device)
    n_tok, n_exp = affinity.shape
    aff_t = torch.as_tensor(np.array(affinity, np.float32), device=dev)

    # greedy top-k: ties to the lower expert index, as lax.top_k breaks
    # them (torch.topk leaves the order of ties open on the card), by a
    # stable descending sort
    order = torch.sort(aff_t, dim=-1, descending=True, stable=True).indices
    experts = order[:, :top_k]
    gates = torch.gather(aff_t, 1, experts)
    greedy_load = np.zeros(n_exp)
    np.add.at(greedy_load, experts.cpu().numpy().reshape(-1), 1.0)
    greedy_value = float(gates.sum())

    lp = routing_lp(affinity, top_k, dev)
    cfg = SolveConfig(iterations=600, gamma=0.05, gamma_init=0.4,
                      gamma_decay_every=25, max_step=20.0, initial_step=1e-3)
    obj = MatchingObjective(lp, proj_kind="boxcut", ax_mode="scatter")
    res = Maximizer(cfg).maximize(obj)
    x = obj.primal(res.lam, torch.tensor(cfg.gamma, device=dev))[0]

    lp_load = x.sum(dim=0).cpu().numpy().reshape(-1).astype(np.float64)
    lp_value = float((x * aff_t).sum())
    return {"tokens": n_tok, "experts": n_exp, "top_k": top_k,
            "capacity": n_tok * top_k / n_exp, "greedy_value": greedy_value,
            "greedy_load": greedy_load.tolist(),
            "greedy_imbalance": imbalance(greedy_load),
            "greedy_max_load": float(greedy_load.max()),
            "lp_value": lp_value, "lp_load": lp_load.tolist(),
            "lp_imbalance": imbalance(lp_load),
            "lp_max_load": float(lp_load.max()),
            "infeas_final": float(res.stats.infeas[-1]),
            "iterations_run": res.iterations_run}


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    before = launch_counts()
    r = route(make_affinity(0), TOPK, args.device)
    print(f"experts={r['experts']} tokens={r['tokens']} top_k={r['top_k']} "
          f"capacity/expert={r['capacity']:.0f}")
    print(f"greedy : captured affinity={r['greedy_value']:8.2f}  "
          f"max/mean load={r['greedy_imbalance']:.2f}  "
          f"max load={r['greedy_max_load']:.0f}")
    print(f"LP     : captured affinity={r['lp_value']:8.2f}  "
          f"max/mean load={r['lp_imbalance']:.2f}  "
          f"max load={r['lp_max_load']:.0f}")
    print(f"dual infeasibility: {r['infeas_final']:.2e}")
    if not r["lp_imbalance"] < r["greedy_imbalance"]:
        fail("LP should balance better")
    print("LP routing balances expert load within capacity — OK")
    r.update(example="moe_lp_routing", device=args.device, balanced=True,
             launches=launches_since(before))
    return emit(r, args)


if __name__ == "__main__":
    main()

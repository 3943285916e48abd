"""Duals to decisions (counterpart of `repro.primal`, DESIGN.md §8):

  extract    streaming blockwise x*(λ) recovery over source-row chunks
             (+ the .npz shard writer and hardened reader)
  rounding   threshold / top-k rounding and the capacity repair
  certify    duality-gap certificates and per-family slack reports
  server     the λ-resident microbatch allocation query engine with a
             warm-resolve hook for instance updates
  frontend   bounded-queue admission, deadline-aware coalescing, load
             shedding, background refresh and graceful drain over it

    srv = AllocationServer(obj, res.lam, gamma)
    decisions = srv.query([12, 507, 90210])
"""
from .extract import (PrimalChunk, extract_primal, iter_primal_chunks,
                      read_shards, write_shards)
from .rounding import (greedy_repair, primal_ax, scale_repair,
                       threshold_round, topk_round)
from .certify import (Certificate, FamilySlack, certify, family_slacks,
                      format_certificate, global_row_caps, primal_value,
                      repair_witness, x_sq_bound)
from .server import AllocationServer, DecisionRow, QueryStats
from .frontend import (FrontendConfig, FrontendStats, RequestStatus,
                       Response, ServerFrontend, Ticket)

__all__ = [
    "PrimalChunk", "extract_primal", "iter_primal_chunks", "read_shards",
    "write_shards",
    "greedy_repair", "primal_ax", "scale_repair", "threshold_round",
    "topk_round",
    "Certificate", "FamilySlack", "certify", "family_slacks",
    "format_certificate", "global_row_caps", "primal_value",
    "repair_witness", "x_sq_bound",
    "AllocationServer", "DecisionRow", "QueryStats",
    "FrontendConfig", "FrontendStats", "RequestStatus", "Response",
    "ServerFrontend", "Ticket",
]

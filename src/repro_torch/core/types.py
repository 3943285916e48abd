"""Core data types of the PyTorch port (counterpart of `repro.core.types`).

Array containers are NamedTuples of tensors with the reference's field
names, so the same bucketed-slab layout (DESIGN.md §2) and destination-major
companion plan (DESIGN.md §3) carry over unchanged.  The generator returns
them with numpy leaves; `repro_torch.convert` moves them onto a device.

Shapes (n = sources in a slab, w = padded width, m = constraint families,
r = rows of a plan bucket, J = destinations):

  Slab.a_vals (n, w, m)  c_vals/dest_idx/mask/ub (n, w)  s/source_ids (n,)
  AxBucket.edge_idx/mask (r, w)  dest_ids (r,)  a_dm (r, w, m)
  AxPlan.inv_perm (J,)   LPData.b (m, J)
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, NamedTuple, Optional, Tuple

import torch


class Slab(NamedTuple):
    """One degree bucket of sources, padded to a common width."""

    a_vals: torch.Tensor
    c_vals: torch.Tensor
    dest_idx: torch.Tensor
    mask: torch.Tensor
    ub: torch.Tensor
    s: torch.Tensor
    source_ids: torch.Tensor

    @property
    def n(self) -> int:
        return self.c_vals.shape[0]

    @property
    def width(self) -> int:
        return self.c_vals.shape[1]

    @property
    def m(self) -> int:
        return self.a_vals.shape[2]


class AxBucket(NamedTuple):
    """One in-degree bucket of the value-carrying plan: each row is one
    destination, holding the flat positions of its incident edges and the
    destination-major weight copy `a_dm[r, q] = a_flat[edge_idx[r, q]]`."""

    edge_idx: torch.Tensor
    mask: torch.Tensor
    dest_ids: torch.Tensor
    a_dm: Optional[torch.Tensor] = None

    @property
    def rows(self) -> int:
        return self.edge_idx.shape[-2]

    @property
    def width(self) -> int:
        return self.edge_idx.shape[-1]


class AxPlan(NamedTuple):
    """Destination-major companion of the slabs.  Every destination owns
    exactly one row across the buckets; `inv_perm[j]` is its position in
    the bucket-concatenated row space."""

    buckets: Tuple[AxBucket, ...]
    inv_perm: torch.Tensor

    @property
    def num_rows(self) -> int:
        return sum(b.rows for b in self.buckets)

    @property
    def num_destinations(self) -> int:
        return self.inv_perm.shape[-1]


class LPData(NamedTuple):
    """A matching LP in bucketed-slab layout; b is (m, J), as is λ."""

    slabs: Tuple[Slab, ...]
    b: torch.Tensor

    @property
    def m(self) -> int:
        return self.b.shape[0]

    @property
    def num_destinations(self) -> int:
        return self.b.shape[1]

    @property
    def num_sources(self) -> int:
        return sum(s.n for s in self.slabs)

    @property
    def num_edges(self) -> int:
        return sum(s.n * s.width for s in self.slabs)


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    """Same fields and defaults as `repro.core.types.SolveConfig`.

    `dtype` names a torch dtype here.  `use_pallas` is kept for field
    parity and read by nothing: in the port the hand-written kernels are
    the only path for tensors on the card."""

    iterations: int = 200
    gamma: float = 0.01
    initial_step: float = 1e-5
    max_step: float = 1e-3
    gamma_init: Optional[float] = None
    gamma_decay_every: int = 25
    gamma_decay_rate: float = 0.5
    scale_step_with_gamma: bool = True
    adaptive_continuation: bool = False
    gamma_stall_tol: float = 1e-4
    row_normalize: bool = False
    primal_scale: bool = False
    projection: str = "boxcut"
    dtype: torch.dtype = torch.float32
    log_every: int = 1
    use_pallas: bool = False
    pdhg_restart_every: int = 512
    pdhg_restart_beta: float = 0.2
    pdhg_min_window: int = 8
    pdhg_omega_init: float = 1.0
    pdhg_omega_min: float = 0.015625
    pdhg_l_decay: float = 0.97
    pdhg_step_max_scale: float = 8.0
    bb_step_max_scale: float = 8.0
    max_diagnostics: Optional[int] = None


class StopReason(enum.Enum):
    CONVERGED = "converged"
    MAX_ITERATIONS = "max_iterations"
    MAX_SECONDS = "max_seconds"
    DIVERGED = "diverged"
    PREEMPTED = "preempted"


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Health-guard policy; same fields and defaults as the reference.
    The port's engine does not run the guard yet."""

    max_retries: int = 3
    obj_regression_tol: float = 0.5
    grad_explosion: float = 100.0
    step_backoff: float = 0.25
    gamma_backoff: float = 4.0
    check_lambda: bool = True


@dataclasses.dataclass(frozen=True)
class StoppingCriteria:
    """Composable stopping rules checked at chunk boundaries; the
    reference's semantics (all set tolerances must hold at one check)."""

    tol_rel_dual: Optional[float] = None
    tol_infeas: Optional[float] = None
    tol_infeas_rel: Optional[float] = None
    tol_grad_norm: Optional[float] = None
    max_iterations: Optional[int] = None
    max_seconds: Optional[float] = None
    check_every: int = 25

    @property
    def has_tolerances(self) -> bool:
        return any(t is not None for t in (
            self.tol_rel_dual, self.tol_infeas, self.tol_infeas_rel,
            self.tol_grad_norm))

    @property
    def needs_checks(self) -> bool:
        return self.has_tolerances or self.max_seconds is not None

    def satisfied(self, rel_dual: float, infeas: float, grad_norm: float,
                  infeas_scale: float = 1.0) -> bool:
        """All set tolerances hold (NaNs never satisfy a tolerance)."""
        if not self.has_tolerances:
            return False
        if self.tol_rel_dual is not None and not rel_dual <= self.tol_rel_dual:
            return False
        if self.tol_infeas is not None or self.tol_infeas_rel is not None:
            thr = ((self.tol_infeas or 0.0)
                   + (self.tol_infeas_rel or 0.0) * infeas_scale)
            if not infeas <= thr:
                return False
        if (self.tol_grad_norm is not None
                and not grad_norm <= self.tol_grad_norm):
            return False
        return True


class ConvergenceCheck(NamedTuple):
    """Host-side scalars read back at one chunk boundary."""

    it: int
    dual_obj: float
    rel_dual: float
    infeas: float
    grad_norm: float
    gamma: float
    elapsed: float
    stalled: bool


class SolveState(NamedTuple):
    """Maximizer state; every field is a device tensor (scalars 0-d)."""

    lam: torch.Tensor
    y: torch.Tensor
    lam_prev: torch.Tensor
    grad_prev: torch.Tensor
    y_prev: torch.Tensor
    step: torch.Tensor
    l_est: torch.Tensor
    k_mom: torch.Tensor
    it: torch.Tensor
    extra: Any = ()


class IterStats(NamedTuple):
    """Per-iteration scalars.  The engine returns them stacked over the
    executed iterations as host float32 numpy arrays (one copy per chunk)."""

    dual_obj: Any
    primal_obj: Any
    infeas: Any
    grad_norm: Any
    step: Any
    gamma: Any


class SolveResult(NamedTuple):
    lam: torch.Tensor
    stats: IterStats
    iterations_run: int = 0
    converged: bool = False
    stop_reason: Optional[StopReason] = None
    diagnostics: Tuple[ConvergenceCheck, ...] = ()
    health: Tuple[Any, ...] = ()
    final_state: Optional[SolveState] = None

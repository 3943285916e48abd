"""Declarative LP formulation specs (DESIGN.md §5); port of
`repro.formulations.spec` (pure Python, copied so that the port imports
nothing of the JAX package).

A `Formulation` describes WHAT an LP looks like — the blockwise "simple"
constraint set C_i and a list of constraint families (dual row blocks) —
and nothing of how it is solved; `formulations.compiler` lowers it onto
the port's objective, plan and solve loop.

  DestCapacityFamily   per-(LP family k, destination j) capacity rows
                       A_k x <= b_k, the rows packed in the slabs.  Its
                       dual block is the (m, J) λ, flattened row-major.
  GlobalBudgetFamily   ONE coupling row Σ_e w_e x_e <= limit across every
                       edge; `weight` is "count" (w ≡ 1 on real edges),
                       "value" (w_e = −c_e, the edge's value) or
                       ("lp_family", k) (LP family k's coefficients).
                       Appends one λ entry.

The composed dual vector is 1-D: `[dest block (m·J, family-major) | one
entry per global row, in declaration order]`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

#: weight selectors accepted by GlobalBudgetFamily (plus ("lp_family", k))
WEIGHT_KINDS = ("count", "value")


@dataclasses.dataclass(frozen=True)
class DestCapacityFamily:
    """Per-(family, destination) capacity rows — the LPData's own rows.

    lp_families: which LP constraint families (axes of a_vals/b) this block
        exposes as dual rows; None = all of them.
    rhs:         optional explicit rhs replacing the instance's b (shape
        (len(lp_families) or m, J)) — for formulations that must recompute
        capacities (e.g. assignment_eq derives feasible ones from the
        even-spread load).  Applied after family slicing.
    rhs_scale:   multiply the (possibly overridden) rhs by this factor at
        compile time.
    """

    lp_families: Optional[Tuple[int, ...]] = None
    rhs: Optional[object] = None            # array-like (m_sel, J)
    rhs_scale: float = 1.0
    label: str = "dest_capacity"

    def residual(self, ax, b):
        """Primal residual Ax − b of this family's rows at a candidate x —
        the certification hook (DESIGN.md §8): positive entries are
        violations, non-positive entries are slack.  `ax`/`b` are the
        (m_sel, J) arrays of the compiled LP (i.e. in the row-normalized
        units when the compiler's row_norm hook is on)."""
        return ax - b


@dataclasses.dataclass(frozen=True)
class GlobalBudgetFamily:
    """One global coupling row  Σ_e w_e x_e <= limit  (one extra dual entry).

    Lowered through the shift hook of the slab sweep: the row's
    contribution μ·w folds into c inside u = −(Aᵀλ + c + μw)/γ, so it
    rides the shared sweep, every ax_mode and the kernels.  Its Ax entry
    is the scalar Σ w_e x_e (no AxPlan needed).
    """

    limit: float
    weight: Union[str, Tuple[str, int]] = "count"
    label: str = "global"

    def residual(self, used: float) -> float:
        """Primal residual Σw·x − limit at a candidate x, in ORIGINAL
        (un-normalized) row units — the certification hook (DESIGN.md §8):
        positive means the coupling row is violated."""
        return used - self.limit

    def validate(self, num_lp_families: int) -> None:
        w = self.weight
        if isinstance(w, tuple):
            if (len(w) != 2 or w[0] != "lp_family"
                    or not 0 <= int(w[1]) < num_lp_families):
                raise ValueError(
                    f"global row {self.label!r}: tuple weight must be "
                    f"('lp_family', k) with 0 <= k < {num_lp_families}, "
                    f"got {w!r}")
        elif w not in WEIGHT_KINDS:
            raise ValueError(
                f"global row {self.label!r}: weight must be one of "
                f"{WEIGHT_KINDS} or ('lp_family', k), got {w!r}")
        if not self.limit >= 0.0:
            raise ValueError(
                f"global row {self.label!r}: limit must be >= 0 "
                f"(x = 0 must stay feasible), got {self.limit!r}")


FamilySpec = Union[DestCapacityFamily, GlobalBudgetFamily]


@dataclasses.dataclass(frozen=True)
class BlockConstraint:
    """The blockwise simple-constraint set C_i (paper §3.2), as projection
    config: a default kind, an optional per-bucket override table (the
    ProjectionMap hook), and the threshold-search iteration count."""

    kind: str = "boxcut"   # "box" | "simplex" | "simplex_eq" | "boxcut" | ...
    iters: int = 40
    overrides: Optional[Dict[int, object]] = None  # bucket -> kind|(kind,it)


@dataclasses.dataclass(frozen=True)
class Formulation:
    """A declarative LP formulation: objective + C-blocks + row families.

    The objective coefficients always come from the instance (LPData
    c_vals); what varies across formulations is the constraint structure.
    Exactly one DestCapacityFamily is required (it defines the slab/AxPlan
    row block); any number of GlobalBudgetFamily rows may follow.
    """

    name: str
    families: Tuple[FamilySpec, ...]
    block: BlockConstraint = BlockConstraint()
    description: str = ""

    def validate(self, num_lp_families: int) -> None:
        dests = [f for f in self.families
                 if isinstance(f, DestCapacityFamily)]
        if len(dests) != 1:
            raise ValueError(
                f"formulation {self.name!r}: exactly one DestCapacityFamily "
                f"is required, got {len(dests)}")
        if self.families[0] is not dests[0]:
            raise ValueError(
                f"formulation {self.name!r}: the DestCapacityFamily must be "
                f"declared first (λ concatenation convention)")
        sel = dests[0].lp_families
        if sel is not None:
            if len(set(sel)) != len(sel) or not all(
                    0 <= int(k) < num_lp_families for k in sel):
                raise ValueError(
                    f"formulation {self.name!r}: lp_families must be "
                    f"distinct indices < {num_lp_families}, got {sel!r}")
        for fam in self.families[1:]:
            if not isinstance(fam, GlobalBudgetFamily):
                raise ValueError(
                    f"formulation {self.name!r}: families after the first "
                    f"must be GlobalBudgetFamily, got {type(fam).__name__}")
            fam.validate(num_lp_families)
        labels = [f.label for f in self.families]
        if len(set(labels)) != len(labels):
            # row_slices()/global_usage() key by label — duplicates would
            # silently shadow rows in every audit surface
            raise ValueError(
                f"formulation {self.name!r}: family labels must be unique, "
                f"got {labels!r}")

    @property
    def dest(self) -> DestCapacityFamily:
        return self.families[0]

    @property
    def global_rows(self) -> Tuple[GlobalBudgetFamily, ...]:
        return tuple(f for f in self.families[1:])

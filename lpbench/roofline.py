"""The yardstick of the kernels' roofline: one evaluation's least bytes,
counted from the instance's real edges, and the card's peak bandwidth.

Per real edge: m x 4 B of coefficients a, and 4 B each of the objective
c, the upper bound ub and the destination index.  Per source with an
edge: 4 B of its budget s.  Once an evaluation: the dual read and the
gradient written, 4 B a row each.  Intermediates (x, a padded layout, a
second copy of a) are not counted: they are how an implementation
chooses to move the data, not what the evaluation needs.  The coupling
rows' weights are the count (no bytes) or the value (which is c), so they
add nothing beyond their dual and gradient entries.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 (80 GB HBM3) datasheet: peak HBM bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12


def evaluation_bytes(num_edges: int, num_sources: int, m: int,
                     dual_rows: int) -> int:
    """The least bytes one evaluation of the dual moves (module doc)."""
    return num_edges * (4 * m + 12) + 4 * num_sources + 2 * 4 * dual_rows

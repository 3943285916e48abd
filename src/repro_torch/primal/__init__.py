"""Duals to decisions (counterpart of `repro.primal`): chunked extraction,
the capacity repair, and the duality-gap certificate.  Serving (server,
frontend) is not ported yet (ROADMAP queue A item 13)."""
from .extract import extract_primal
from .rounding import (greedy_repair, primal_ax, scale_repair,
                       threshold_round, topk_round)
from .certify import (Certificate, FamilySlack, certify, family_slacks,
                      format_certificate, global_row_caps, primal_value,
                      repair_witness, x_sq_bound)

__all__ = ["extract_primal", "greedy_repair", "primal_ax", "scale_repair",
           "threshold_round", "topk_round", "Certificate",
           "FamilySlack", "certify", "family_slacks", "format_certificate",
           "global_row_caps", "primal_value", "repair_witness",
           "x_sq_bound"]

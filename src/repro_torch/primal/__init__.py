"""Duals to decisions (counterpart of `repro.primal`): chunked extraction,
the capacity repair, and the duality-gap certificate.  Serving (server,
frontend) is not ported yet (ROADMAP queue A item 13)."""
from .extract import extract_primal
from .rounding import primal_ax, scale_repair
from .certify import (Certificate, FamilySlack, certify, family_slacks,
                      format_certificate, primal_value, x_sq_bound)

__all__ = ["extract_primal", "primal_ax", "scale_repair", "Certificate",
           "FamilySlack", "certify", "family_slacks", "format_certificate",
           "primal_value", "x_sq_bound"]

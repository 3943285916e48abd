"""The synthetic token stream (counterpart of `repro.data`)."""
from .pipeline import TokenStream

__all__ = ["TokenStream"]

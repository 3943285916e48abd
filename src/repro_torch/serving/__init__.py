"""Serving of the LM models (counterpart of `repro.serving`)."""

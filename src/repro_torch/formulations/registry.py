"""Formulation registry — name -> spec function (DESIGN.md §5); port of
`repro.formulations.registry`.

A spec function is a callable `(lp, **params) -> Formulation`: it reads the
instance (numpy or tensor leaves) to derive default budgets and returns
the declarative spec.  Registration is how a formulation becomes reachable
from `launch/solve.py --formulation`.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

from .spec import Formulation

_REGISTRY: Dict[str, Callable] = {}


def register(name: str) -> Callable:
    """Decorator: register a formulation's spec function under `name`."""

    def deco(fn: Callable) -> Callable:
        if name in _REGISTRY:
            raise ValueError(f"formulation {name!r} already registered")
        _REGISTRY[name] = fn
        return fn

    return deco


def get(name: str) -> Callable:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown formulation {name!r}; registered: {names()}") from None


def names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def build(name: str, lp, **params) -> Formulation:
    """Build the named formulation's spec for this instance."""
    form = get(name)(lp, **params)
    form.validate(lp.m)
    return form


def make_objective(name: str, lp, params: dict = None, **runtime):
    """Build the spec, then compile it onto the solver: `params` go to the
    spec function, `runtime` keywords (ax_mode, row_norm, ...) to
    `compile_formulation`."""
    from .compiler import compile_formulation
    return compile_formulation(build(name, lp, **(params or {})), lp,
                               **runtime)

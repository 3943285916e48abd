"""Run a reference example on the reference's kernel path: every objective
that `repro.formulations.make_objective` builds takes `use_pallas=True`
(the Pallas kernels, in interpret mode on the CPU), the path the reference
runs on its accelerator and the one the port's kernels translate.  A
formulation whose blocks that path refuses (assignment_eq's simplex_eq)
keeps the plain sweep, as the port's does.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_reference_pallas.py \
        examples/formulations_tour.py --quick
"""
import runpy
import sys

from repro import formulations

_make_objective = formulations.make_objective


def make_objective(name, lp, params=None, **runtime):
    runtime.setdefault("use_pallas", True)
    try:
        return _make_objective(name, lp, params, **runtime)
    except ValueError as e:
        if "Pallas path supports" not in str(e):
            raise
        runtime["use_pallas"] = False
        return _make_objective(name, lp, params, **runtime)


if __name__ == "__main__":
    formulations.make_objective = make_objective
    sys.argv = sys.argv[1:]
    runpy.run_path(sys.argv[0], run_name="__main__")

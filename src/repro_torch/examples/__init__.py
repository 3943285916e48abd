"""The solver's examples on the port (counterparts of the reference's
`examples/*.py`), one module each, and the LM serving demo:

    python -m repro_torch.examples.quickstart [--device cpu] [--json]
    python -m repro_torch.examples.moe_lp_routing
    python -m repro_torch.examples.formulations_tour [--quick]
    python -m repro_torch.examples.matching_scale [--sources N]
    python -m repro_torch.examples.chaos_smoke [--quick]
    python -m repro_torch.examples.allocation_server [--quick] [--load-test]
    python -m repro_torch.examples.serve_lm [--arch A] [--full]

Each has `main(argv=None) -> dict` with every number it prints, runs on the
card unless given `--device cpu`, prints that dict as its last line with
`--json`, and exits non-zero on the reference example's misses.
"""

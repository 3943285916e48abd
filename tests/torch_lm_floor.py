"""How far float32 rounding alone moves the reduced LMs' outputs: the
floor under the port-vs-reference tolerances of `tests/test_torch_lm_*.py`
and `tests/test_torch_train.py`.  Not a pytest file:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_lm_floor.py \
        [--arch A ...] [--seeds 1 2 3]

For each arch and seed (the tests' `batch_for` batches) it prints, as
fractions of the largest magnitude: the port's prefill logits, loss and
worst gradient against the reference's; the reference's prefill against
a float64 evaluation (the port's code on float64 copies of the weights;
configs whose mamba layers or router compute in float32 by definition
skip it), and
its gradients likewise; and
the reference against itself re-chunked (`ssm_chunk` and `xent_chunk` 4,
the same function in other float32 sums).
"""
import argparse
import dataclasses

import jax
import numpy as np
import torch

from repro.models import build_model as r_build_model
from repro_torch.models.model import Model
from repro_torch.training.trainer import value_and_grad
from torch_lm_ref import batch_for, carry, to_jax, to_torch


def worst(got, want):
    return max((float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max()
                      / np.abs(np.asarray(want[k])).max()), k) for k in want)


def floors(arch, seed):
    r_model, r_params, model, params = carry(arch)
    batch = batch_for(model.cfg, seed)
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    want = np.asarray(r_model.prefill(r_params, to_jax(inputs)))
    with torch.inference_mode():
        got = model.prefill(params, to_torch(inputs)).numpy()
    scale = np.abs(want).max()
    line = f"{arch} seed {seed}: prefill port-ref " \
           f"{np.abs(got - want).max() / scale:.2e}"
    if model.cfg.ssm_state == 0 and not model.cfg.n_experts:
        m64 = Model(dataclasses.replace(model.cfg, param_dtype="float64",
                                        compute_dtype="float64"))
        with torch.inference_mode():
            exact = m64.prefill(
                {k: v.double() for k, v in params.items()},
                {k: (v.double() if v.is_floating_point() else v)
                 for k, v in to_torch(inputs).items()}).numpy()
        line += f", ref-float64 {np.abs(want - exact).max() / scale:.2e}"
    r_loss, r_grads = jax.value_and_grad(r_model.loss)(r_params,
                                                       to_jax(batch))
    loss, grads = value_and_grad(model.loss, params, to_torch(batch))
    rel = abs(float(loss) - float(r_loss)) / abs(float(r_loss))
    g = worst({k: v.numpy() for k, v in grads.items()}, r_grads)
    line += f"; loss port-ref {rel:.2e}; grad port-ref {g[0]:.2e} ({g[1]})"
    if model.cfg.ssm_state == 0 and not model.cfg.n_experts:
        tb64 = {k: (v.double() if v.is_floating_point() else v)
                for k, v in to_torch(batch).items()}
        _, g64 = value_and_grad(m64.loss, {k: v.double() for k, v in
                                           params.items()}, tb64)
        g = worst(r_grads, {k: v.numpy() for k, v in g64.items()})
        line += f"; grad ref-float64 {g[0]:.2e} ({g[1]})"
    r2 = r_build_model(dataclasses.replace(r_model.cfg, ssm_chunk=4,
                                           xent_chunk=4))
    _, g2 = jax.value_and_grad(r2.loss)(r_params, to_jax(batch))
    g = worst(g2, r_grads)
    line += f"; grad ref-rechunked {g[0]:.2e} ({g[1]})"
    print(line, flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+", default=[
        "seamless-m4t-medium", "jamba-1.5-large-398b"])
    ap.add_argument("--seeds", nargs="+", type=int, default=[1, 2, 3])
    args = ap.parse_args()
    for arch in args.arch:
        for seed in args.seeds:
            floors(arch, seed)


if __name__ == "__main__":
    main()

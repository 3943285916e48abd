"""The port's encoder-decoder (`repro_torch.models.encdec`) and VLM patch
stub against the JAX package's, on `reduced()` seamless-m4t-medium and
pixtral-12b in float32 with the reference's `init(PRNGKey(0))` carried
across and seeded numpy batches (16 frames or patch stand-ins).

Tolerances, as fractions of the largest magnitude: pixtral's prefill with
patches, and seamless's logits after T = 8 decode steps (whose cross
caches are zero, as the reference engine leaves them), at 1e-5.  Seamless's
`encode`, `decode_train` and prefill at 1e-4: the reduced config's stacked
weights are drawn with fan-in = n_layers = 2, so the encoder's attention
scores have a standard deviation near 60 and a softmax near one-hot, where
float32 rounding of a score moves the output.  The reference itself sits
1.1e-5 to 2.3e-5 of the largest logit from a float64 evaluation of the
same weights (tests/torch_lm_floor.py), and the port's prefill 0.7e-5 to
3.6e-5 from the reference's on three seeds; `test_seamless_prefill_float32_
floor` holds the port's own distance from float64 within three times the
reference's.  `Model.loss` at rtol 1e-5 of the reference's for both; each
gradient at 1e-4 of its largest entry for pixtral, at 5e-3 for seamless,
whose reference gradients sit 1.1e-3 to 3.4e-3 from a float64 evaluation
(the port's 4.8e-4 to 1.5e-3 from the reference's) on three seeds.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as RE
from repro_torch.models import encdec as TE
from repro_torch.models.model import Model
from torch_lm_ref import (SRC_LEN, TOL_LOGITS, batch_for, carry, close_scaled,
                          greedy_generate_parity, loss_and_grads_parity,
                          port_decode, port_prefill, reference_decode, to_jax,
                          to_torch)
from torch_lm_ref import one_torch_thread  # noqa: F401 (autouse)

SEAMLESS, PIXTRAL = "seamless-m4t-medium", "pixtral-12b"
TOL_ENCDEC = 1e-4


def _seamless(seed=1):
    r_model, r_params, model, params = carry(SEAMLESS)
    return r_model, r_params, model, params, batch_for(model.cfg, seed)


def test_encode_and_decode_train_match_reference():
    r_model, r_params, model, params, batch = _seamless()
    r_mem = RE.encode(r_model.cfg, r_params, jnp.asarray(batch["frames"]))
    with torch.inference_mode():
        mem = TE.encode(model.cfg, params, torch.from_numpy(batch["frames"]))
        h = TE.decode_train(model.cfg, params,
                            torch.from_numpy(batch["tokens"]),
                            torch.from_numpy(np.array(r_mem)))
    close_scaled(mem.numpy(), r_mem, TOL_ENCDEC)
    want = RE.decode_train(r_model.cfg, r_params,
                           jnp.asarray(batch["tokens"]), r_mem)
    close_scaled(h.numpy(), want, TOL_ENCDEC)


def test_seamless_prefill_and_decode_match_reference():
    r_model, r_params, model, params, batch = _seamless()
    inputs = {k: batch[k] for k in ("tokens", "frames")}
    want = np.asarray(r_model.prefill(r_params, to_jax(inputs)))
    close_scaled(port_prefill(model, params, inputs), want, TOL_ENCDEC)
    want_d, r_caches = reference_decode(r_model, r_params, batch["tokens"])
    got_d, caches = port_decode(model, params, batch["tokens"])
    close_scaled(got_d, want_d, TOL_LOGITS)
    assert set(caches) == {"self", "cross"}
    for c in caches["cross"]:
        assert c["k"].shape[1] == SRC_LEN and not c["k"].any()
    for got, want in zip(caches["self"], r_caches["self"]):
        for k in ("k", "v"):
            close_scaled(got[k].numpy(), want[k], TOL_ENCDEC)


def test_seamless_prefill_float32_floor():
    """The port's prefill is as near a float64 evaluation (the port's code
    on float64 copies of the weights) as the reference's is."""
    r_model, r_params, model, params, batch = _seamless()
    inputs = {k: batch[k] for k in ("tokens", "frames")}
    want = np.asarray(r_model.prefill(r_params, to_jax(inputs)))
    got = port_prefill(model, params, inputs)
    m64 = Model(dataclasses.replace(model.cfg, param_dtype="float64",
                                    compute_dtype="float64"))
    with torch.inference_mode():
        exact = m64.prefill({k: v.double() for k, v in params.items()},
                            {k: (v.double() if v.is_floating_point() else v)
                             for k, v in to_torch(inputs).items()}).numpy()
    scale = np.abs(exact).max()
    ref_err = np.abs(want - exact).max() / scale
    port_err = np.abs(got - exact).max() / scale
    print(f"seamless prefill against float64: reference {ref_err:.3e}, "
          f"port {port_err:.3e} of the largest logit")
    assert port_err <= max(3 * ref_err, TOL_LOGITS)


def test_pixtral_prefill_with_patches_matches_reference():
    r_model, r_params, model, params = carry(PIXTRAL)
    batch = batch_for(model.cfg, 1)
    inputs = {k: batch[k] for k in ("tokens", "patches")}
    want = np.asarray(r_model.prefill(r_params, to_jax(inputs)))
    got = port_prefill(model, params, inputs)
    close_scaled(got, want, TOL_LOGITS)
    # the patches reach the logits
    alone = port_prefill(model, params, {"tokens": batch["tokens"]})
    assert np.abs(alone - got).max() > 1e-3 * np.abs(got).max()
    want_d, _ = reference_decode(r_model, r_params, batch["tokens"])
    close_scaled(port_decode(model, params, batch["tokens"])[0], want_d,
                 TOL_LOGITS)


def test_greedy_generate_matches_reference():
    """The engine's greedy tokens equal the reference engine's (its cross
    caches zero at 4,096 positions, as the reference engine leaves them)."""
    greedy_generate_parity(SEAMLESS)


@pytest.mark.parametrize("arch,gtol", [(SEAMLESS, 5e-3), (PIXTRAL, 1e-4)])
def test_loss_and_grads_match_reference(arch, gtol):
    loss_and_grads_parity(arch, gtol=gtol)

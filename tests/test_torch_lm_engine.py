"""The port's serving engine (`repro_torch.serving.engine`) on its own and
`examples/serve_lm`: on `reduced()` qwen3, gemma and chatglm3 in float32
with the reference's `model.init(PRNGKey(0))` carried across,
`Engine.generate` is batch-composition invariant and its temperature
sampling is seeded; the serve_lm example serves the reference demo's
requests on the CPU.
"""
import pytest

from repro_torch.examples import serve_lm
from repro_torch.serving.engine import Engine, Request
from torch_lm_ref import ARCHS, PROMPTS, carry


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_is_batch_composition_invariant(arch):
    _, _, model, params = carry(arch)
    eng = Engine(model, params, batch=4, max_seq=64)
    done = eng.generate([Request(prompt=list(p), max_new=n)
                         for p, n in PROMPTS])
    for i in (0, 4):            # the first batch's first and the second's
        p, n = PROMPTS[i]
        alone = eng.generate([Request(prompt=list(p), max_new=n)])
        assert alone[0].out == done[i].out


def test_temperature_sampling_is_seeded():
    _, _, model, params = carry("qwen3-1.7b")
    outs = []
    for _ in range(2):
        eng = Engine(model, params, batch=2, max_seq=32, temperature=1.0,
                     seed=3)
        outs.append([r.out for r in eng.generate(
            [Request(prompt=[5, 17, 42], max_new=8)])])
    assert outs[0] == outs[1]
    assert all(0 <= t < model.cfg.padded_vocab for t in outs[0][0])


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma-2b"])
def test_serve_lm_example_runs_on_the_cpu(arch, capsys):
    out = serve_lm.main(["--device", "cpu", "--arch", arch, "--json"])
    assert out["batch_invariant"] is True
    assert [len(t) for t in out["tokens"]] == [n for _, n in PROMPTS]
    assert out["decode_steps"] == 14 + 16     # two batches: 15 and 17 long
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"batch_invariant": true' in last

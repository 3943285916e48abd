"""The timed path broken underneath a run rehearsed on the CPU at a tiny
size, once for each fault a cell can have (one chip: no exchange between
chips to leave out), and the bfloat16 control in the program's place:
each must come out not correct under the cell's limits.  A faulty solve
may run to its cap, so the cap is lowered here to keep the file short."""
import pytest
import torch

from lpbench import run
from lpbench.reference.check import judge, verdict
from lpbench.tests.tiny import one_thread, tiny  # noqa: F401

CAP = 600


def rehearse(cell_name, seed=2**31 + 7):
    bench, cell, config, traffic = tiny(cell_name)
    config["solve"]["iterations"] = CAP
    return run.run_cell(bench, cell, config, traffic, seed, 0.2, False,
                        "cpu")


@pytest.mark.parametrize("cell", ["matching-2m.cold", "multi_budget-2m.cold"])
def test_state_unchanged(cell, monkeypatch):
    """A step that returns its state unchanged: the engine stops (or runs
    out its count) on a dual that never moves, and lam = 0 reads kkt_rel
    1."""
    from repro_torch.core import update_rules

    def stuck(step):
        def rule_step(self, calculate, config, gamma_fn, state, reduce=None):
            _, stats = step(calculate, config, gamma_fn, state)
            return state, stats
        return rule_step
    monkeypatch.setattr(update_rules.AGDRule, "step",
                        stuck(update_rules.agd_step))
    monkeypatch.setattr(update_rules.PDHGRule, "step",
                        stuck(update_rules.pdhg_step))
    result = rehearse(cell)
    assert result["correct"] is False
    assert result["checks"]["kkt_rel"]["value"] == pytest.approx(1.0)


def test_half_the_batch(monkeypatch):
    """Half of the edges left out of Ax, the rest counted double."""
    from repro_torch.core.objectives import MatchingObjective
    reduce_ax = MatchingObjective._reduce_ax

    def half(self):
        self._xbuf[self._xbuf.numel() // 2:] = 0
        return 2 * reduce_ax(self)
    monkeypatch.setattr(MatchingObjective, "_reduce_ax", half)
    for cell in ("matching-2m.cold", "multi_budget-2m.cold"):
        assert rehearse(cell)["correct"] is False, cell


@pytest.mark.parametrize("cell", ["matching-2m.cold", "multi_budget-2m.cold"])
def test_answer_altered(cell, monkeypatch):
    """The answer altered where it is produced: the largest entry of the
    returned lam set to 0."""
    from repro_torch.core.maximizer import Maximizer
    maximize = Maximizer.maximize

    def altered(self, *a, **k):
        res = maximize(self, *a, **k)
        lam = res.lam.clone().reshape(-1)
        lam[torch.argmax(lam)] = 0.0
        return res._replace(lam=lam.reshape(res.lam.shape))
    monkeypatch.setattr(Maximizer, "maximize", altered)
    assert rehearse(cell)["correct"] is False


@pytest.mark.parametrize("cell", ["matching-2m.cold", "multi_budget-2m.cold"])
def test_control_fails(cell, monkeypatch):
    """The reference in bfloat16, in the program's place under its engine,
    fails the cell's limits."""
    from lpbench import control
    from lpbench.instance import instance
    from lpbench.reference.lp import ReferenceLP
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    _, _, config, traffic = tiny(cell)
    run.use_program()
    raw = instance(config["instance"], 11, "cpu")
    ref = ReferenceLP(raw, config)
    ans, _ = control.control_reading(config, traffic, raw, 11, ref.num_rows)
    readings = judge(ref, [ans])
    assert not verdict(readings, config["checks"]), readings

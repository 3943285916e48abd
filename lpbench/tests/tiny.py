"""What the CPU rehearsals share: a cell's files cut to a tiny instance,
and torch on one thread (several threads made the program's CPU path
slower at these sizes)."""
import pytest
import torch

from lpbench import run

TINY = {"num_sources": 600, "num_destinations": 40}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(cell_name):
    """BENCHMARK.json, the cell, its configuration at the tiny size and
    its traffic mix."""
    bench, cell, config, traffic = run.load_cell(cell_name)
    config["instance"].update(TINY)
    return bench, cell, config, traffic

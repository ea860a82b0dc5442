"""Fixtures of the benchmark's own tests (python3 -m pytest benchmark)."""
import pytest
import torch

from benchmark import harness


@pytest.fixture
def cuda_card():
    """The CUDA card; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def small_cell():
    """The cell at 32x32 and 6,000 triangles: about a second a frame on
    the CPU."""
    torch.set_num_threads(4)
    cell = harness.cell("conference-512.whitted")
    cell.config = dict(cell.config, width=32, height=32,
                       scene=dict(cell.config["scene"], triangles=6000))
    return cell


@pytest.fixture
def small_grad_cell():
    """The gradient cell at 32x32, 6,000 triangles and small edge budgets:
    a few seconds a call on the CPU."""
    torch.set_num_threads(4)
    cell = harness.cell("conference-vgrad-512.grad")
    cell.config = dict(cell.config, width=32, height=32,
                       scene=dict(cell.config["scene"], triangles=6000))
    cell.traffic = dict(cell.traffic, edge_samples=4, edge_budget=256,
                        shadow_budget=64)
    return cell

"""A run's ``correct`` on the CPU at a small size: true for the port; false
for the control (the float32 reference in the port's place) and for each
fault these cells can have — an answer altered where it is produced, and a
time step that returns its state unchanged.  The cells have no batch to
halve and no exchange between chips."""

import time

import pytest
import torch

from tgbench.control import Float32Reference
from tgbench.program import Outcome, Program
from tgbench.run import ROOT, load_cell, run_cell

torch.set_num_threads(2)
CELLS = ["poisson96.assembled", "poisson96.matfree", "elasticity48.assembled",
         "poisson96.heat_cn"]
SEED = 2**31 + 977  # seeds go past 32 signed bits


class AlteredAnswer(Program):
    """One entry of every answer moved by 1e-6 of the answer's largest."""

    def run(self, x):
        o = super().run(x)
        out = o.out.clone()
        flat = out.view(-1)
        flat[flat.numel() // 2] += 1e-6 * float(flat.abs().max())
        return Outcome(out, o.iters, o.converged)


class FrozenState(Program):
    """Every θ step returns the state it was given."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        from repro_torch.core import SolveInfo

        def step(u, load=None, bc_values=None, return_info=False):
            return (u, SolveInfo(0, 0.0, True)) if return_info else u

        self.operation.integrator.step = step


def run(workload, program_cls=None, n=6):
    cell = load_cell(ROOT, workload)
    return run_cell(ROOT, cell, SEED, 0.3, False, device="cpu", t0=time.perf_counter(),
                    mesh_n=n, program_cls=program_cls)


@pytest.mark.parametrize("workload", CELLS)
def test_the_port_is_correct(workload):
    result, lines = run(workload)
    assert result["correct"], lines
    assert result["failed"] == 0
    value = result["compared"]["residual_over_target"]
    assert 0 < value["value"] <= value["limit"]
    assert list(result)[-1] == "compared"
    assert lines[-2].startswith("compared residual_over_target")


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    result, _ = run(workload, Float32Reference)
    assert not result["correct"]
    assert result["failed"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_an_altered_answer_is_not_correct(workload):
    result, _ = run(workload, AlteredAnswer)
    assert not result["correct"]


def test_a_frozen_time_step_is_not_correct():
    result, _ = run("poisson96.heat_cn", FrozenState)
    assert not result["correct"]
    assert result["failed"] > 0

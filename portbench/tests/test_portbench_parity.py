"""The plain reference agrees with the program's CPU path at a reduced
size, for both configurations, on a train step and on a prefill, through
the harness's own check; the float8 control and the planted faults are
judged not correct."""
import pytest
import torch

from portbench import bench
from portbench.drivers import prefill
from portbench.tests.tiny import tiny_run

TRAIN = ["yi9b-train-4k", "mixtral-train-4k"]
PREFILL = ["yi9b-prefill-mix", "mixtral-prefill-mix"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", TRAIN)
def test_train_step_matches_reference(cell):
    run = tiny_run(cell, seed=2**32 + 3)
    out = bench.run_cell(run)
    assert out["correct"], out["checks"]
    nums = run.readings["numbers"]
    # float32 on both sides: agreement to rounding
    assert nums["loss"] < 1e-5 and nums["grad_norm"] < 1e-4
    assert nums["grad_diff_max"] < 1e-4
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("cell", PREFILL)
def test_prefill_matches_reference(cell):
    run = tiny_run(cell, seed=2**32 + 5)
    out = bench.run_cell(run)
    assert out["correct"], out["checks"]
    assert run.readings["token_gap"] < 1e-4
    # the window holds whole cycles of the mix's lengths
    assert out["attempted"] % len(prefill.mixes.lengths(
        run.mix["lengths"])) == 0


def test_layouts_are_the_programs_parameters():
    from repro_torch.models import registry
    for cell in TRAIN:
        run = tiny_run(cell)
        model = registry.build_model(run.port_config(), "cpu")
        got = {n: tuple(p.shape) for n, p in model.named_parameters()}
        assert got == {n: tuple(s) for n, s, _ in run.layout}


@pytest.mark.parametrize("cell", TRAIN)
def test_float8_control_separates_train(cell):
    """The reference's products in float8, put in the program's place,
    against the float32 reference, at a reduced size in bf16: at least one
    of the cell's compared numbers reads 3x the bf16 program's or more (the
    separation its limit sits in; the readings at the cell's own size come
    from portbench/readings.py on the card, and test_portbench_cuda.py
    holds them against the limits there)."""
    run = tiny_run(cell, seed=7, dtype="bfloat16")
    run.control = True
    bench.run_cell(run)
    prog, low = run.readings["numbers"], run.readings["control"]
    assert any(low[k] >= 3 * prog[k] for k in run.limits), (prog, low)


@pytest.mark.parametrize("cell", PREFILL)
def test_float8_control_separates_prefill(cell):
    run = tiny_run(cell, seed=7, dtype="bfloat16")
    run.control = True
    bench.run_cell(run)
    low = run.readings["control"]
    assert any(low[k] >= 3 * run.readings[k] for k in run.limits), \
        (run.readings, low)

"""A run with the timed path broken underneath comes out not correct:
each fault that a cell can have, planted where the answer is produced
(one chip: no exchange between chips to leave out)."""
import pytest
import torch

from portbench import bench
from portbench.tests.tiny import tiny_run


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def unchanged_state(step):
    """A step that returns its state unchanged (the loss still computed)."""
    def broken(model, opt, batch):
        from repro_torch.train import make_grad_fn
        _, metrics = make_grad_fn(model.cfg)(model, batch)
        return model, opt, metrics
    return broken


def half_batch(step):
    """Half of the batch's tokens left out, the mean taken over the rest."""
    def broken(model, opt, batch):
        labels = batch["labels"].clone()
        labels[:, labels.shape[1] // 2:] = -1
        return step(model, opt, dict(batch, labels=labels))
    return broken


def moment_altered(step):
    """The state the step produces altered: one leaf's first moment."""
    def broken(model, opt, batch):
        model, opt, m = step(model, opt, batch)
        opt["mu"]["final_norm"].mul_(2.0)
        return model, opt, m
    return broken


def token_altered(serve):
    """One position's logits altered where they are produced: its served
    token becomes the position's least likely one."""
    def broken(model, batch):
        logits = serve(model, batch)
        mid = logits.shape[1] // 2
        logits[:, mid] = -logits[:, mid]
        return logits
    return broken


def answer_shifted(serve):
    """Every answer off by one position."""
    def broken(model, batch):
        return torch.roll(serve(model, batch), 1, dims=1)
    return broken


TRAIN = ["yi9b-train-4k", "mixtral-train-4k"]


@pytest.mark.parametrize("fault", [unchanged_state, half_batch,
                                   moment_altered])
@pytest.mark.parametrize("cell", TRAIN)
def test_train_fault_is_not_correct(cell, fault):
    out = bench.run_cell(tiny_run(cell, entry=fault, seconds=0.2))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell,fault", [
    ("yi9b-prefill-mix", token_altered),
    ("yi9b-prefill-mix", answer_shifted),
    ("mixtral-prefill-mix", answer_shifted),
])
def test_prefill_fault_is_not_correct(cell, fault):
    out = bench.run_cell(tiny_run(cell, entry=fault, seconds=0.2))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", TRAIN + ["yi9b-prefill-mix",
                                          "mixtral-prefill-mix"])
def test_sound_run_is_correct(cell):
    out = bench.run_cell(tiny_run(cell, seconds=0.2))
    assert out["correct"], out["checks"]

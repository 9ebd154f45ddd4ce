"""optim_ms: a training step's wall less the wall of the gradient alone
(``make_grad_fn``) on the same batch, medians over the traced run's pairs
(host clock, timed from outside the step)."""


def read(run):
    if not run.stretch or "optim_ms" not in run.stretch:
        return None
    return run.stretch["optim_ms"]

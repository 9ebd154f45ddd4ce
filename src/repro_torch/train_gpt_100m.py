"""End-to-end driver: train the paper's GPT (~100M params) for a few hundred
steps on the synthetic pipeline; checkpoint + loss curve.

    PYTHONPATH=src python -m repro_torch.train_gpt_100m [--steps 300] \\
        [--device cpu] [--reduced]

The full gpt config (12 layers, d_model 768, 12 heads of 64, bf16) with
random weights from seed 0, AdamW (lr 1e-3, 20 warm-up steps) and two
microbatches of gradient accumulation (the verified path), on
``--device`` (``cuda`` unless ``cpu`` is asked for; no CUDA device is an
error, not a fallback); ``--reduced`` takes the reduced config (fp32) for
a quick run. Prints the loss and gradient norm every 50 steps, writes the
parameters in the JAX package's checkpoint format (``{"params": tree}``,
see ``models.convert.to_jax``) to ``--ckpt`` and exits 1 unless the last
loss is below the first.

A bf16 checkpoint is written but cannot be restored: the JAX package's
restore fails on it the same way (its known fault, kept here so the two
formats stay one).
"""
import argparse
import os
import sys
import tempfile
import time

from repro_torch.checkpoint import save_checkpoint
from repro_torch.data.pipeline import SyntheticTextDataset
from repro_torch.models import convert, registry
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainConfig, make_train_step, trainable

TRAIN_CONFIG = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=20),
                           microbatches=2)   # grad accumulation


def train(model, steps: int = 300, batch: int = 8, seq: int = 256,
          ckpt=None, tcfg: TrainConfig = TRAIN_CONFIG, log_every: int = 50,
          on_step=None) -> dict:
    """Train ``model`` (made trainable here) for ``steps`` steps of
    ``SyntheticTextDataset(vocab, seq, batch, seed 0)`` on the model's
    device; ``on_step(step, metrics)`` runs after each step. Writes the
    checkpoint when ``ckpt`` is given. Returns the per-step ``losses``,
    ``grad_norms`` and wall ``step_ms`` (each step waited for), ``first``
    and ``last`` loss."""
    cfg = model.cfg
    device = next(model.parameters()).device
    trainable(model)
    opt = adamw.init(dict(model.named_parameters()))
    step_fn = make_train_step(cfg, tcfg)
    ds = SyntheticTextDataset(vocab=cfg.vocab, seq_len=seq, batch=batch,
                              seed=0)
    out = {"losses": [], "grad_norms": [], "step_ms": []}
    t0 = time.time()
    for step in range(steps):
        data = ds.batch_at(step, device)
        t = time.perf_counter()
        model, opt, metrics = step_fn(model, opt, data)
        loss = float(metrics["loss"])            # waits for the step
        out["step_ms"].append((time.perf_counter() - t) * 1e3)
        out["losses"].append(loss)
        out["grad_norms"].append(float(metrics["grad_norm"]))
        if on_step is not None:
            on_step(step, metrics)
        if log_every and (step % log_every == 0 or step == steps - 1):
            print(f"step {step:4d} loss {loss:.4f} "
                  f"gnorm {out['grad_norms'][-1]:.3f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    out["first"], out["last"] = out["losses"][0], out["losses"][-1]
    if ckpt:
        save_checkpoint(ckpt, steps, {"params": convert.to_jax(model)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.train_gpt_100m",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                  "repro_torch_gpt_ckpt"))
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced config (fp32) for a quick run")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the model trains (default: cuda, which "
                         "must exist)")
    args = ap.parse_args(argv)
    cfg = registry.load_config("gpt")
    if args.reduced:
        cfg = cfg.reduced()
    print(f"model: {cfg.name}  params={registry.n_params(cfg) / 1e6:.1f}M")
    model = registry.init_params(cfg, 0, args.device)
    res = train(model, args.steps, args.batch, args.seq, args.ckpt)
    print(f"loss {res['first']:.3f} -> {res['last']:.3f}; checkpoint at "
          f"{args.ckpt}")
    if not res["last"] < res["first"]:
        print("error: loss did not decrease", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

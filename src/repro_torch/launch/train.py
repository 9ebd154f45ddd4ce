"""Training launcher: the seeded model, AdamW and the synthetic data.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt --steps 100

Trains the reduced config (fp32) unless ``--full`` is given, on ``cuda``
unless ``--device cpu`` is asked for; prints ``step k loss x`` every 10
steps and, with ``--ckpt DIR``, writes the parameters in the JAX
package's checkpoint format at the end (``{"params": tree}`` in the JAX
package's tree layout, see ``models.convert.to_jax``).
"""
import argparse

from ..checkpoint import save_checkpoint
from ..data.pipeline import SyntheticTextDataset
from ..models import convert, registry
from ..train.loop import TrainConfig, init_state, make_train_step


def parser() -> argparse.ArgumentParser:
    """The JAX launcher's flags and defaults, and ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="use the full config (bf16, published widths)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the model trains (default: cuda, which "
                         "must exist)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    cfg = registry.load_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    model, opt = init_state(cfg, 0, args.device)
    device = next(model.parameters()).device
    step_fn = make_train_step(cfg, TrainConfig())
    ds = SyntheticTextDataset(vocab=cfg.vocab, seq_len=args.seq,
                              batch=args.batch)
    for step in range(args.steps):
        model, opt, m = step_fn(model, opt, ds.batch_at(step, device))
        if step % 10 == 0:
            print(f"step {step} loss {float(m['loss']):.4f}")
    if args.ckpt:
        save_checkpoint(args.ckpt, args.steps,
                        {"params": convert.to_jax(model)})


if __name__ == "__main__":
    main()

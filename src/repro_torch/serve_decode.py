"""Serving demo: prefill + batched greedy decode with gemma3-12b (sliding-
window + global KV caches).

    PYTHONPATH=src python -m repro_torch.serve_decode [--full] [--device cpu]

The reduced config (fp32) unless ``--full`` is given (the published
widths and depth in bf16: 48 layers, d_model 3840), with random weights
from seed 0, on ``--device`` (``cuda`` unless ``cpu`` is asked for; no
CUDA device is an error, not a fallback). B=4 prompts of 12 tokens drawn
from a generator seeded with 1 are prefilled one position at a time into
a cache of 64 positions, then 16 tokens are decoded greedily.
"""
import argparse
import sys

import torch

from repro_torch.models import registry
from repro_torch.train import serve

ARCH, BATCH, PROMPT, GEN, MAX_SEQ = "gemma3-12b", 4, 12, 16, 64


def make_prompt(cfg, batch: int, prompt_len: int,
                device=None) -> torch.Tensor:
    """(batch, prompt_len) int64 token ids below ``cfg.vocab``, drawn on
    the CPU from a generator seeded with 1 (the same ids on every
    device)."""
    g = torch.Generator().manual_seed(1)
    return torch.randint(0, cfg.vocab, (batch, prompt_len),
                         generator=g).to(device)


def serve_decode(model, prompt: torch.Tensor, gen: int = GEN,
                 max_seq: int = MAX_SEQ) -> dict:
    """Sequential prefill of ``prompt`` (B, S), the argmax of the last
    position's logits, then ``gen`` greedy decode steps from position S.
    Returns ``{"cache", "logits" (B, S, vocab), "tokens" (B, gen)}``."""
    cache, logits = serve.sequential_prefill(model, prompt, max_seq)
    last = logits[:, -1].argmax(dim=-1)[:, None]
    cache, toks = serve.decode_tokens(model, cache, last, prompt.shape[1],
                                      gen)
    return {"cache": cache, "logits": logits, "tokens": toks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve_decode",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="use the full config (bf16, published widths)")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the model runs (default: cuda, which must "
                         "exist)")
    args = ap.parse_args(argv)
    cfg = registry.load_config(ARCH)
    if not args.full:
        cfg = cfg.reduced()
    model = registry.init_params(cfg, 0, args.device)
    prompt = make_prompt(cfg, BATCH, PROMPT, next(model.parameters()).device)
    toks = serve_decode(model, prompt)["tokens"]
    print("prompt tokens:", prompt[0, :8].tolist(), "...")
    print("generated    :", toks[0].tolist())
    if tuple(toks.shape) != (BATCH, GEN):
        print(f"error: tokens of shape {tuple(toks.shape)}, not "
              f"{(BATCH, GEN)}", file=sys.stderr)
        return 1
    print("ok: batched decode with ring-buffer local cache + global cache")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Training step: CE loss (+ MoE aux), grad accumulation, AdamW.

The JAX package's ``jax.value_and_grad`` of the loss over the parameter
tree becomes ``torch.autograd.grad`` over the model's named parameters,
which ``init_state`` (or ``trainable``) marks as requiring grad: the
models build them without, for serving. On the card the forward reaches
the RMSNorm and flash-attention kernels through their autograd Functions,
whose backward is each kernel's closed-form gradient in torch ops.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from ..models import registry
from ..models.layers import seq_gathered
from ..obs import trace as obs_trace
from ..sharding.specs import reduce_partial
from ..models.config import ModelConfig
from ..optim import adamw
from ..optim.adamw import AdamWConfig


@dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    microbatches: int = 1          # gradient accumulation steps
    z_loss: float = 0.0


CE_CHUNKS = 8   # sequence-chunked vocab-parallel CE (bounds logits memory)


def _ce_piece(cfg, tcfg, w, xc, lc):
    """CE over one sequence chunk; logits never materialize for full S.
    Spans: ``rt.train.ce`` (the forward, and the checkpoint's recompute)
    and ``rt.train.ce.bwd`` (the chunk's backward)."""
    bwd = obs_trace.backward_range("rt.train.ce.bwd")
    xc, w = bwd.close_at(xc, w)
    with obs_trace.span("rt.train.ce"):
        logits = (xc @ w.to(xc.dtype)).float()
        if cfg.logit_softcap:
            logits = torch.tanh(logits / 30.0) * 30.0
        lse = torch.logsumexp(logits, dim=-1)
        tgt = reduce_partial(torch.gather(
            logits, -1, lc.clamp(min=0).long()[..., None]))[..., 0]
        mask = (lc >= 0).float()
        nll = -((tgt - lse) * mask).sum()
        z = torch.square(lse * mask).sum() if tcfg.z_loss \
            else torch.zeros((), device=logits.device)
        cnt = mask.sum()
    return bwd.open_at(nll, cnt, z)


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig = TrainConfig()):
    """``loss_fn(model, batch) -> (loss, metrics)``: mean token CE over the
    labels that are not -1, plus the z-loss and the MoE aux loss."""
    def loss_fn(model, batch):
        hidden, extras = registry.forward(model, batch, return_hidden=True)
        hidden = seq_gathered(hidden)   # a mesh's SP residual, gathered
        labels = batch["labels"]
        # VLM: hidden covers [vision tokens ; text tokens]; labels are padded
        # with ignore (-1) on the vision prefix by the pipeline/input spec.
        B, S, D = hidden.shape
        w = model.embed.T if cfg.tie_embeddings else model.unembed
        # recomputed in the backward (jax.checkpoint): a chunk's fp32
        # logits are never kept
        piece = partial(checkpoint, partial(_ce_piece, cfg, tcfg, w),
                        use_reentrant=False)
        c = S // CE_CHUNKS if S % CE_CHUNKS == 0 and S >= CE_CHUNKS else S
        nll = cnt = zacc = 0.0
        for i in range(0, S, c):
            n_, c_, z_ = piece(hidden[:, i:i + c], labels[:, i:i + c])
            nll, cnt, zacc = nll + n_, cnt + c_, zacc + z_
        loss = nll / torch.clamp(cnt, min=1.0)
        if tcfg.z_loss:
            loss = loss + tcfg.z_loss * zacc / torch.clamp(cnt, min=1.0)
        metrics = {"ce_loss": loss.detach()}
        if extras and "aux_loss" in extras:
            loss = loss + extras["aux_loss"]
            metrics["aux_loss"] = extras["aux_loss"].detach()
        metrics["loss"] = loss.detach()
        return loss, metrics
    return loss_fn


def trainable(model):
    """Mark every parameter of ``model`` as requiring grad; returns it."""
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def make_grad_fn(cfg: ModelConfig, tcfg: TrainConfig = TrainConfig()):
    """Returns grad_fn(model, batch) -> (grads, metrics): the gradient of
    the loss with respect to every named parameter, as a dict.

    With tcfg.microbatches > 1, the batch's leading dim is split and
    gradients are accumulated in fp32 (the strategy verified in paper bug
    #6 — the accumulated loss must be scaled by 1/n_microbatches)."""
    loss_fn = make_loss_fn(cfg, tcfg)

    def single(model, batch):
        params = dict(model.named_parameters())
        loss, metrics = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), grads)}
        return grads, metrics

    def accumulate(model, batch):
        n = tcfg.microbatches
        acc = None
        per_micro = []
        for i in range(n):
            mb = {k: x.reshape((n, x.shape[0] // n) + x.shape[1:])[i]
                  for k, x in batch.items()}
            grads, metrics = single(model, mb)
            with obs_trace.span("rt.train.accumulate"):
                if acc is None:
                    acc = {k: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device)
                           for k, g in grads.items()}
                # paper bug #6: this 1/n scaling is what buggy impls forget
                acc = {k: acc[k] + grads[k] / n for k in acc}
            per_micro.append(metrics)
        metrics = {k: torch.stack([m[k] for m in per_micro]).mean()
                   for k in per_micro[0]}
        return acc, metrics

    return accumulate if tcfg.microbatches > 1 else single


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig = TrainConfig()):
    """Returns train_step(model, opt_state, batch) -> (model, opt, metrics);
    the model's parameters and ``opt`` are updated in place, and
    ``metrics`` holds the loss terms and the gradient's global norm."""
    grad_fn = make_grad_fn(cfg, tcfg)

    def train_step(model, opt_state, batch):
        with obs_trace.span("rt.train.step"):
            grads, metrics = grad_fn(model, batch)
            _, opt_state, gnorm = adamw.update(
                grads, opt_state, dict(model.named_parameters()),
                tcfg.optimizer)
        metrics["grad_norm"] = gnorm
        return model, opt_state, metrics

    return train_step


def init_state(cfg: ModelConfig, seed: int = 0, device=None):
    """``(model, opt_state)``: the model with random weights from ``seed``
    on ``device`` (``cuda`` unless ``"cpu"`` is asked for), trainable, and
    its AdamW state."""
    model = trainable(registry.init_params(cfg, seed, device))
    opt_state = adamw.init(dict(model.named_parameters()))
    return model, opt_state

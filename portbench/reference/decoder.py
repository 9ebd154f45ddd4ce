"""Plain PyTorch reference of a decoder-only transformer, dense or with
top-k experts under a capacity, its training loss and its AdamW, in float32.

It imports no module of the program. It follows the semantics the program
states for itself, which are those of the configuration file's
``semantics``:

- the input embedding's rows times sqrt(hidden_size);
- RMSNorm as ``x * rsqrt(mean(x^2) + eps) * (1 + scale)``;
- RoPE on the two halves of each head (``rotate_half``), theta from the
  file; causal softmax attention at hd^-0.5 over grouped KV heads, with a
  causal sliding window where the file gives one;
- SwiGLU MLP ``(silu(x Wg) * (x Wu)) Wd``; or, with experts, the router's
  fp32 logits ``x R``, softmax probabilities, the top-k logits (ties to
  the lower index) and their softmax as gates; each (token, choice) row in
  token order, stably sorted by expert, and kept while its place within
  its expert is below the capacity ceil(T k / E * 1.25); a dropped row adds
  nothing; the auxiliary loss E * sum_e (rows_e / (T k)) * mean_t p_te *
  coef, summed over layers and added to the loss;
- the loss: the mean token cross-entropy of ``h Wu`` (labels -1 ignored);
- AdamW: the gradient clipped to a global norm, fp32 moments, bias
  correction, the learning rate warmed up linearly from 0, the weight
  decay added into the update, and the parameter cast back to the
  configuration's dtype after each step.

Products go through ``Products``: float32 (TF32 off), or, for the
control, both operands rounded to float8 e4m3 with a per-tensor scale (the
gradients' products too).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

CAPACITY_FACTOR = 1.25
Q_BLOCK = 512          # query rows an attention block takes
NEG_INF = -1e30
FP8_MAX = 448.0        # float8 e4m3's largest finite value


# ---------------------------------------------------------------------------
# Sizes and layout
# ---------------------------------------------------------------------------

class Sizes:
    """The configuration file's sizes, under short names."""

    def __init__(self, c: dict):
        self.d = c["hidden_size"]
        self.H = c["num_attention_heads"]
        self.KV = c["num_key_value_heads"]
        self.hd = c.get("head_dim") or self.d // self.H
        self.f = c["intermediate_size"]
        self.L = c["num_hidden_layers"]
        self.V = c["vocab_size"]
        self.E = c.get("num_local_experts") or 0
        self.K = c.get("num_experts_per_tok") or 0
        self.theta = float(c["rope_theta"])
        self.eps = float(c["rms_norm_eps"])
        self.window = c.get("sliding_window") or 0
        self.aux_coef = float(c.get("semantics", {}).get("aux_loss_coef", 0.0))


def layout(c: dict) -> list:
    """``[(name, shape, kind)]``: every parameter, in a fixed order; kind is
    "matrix" or "norm". Weights are (d_in, d_out), applied as ``x @ W``."""
    s = Sizes(c)
    d, hd = s.d, s.hd
    out = [("embed", (s.V, d), "matrix"), ("unembed", (d, s.V), "matrix"),
           ("final_norm", (d,), "norm")]
    for i in range(s.L):
        b = f"blocks.{i}."
        out += [(b + "pre_attn", (d,), "norm"), (b + "pre_mlp", (d,), "norm"),
                (b + "attn.wq", (d, s.H * hd), "matrix"),
                (b + "attn.wk", (d, s.KV * hd), "matrix"),
                (b + "attn.wv", (d, s.KV * hd), "matrix"),
                (b + "attn.wo", (s.H * hd, d), "matrix")]
        if s.E:
            out += [(b + "moe.router", (d, s.E), "matrix"),
                    (b + "moe.wg", (s.E, d, s.f), "matrix"),
                    (b + "moe.wu", (s.E, d, s.f), "matrix"),
                    (b + "moe.wd", (s.E, s.f, d), "matrix")]
        else:
            out += [(b + "mlp.wg", (d, s.f), "matrix"),
                    (b + "mlp.wu", (d, s.f), "matrix"),
                    (b + "mlp.wd", (s.f, d), "matrix")]
    return out


# ---------------------------------------------------------------------------
# Products
# ---------------------------------------------------------------------------

def fp8_round(x):
    """x rounded to float8 e4m3 under a per-tensor scale (amax to 448)."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return fp8_round(a) @ fp8_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g8 = fp8_round(g)
        a2 = fp8_round(a).reshape(-1, a.shape[-1])
        return (g8 @ fp8_round(b).transpose(-1, -2),
                a2.transpose(0, 1) @ g8.reshape(-1, g.shape[-1]))


class Products:
    """``mm(a, b)``: the reference's weight products in ``precision``
    ("float32" or "float8")."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "float8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def mm(self, a, b):
        if self.precision == "float8":
            return _Fp8Matmul.apply(a, b)
        return a @ b


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x, pos, theta):
    """x (B, S, h, hd): the halves rotated by pos * theta^(-i / (hd/2))."""
    hd = x.shape[-1]
    inv = theta ** (-torch.arange(hd // 2, dtype=torch.float32,
                                  device=x.device) / (hd // 2))
    ang = pos.float()[:, None] * inv
    c, s = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(q, k, v, window):
    """Causal attention of q (B, S, H, hd) over k, v (B, S, KV, hd), a block
    of Q_BLOCK query rows at a time; a causal window where window > 0."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2).transpose(1, 2)     # (B, H, S, hd)
    v = v.repeat_interleave(G, dim=2).transpose(1, 2)
    qt = q.transpose(1, 2)
    kpos = torch.arange(S, device=q.device)
    outs = []
    for s0 in range(0, S, Q_BLOCK):
        s1 = min(S, s0 + Q_BLOCK)
        qpos = kpos[s0:s1]
        sc = (qt[:, :, s0:s1] @ k[:, :, :s1].transpose(-1, -2)) / math.sqrt(hd)
        seen = kpos[None, :s1] <= qpos[:, None]
        if window:
            seen &= qpos[:, None] - kpos[None, :s1] < window
        sc = torch.where(seen, sc, NEG_INF)
        outs.append(torch.softmax(sc, dim=-1) @ v[:, :, :s1])
    return torch.cat(outs, dim=2).transpose(1, 2).reshape(B, S, H * hd)


def capacity(T: int, K: int, E: int) -> int:
    return max(int(math.ceil(T * K / E * CAPACITY_FACTOR)), 1)


def experts(w, s: Sizes, x, P: Products):
    """x (T, d) -> (y, aux): top-k routing under the capacity."""
    T = x.shape[0]
    E, K = s.E, s.K
    logits = x @ w["router"]
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(top[:, :K], dim=-1)              # (T, K)
    idx = idx[:, :K]
    C = capacity(T, K, E)
    onehot = F.one_hot(idx.reshape(T * K), E)              # rows in token order
    place = (torch.cumsum(onehot, 0) - onehot)[torch.arange(T * K), idx.reshape(-1)]
    kept = (place < C).reshape(T, K)
    y = torch.zeros_like(x)
    for e in range(E):
        rows, choice = torch.nonzero((idx == e) & kept, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        h = F.silu(P.mm(xe, w["wg"][e])) * P.mm(xe, w["wu"][e])
        y = y.index_add(0, rows, P.mm(h, w["wd"][e]) * gates[rows, choice, None])
    counts = onehot.sum(0).float()
    aux = E * torch.sum(counts / (T * K) * probs.mean(0)) * s.aux_coef
    return y, aux


def block(w, s: Sizes, P: Products, x, pos):
    """One layer: x (B, S, d) -> (x, aux)."""
    B, S, d = x.shape
    h = rmsnorm(x, w["pre_attn"], s.eps)
    q = P.mm(h, w["attn.wq"]).reshape(B, S, s.H, s.hd)
    k = P.mm(h, w["attn.wk"]).reshape(B, S, s.KV, s.hd)
    v = P.mm(h, w["attn.wv"]).reshape(B, S, s.KV, s.hd)
    q, k = rope(q, pos, s.theta), rope(k, pos, s.theta)
    x = x + P.mm(attention(q, k, v, s.window), w["attn.wo"])
    h = rmsnorm(x, w["pre_mlp"], s.eps)
    if s.E:
        y, aux = experts({n[4:]: t for n, t in w.items() if n.startswith("moe.")},
                         s, h.reshape(B * S, d), P)
        return x + y.reshape(B, S, d), aux
    y = P.mm(F.silu(P.mm(h, w["mlp.wg"])) * P.mm(h, w["mlp.wu"]), w["mlp.wd"])
    return x + y, torch.zeros((), device=x.device)


def layer_weights(w: dict, i: int) -> dict:
    pre = f"blocks.{i}."
    return {n[len(pre):]: t for n, t in w.items() if n.startswith(pre)}


def hidden(w: dict, c: dict, tokens, P: Products, remat: bool = False):
    """The final normed hidden state (B, S, d) and the summed aux loss;
    ``remat``: each layer recomputed in the backward (memory)."""
    s = Sizes(c)
    x = w["embed"][tokens].float() * math.sqrt(s.d)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    aux = torch.zeros((), device=x.device)
    for i in range(s.L):
        lw = {n: t.float() for n, t in layer_weights(w, i).items()}
        if remat:
            x, a = checkpoint(block, lw, s, P, x, pos, use_reentrant=False)
        else:
            x, a = block(lw, s, P, x, pos)
        aux = aux + a
    return rmsnorm(x, w["final_norm"].float(), s.eps), aux


@torch.no_grad()
def logits(w: dict, c: dict, tokens, P: Products = Products()):
    """(B, S, V) float32 logits of every position; ``w`` in any dtype,
    each layer's leaves taken to float32 as that layer runs."""
    h, _ = hidden(w, c, tokens, P)
    return P.mm(h, w["unembed"].float())


CE_BLOCK = 1024


def _ce(h, wu, labels, P):
    lg = P.mm(h, wu)
    lse = torch.logsumexp(lg, dim=-1)
    tgt = torch.gather(lg, -1, labels.clamp(min=0)[..., None])[..., 0]
    return -((tgt - lse) * (labels >= 0)).sum()


def loss(w: dict, c: dict, batch: dict, P: Products, remat: bool = True):
    """The mean token cross-entropy over labels that are not -1, plus the
    experts' aux loss."""
    h, aux = hidden(w, c, batch["tokens"], P, remat)
    labels = batch["labels"]
    nll = 0.0
    for s0 in range(0, h.shape[1], CE_BLOCK):
        nll = nll + checkpoint(_ce, h[:, s0:s0 + CE_BLOCK], w["unembed"],
                               labels[:, s0:s0 + CE_BLOCK], P,
                               use_reentrant=False)
    return nll / (labels >= 0).sum().clamp(min=1) + aux


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@torch.no_grad()
def adamw(w: dict, grads: dict, m: dict, v: dict, step: int, opt: dict,
          dtype, pick=None) -> tuple:
    """One AdamW step in place; returns (global norm, the clipped
    gradients' norms by leaf, ``pick(name, gradient)`` by leaf)."""
    gn = torch.sqrt(sum(torch.sum(g.square()) for g in grads.values()))
    scale = torch.clamp(opt["clip_norm"] / (gn + 1e-9), max=1.0) \
        if opt["clip_norm"] else gn.new_ones(())
    lr = opt["lr"] * min(step / max(opt["warmup_steps"], 1), 1.0)
    bc1, bc2 = 1 - opt["b1"] ** step, 1 - opt["b2"] ** step
    norms, picked = {}, {}
    for n, p in w.items():
        g = grads[n] * scale
        norms[n] = torch.linalg.vector_norm(g)
        if pick:
            picked[n] = pick(n, g)
        m[n].mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
        v[n].mul_(opt["b2"]).add_(g.square(), alpha=1 - opt["b2"])
        delta = (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + opt["eps"]) \
            + opt["weight_decay"] * p
        p.copy_((p - lr * delta).to(dtype).float())
    return gn, norms, picked


def train_steps(w0: dict, c: dict, batches, opt: dict, dtype,
                precision: str = "float32", pick=None,
                microbatches: int = 1) -> dict:
    """len(batches) training steps from the weights ``w0`` (any dtype; held
    as float32 leaves). Each batch's rows are split into ``microbatches``
    equal parts; a step's gradient is the mean of theirs (summed in
    float32 as each is taken) and its loss the mean of their losses.
    Returns each step's loss, the first step's clipped gradient by leaf
    (its norm, and ``pick(name, gradient)``), and by leaf the norm of the
    parameters' change over all the steps."""
    P = Products(precision)
    w = {n: t.detach().float().clone().requires_grad_(True)
         for n, t in w0.items()}
    m = {n: torch.zeros_like(t) for n, t in w.items()}
    v = {n: torch.zeros_like(t) for n, t in w.items()}
    losses, g1, g1_sample = [], None, None
    for i, batch in enumerate(batches):
        R = batch["tokens"].shape[0] // microbatches
        total = 0.0
        for k in range(microbatches):
            part = {key: x[k * R:(k + 1) * R] for key, x in batch.items()}
            lv = loss(w, c, part, P) / microbatches
            lv.backward()                 # summed into each leaf's .grad
            total += float(lv.detach())
            del lv
        losses.append(total)
        grads = {n: t.grad for n, t in w.items()}
        _, norms, picked = adamw(w, grads, m, v, i + 1, opt, dtype,
                                 pick if i == 0 else None)
        del grads
        for t in w.values():
            t.grad = None
        if g1 is None:
            g1 = {n: float(x) for n, x in norms.items()}
            g1_sample = picked
    change = {n: float(torch.linalg.vector_norm(w[n].detach() - w0[n].float()))
              for n in w}
    return dict(losses=losses, grad_norms=g1, change_norms=change,
                grad_sample=g1_sample)

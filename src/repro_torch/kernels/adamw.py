"""AdamW's update as two hand-written CUDA C++ kernels, beside its plain
PyTorch version.

Replaces no TPU kernel: the JAX package's update
(``src/repro/optim/adamw.py:36-66``) is one XLA fusion. ``update_plain``,
the plain version, runs it as ~20 eager passes over fp32 temporaries a
leaf, about 200 bytes of memory traffic a parameter; the update is bound by
bytes, and needs 28 a parameter (bf16 parameter, fp32 gradient): the norm
reads the gradient once (4 B), the update reads p, g, m and v and writes
p, m and v (24 B). ``csrc/adamw.cu`` (built by ``kernels/build.py``, bound
here with ctypes) moves only those bytes: ``adamw_sumsq`` reads each
gradient leaf once into per-block partial sums, one more block reduces
them in a fixed order into the global norm and the clip's scale on the
device (no atomics: the same gradient gives the same bits), and
``adamw_update`` updates each leaf in one pass, in the plain version's
arithmetic and order, every step rounded alone: it gives the plain
version's bits. Each kernel launches once a leaf and counts its launches
(``adamw_sumsq``, ``adamw_update`` in ``ops.launch_counts``).

``takes_kernels`` says which leaves take the kernels: plain CUDA tensors.
A DTensor, a fake tensor (the dry run's) or a meta tensor keeps the plain
version, as ``ops`` sends those to the custom ops (``is_wrapped``), and so
does the CPU. A mesh's DTensors on the card therefore take the eager
update. Both versions take the step's learning rate and bias corrections
from ``optim.adamw``, which owns the schedule; this module holds the
launchers, their checks and the plain arithmetic.
On the kernels' path a leaf that is not contiguous, whose gradient or
moments differ from it in shape, or whose (parameter, gradient) dtypes are
not bf16/fp32, bf16/bf16 or fp32/fp32 raises: there is no fallback. Nothing
on either path waits for the device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..sharding.specs import is_dtensor, is_wrapped
from . import build
from .rmsnorm import sm_count

# A leaf's update in fp32 makes a few temporaries of the leaf's size; a leaf
# of more elements than this is updated a run of rows at a time, so that
# they stay within ~5 x 256 MB (a 256k-row embedding's would be ~40 GB).
# Each element's arithmetic is the same either way.
UPDATE_CHUNK = 1 << 26

# (parameter dtype, gradient dtype) -> the kernel's instance
PAIRS = {(torch.bfloat16, torch.float32): 0, (torch.bfloat16, torch.bfloat16): 1,
         (torch.float32, torch.float32): 2}
THREADS = 256           # a block's (csrc/adamw.cu: kThreads)
SUMSQ_BLOCKS_PER_SM = 8  # resident blocks an SM holds of each kernel
UPDATE_BLOCKS_PER_SM = 4


def plain_norm(grads, clip: float):
    """``(gnorm, scale)``: the plain version's global norm of the gradient
    leaves ``grads`` and ``min(clip / (gnorm + 1e-9), 1)``."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(gp.float()))
                           for g in grads for (gp,) in _pieces(g)))
    return gnorm, torch.clamp(clip / (gnorm + 1e-9), max=1.0)


def plain_leaves(grads: dict, mu: dict, nu: dict, params: dict, scale, lr,
                 bc1, bc2, cfg) -> None:
    """The plain version's update of every leaf in place, given the clip's
    ``scale`` (or None), the learning rate and the bias corrections."""
    b1, b2 = cfg.b1, cfg.b2
    # one parameter (or run of its rows) at a time: its fp32 temporaries
    # are freed before the next one's are made
    for n, p in params.items():
        for pp, gp, m, v in _pieces(p, grads[n], mu[n], nu[n]):
            g = gp.float()
            if scale is not None:
                g = g * scale
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            pf = pp.float()
            if cfg.weight_decay:
                delta = delta + cfg.weight_decay * pf
            pp.copy_((pf - lr * delta).to(pp.dtype))


def update_plain(grads: dict, mu: dict, nu: dict, params: dict, cfg, lr,
                 bc1, bc2):
    """The kernels' plain version: ``optim.adamw.update``'s step in torch
    ops, one leaf (or run of its rows) at a time, given its learning rate
    and bias corrections (0-d fp32); returns the global norm (0 with no
    clip)."""
    scale = None
    if cfg.clip_norm:
        gnorm, scale = plain_norm(grads.values(), cfg.clip_norm)
    else:
        gnorm = torch.zeros((), device=lr.device)
    plain_leaves(grads, mu, nu, params, scale, lr, bc1, bc2, cfg)
    return gnorm


def _pieces(*ts):
    """``ts`` (tensors of one shape) whole, or, past UPDATE_CHUNK elements,
    as views of runs of their leading rows of at most UPDATE_CHUNK elements
    (or one row); a DTensor is left whole, as its shards are."""
    t = ts[0]
    if t.numel() <= UPDATE_CHUNK or t.dim() == 0 or is_dtensor(t):
        yield ts
        return
    rows = max(1, UPDATE_CHUNK * t.shape[0] // t.numel())
    for i in range(0, t.shape[0], rows):
        yield tuple(x[i:i + rows] for x in ts)


def takes_kernels(*leaf_sets) -> bool:
    """Whether an update of these leaves (dicts of tensors) takes the
    kernels: some leaf is on CUDA, and none is a DTensor, a fake tensor or
    on ``meta``."""
    cuda = False
    for leaves in leaf_sets:
        for t in leaves.values():
            if is_wrapped(t) or t.is_meta:
                return False
            cuda = cuda or t.is_cuda
    return cuda


class UpdateArgs(ctypes.Structure):
    """``AdamwArgs`` of ``csrc/adamw.cu``: the plain version's constants as
    floats (``1 - b1`` formed in Python, as the plain version forms it)."""
    _fields_ = [("b1", ctypes.c_float), ("omb1", ctypes.c_float),
                ("b2", ctypes.c_float), ("omb2", ctypes.c_float),
                ("eps", ctypes.c_float), ("wd", ctypes.c_float),
                ("decay", ctypes.c_int)]


@functools.lru_cache(maxsize=64)
def update_args(b1: float, b2: float, eps: float, weight_decay: float):
    return UpdateArgs(b1, 1 - b1, b2, 1 - b2, eps, weight_decay,
                      bool(weight_decay))


@functools.cache
def _lib():
    lib = build.load("adamw")
    lib.repro_adamw_sumsq.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p]
    lib.repro_adamw_sumsq_finish.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.repro_adamw_update.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.POINTER(UpdateArgs), ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.repro_adamw_sumsq, lib.repro_adamw_sumsq_finish,
               lib.repro_adamw_update):
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({_lib().repro_cuda_error_string(err).decode()})")


def grid(n: int, per_thread: int, blocks_per_sm: int, n_sm: int) -> int:
    """Blocks for ``n`` elements, ``per_thread`` a thread a step: as many as
    the card holds at once, never more than the elements need."""
    return max(1, min(n_sm * blocks_per_sm,
                      -(-n // (per_thread * THREADS))))


def adamw_sumsq(grads, clip: float):
    """``(gnorm, scale)``, 0-d fp32 on the device: the global norm of the
    gradient leaves ``grads`` (CUDA, contiguous, bf16 or fp32) and
    ``min(clip / (gnorm + 1e-9), 1)``. One launch a leaf (counted), and one
    that reduces every leaf's partials."""
    dev = grads[0].device
    grads = [g for g in grads if g.numel()]
    n_sm = sm_count(dev.index)
    grids = [grid(g.numel(), 16 // g.element_size(), SUMSQ_BLOCKS_PER_SM,
                  n_sm) for g in grads]
    partial = torch.empty(sum(grids), dtype=torch.float32, device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    lib, off = _lib(), 0
    for g, blocks in zip(grads, grids):
        _raise_on(lib.repro_adamw_sumsq(
            g.data_ptr(), g.numel(), g.dtype == torch.bfloat16,
            partial.data_ptr() + 4 * off, blocks, stream), "adamw_sumsq launch")
        adamw_sumsq.launches += 1
        off += blocks
    _raise_on(lib.repro_adamw_sumsq_finish(
        partial.data_ptr(), off, clip, out.data_ptr(), stream),
        "adamw_sumsq finish launch")
    return out[0], out[1]


adamw_sumsq.launches = 0


def adamw_update(p, g, m, v, scale, lr, bc1, bc2, args: UpdateArgs):
    """Launch the update of one checked leaf in place: parameter ``p``,
    gradient ``g``, moments ``m`` and ``v`` (fp32); ``scale`` (or None:
    no clip), ``lr``, ``bc1`` and ``bc2`` 0-d fp32 tensors on the device.
    Counts the launch."""
    n = p.numel()
    if n == 0:
        return
    dev = p.device.index
    _raise_on(_lib().repro_adamw_update(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), n,
        PAIRS[p.dtype, g.dtype], None if scale is None else scale.data_ptr(),
        lr.data_ptr(), bc1.data_ptr(), bc2.data_ptr(), ctypes.byref(args),
        grid(n, 16 // min(p.element_size(), g.element_size()),
             UPDATE_BLOCKS_PER_SM, sm_count(dev)),
        torch._C._cuda_getCurrentRawStream(dev)), "adamw_update launch")
    adamw_update.launches += 1


adamw_update.launches = 0


def check_leaves(leaves) -> None:
    """Raise on what the kernels do not take: ``leaves`` are (name, p, g,
    m, v), every tensor on one CUDA device, contiguous, of p's shape; m
    and v fp32; (p, g) of a pair in ``PAIRS``."""
    dev = leaves[0][1].device
    for name, p, g, m, v in leaves:
        ts = (p, g, m, v)
        if any(t.device != dev for t in ts) or dev.type != "cuda":
            raise ValueError(f"adamw kernels: {name} on "
                             f"{[str(t.device) for t in ts]}, not all on "
                             f"one CUDA device")
        if (p.dtype, g.dtype) not in PAIRS or m.dtype != torch.float32 \
                or v.dtype != torch.float32:
            raise TypeError(f"adamw kernels: {name}: parameter {p.dtype}, "
                            f"gradient {g.dtype}, moments {m.dtype}, "
                            f"{v.dtype}; the kernels take (parameter, "
                            f"gradient) in {list(PAIRS)} and fp32 moments")
        if any(t.shape != p.shape for t in ts):
            raise ValueError(f"adamw kernels: {name}: shapes "
                             f"{[tuple(t.shape) for t in ts]} differ")
        if not all(t.is_contiguous() for t in ts):
            raise ValueError(f"adamw kernels: {name} is not contiguous "
                             f"(strides {[t.stride() for t in ts]})")


def update(grads: dict, mu: dict, nu: dict, params: dict, cfg, lr, bc1,
           bc2):
    """The kernels' update: ``update_plain``'s, in place, on CUDA leaves
    (``check_leaves`` raises on any other); the norm and its scale by
    ``adamw_sumsq`` where ``cfg.clip_norm``, each leaf by
    ``adamw_update``. Makes no temporary of a leaf's size; returns the
    global norm (0 with no clip)."""
    leaves = [(n, p, grads[n], mu[n], nu[n]) for n, p in params.items()]
    check_leaves(leaves)
    if lr.device != leaves[0][1].device:
        raise ValueError(f"adamw kernels: the schedule is on {lr.device}, "
                         f"the leaves on {leaves[0][1].device}")
    if cfg.clip_norm:
        gnorm, scale = adamw_sumsq([g for _, _, g, _, _ in leaves],
                                   cfg.clip_norm)
    else:
        gnorm, scale = torch.zeros((), device=lr.device), None
    args = update_args(cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay)
    for _, p, g, m, v in leaves:
        adamw_update(p, g, m, v, scale, lr, bc1, bc2, args)
    return gnorm

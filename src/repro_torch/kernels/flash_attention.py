"""Flash attention for Hopper (CUDA C++), both directions, beside the plain
versions.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``_flash_kernel`` / ``flash_attention``). Two kernels, chosen by dtype
(neither is a fallback for the other):

- bf16: ``repro_torch/csrc/flash_attention_sm90.cu``, both products on
  ``wgmma`` tensor cores with K/V tiles fed by TMA. TMA reads q/k/v through
  tensor maps, so each needs a 16-byte aligned base and strides of whole
  16 bytes; other input raises ``ValueError`` (``tma_problem``).
- float32: ``repro_torch/csrc/flash_attention.cu``, both products on the
  tensor cores in 3xTF32 (``mma.sync``; each fp32 operand split as
  hi + lo TF32 in registers, three TF32 products into an fp32
  accumulator, ~2^-21 relative error a product, where one TF32 product
  would keep ~3 digits), K/V tiles through a ``cp.async`` ring. Any
  strides with a contiguous last dim: 16-byte copies where every row is
  16-byte aligned (``cp_async16_ok``), else 4-byte. Its tiles come from
  :func:`fp32_plan`.

Each source holds the note on what bounds it on the card and how its design
answers that. This module binds the forward and backward kernels with
ctypes (built by ``kernels/build.py``), counts each one's launches, and
holds the plain PyTorch versions.

Unlike the Pallas wrapper, K/V may carry fewer heads than Q (GQA: query head
``h`` reads KV head ``h // (H // KV)``, the ``jnp.repeat`` /
``torch.repeat_interleave`` order), S need not divide the tile, and inputs
are read through their strides with no transposes. Every kernel, both
routes and both directions, also takes a causal sliding window: key ``k``
is seen by query ``q`` iff ``k <= q`` and ``q - k < window`` (the JAX
layers' ``_mask``; 0 = no window), so a windowed layer's key loop starts at
the window's first tile; the Pallas kernel has no window (the JAX package
computes windowed layers in XLA ops), and a window without the causal mask
raises (``check_window``).

``FlashAttentionFunction`` makes the kernels differentiable: the forward
launch also writes each row's log-sum-exp, and the backward launches the
backward kernel of q's dtype. bf16: ``csrc/flash_attention_bwd_sm90.cu``
(``flash_attention_bwd_bf16``: dK and dV per key tile, dQ per query tile,
every product on ``wgmma``, P recomputed per tile from that LSE). float32:
``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd_fp32``: dK/dV
blocks and dQ blocks in one launch, every product in 3xTF32, delta
recomputed a block, GQA partials summed by the grid's last block of a key
tile; :func:`fp32_plan` sizes it). The closed form,
``flash_attention_backward``, is both backward kernels' plain version: the
CPU takes it, a CUDA tensor never does. The Pallas kernel has no backward: the JAX package
differentiates the XLA ops of its layers.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build

NEG_INF = -1e30
ROUTES = {torch.bfloat16: "bf16", torch.float32: "fp32"}
SUPPORTED_HEAD_DIMS = (32, 64, 112, 128, 256)
TMA_ALIGN = 16          # bytes: TMA's base-address and stride granule
TMA_MAX_STRIDE = 2**40  # bytes
# the bf16 backward's tiles (csrc/flash_attention_bwd_sm90.cu): the main
# kernel's keys a block and queries a step, the dQ kernel's rows a block
# and keys a step
BWD_BLOCK_K, BWD_BLOCK_Q = 128, 64
BWD_DQ_ROWS, BWD_DQ_KEYS = 128, 64
# the float32 route's tiles (csrc/flash_attention.cu, flash_attention_bwd.cu)
FP32_ROWS = (64, 32, 16)   # block rows the plan picks from, largest first
FP32_BWD_STEP = 32         # rows of the tiles a backward block steps over
N_SM = 132                 # an H100 SXM's SMs: the plan's default


def key_mask(S: int, Sk: int, causal: bool, window: int, device=None):
    """(S, Sk) bool: whether query q (position q of 0..S-1) sees key k. The
    JAX layers' ``_mask`` over positions 0..S-1: ``k <= q`` when causal, and
    ``q - k < window`` when ``window`` (0 = none). None where every pair is
    seen."""
    if not causal and not window:
        return None
    q = torch.arange(S, device=device)[:, None]
    k = torch.arange(Sk, device=device)[None, :]
    m = torch.ones((S, Sk), dtype=torch.bool, device=device)
    if causal:
        m &= k <= q
    if window:
        m &= q - k < window
    return m


class Fp32Plan(NamedTuple):
    """How the float32 route's kernels tile a problem (:func:`fp32_plan`).

    ``rows``: a block's rows, 16, 32 or 64 (forward: its query tile;
    backward: a dK/dV block's key tile and a dQ block's query tile).
    ``step``: rows of the tiles a block steps over (forward: keys; backward:
    queries for dK/dV, keys for dQ). ``split``: warps that share 16 rows,
    each taking 1/split of hd's columns (backward; 1 in the forward).
    ``splits``: blocks a KV head's query heads are split over (backward;
    their fp32 partials summed in order by the last one). ``warps`` a
    block, ``kv_blocks`` (dK/dV, 0 in the forward) and ``q_blocks`` in the
    one grid, ``smem``: dynamic shared memory bytes a block."""
    rows: int
    step: int
    split: int
    splits: int
    warps: int
    kv_blocks: int
    q_blocks: int
    smem: int


def fp32_step(hd: int, backward: bool = False) -> int:
    """Rows of the tiles an fp32 block steps over: the forward's key tile
    is 64 at hd <= 64 and 32 above (O is hd / 2 registers a thread); the
    backward's is FP32_BWD_STEP."""
    if backward:
        return FP32_BWD_STEP
    return 64 if hd <= 64 else 32


def fp32_col_split(hd: int, rows: int) -> int:
    """Warps of the fp32 backward that share 16 rows at head dim ``hd`` with
    ``rows`` block rows: so that dK and dV (or dQ) fit a warp's registers,
    1 up to hd 64, 2 at 112 and 128, 4 at 256; and at 16-row blocks (a
    problem too small to fill the card) as many as hd's columns allow, 4
    (hd 112: 2), so that a block's few steps run on more warps."""
    if rows == 16:
        return 2 if hd == 112 else 4
    return 1 if hd <= 64 else 2 if hd <= 128 else 4


def fp32_smem_bytes(hd: int, rows: int, backward: bool = False) -> int:
    """Dynamic shared memory a block of the fp32 forward (or backward) takes
    at head dim ``hd`` with ``rows`` block rows, as ``smem_bytes`` /
    ``Tile::SMEM`` of the sources: rows padded to hd + 4 floats. Forward:
    the Q tile and a two-stage ring of K and V tiles. Backward: two tiles of
    ``rows`` (K, V or Q, dO), a two-stage ring of step tiles (Q, dO and,
    up to hd 128, O; or K, V), LSE and delta rows, and P and dS tiles
    padded to step + 8. A pure function."""
    ld = hd + 4
    step = fp32_step(hd, backward)
    if not backward:
        return 4 * ld * (rows + 4 * step)
    ring = (6 if hd <= 128 else 4) * step * ld
    return 4 * (2 * rows * ld + ring + 4 * max(rows, step)
                + 2 * rows * (step + 8))


def fp32_plan(B: int, S: int, H: int, KV: int, hd: int,
              backward: bool = False, n_sm: int = N_SM) -> Fp32Plan:
    """The float32 route's tiles for a (B, S, H over KV, hd) problem. Blocks
    take 64 rows (the backward at hd 256: 32, for shared memory). Where the
    grid would leave SMs idle, fewer than ``n_sm`` forward blocks or dK/dV
    blocks in the backward, the backward first splits a KV head's G = H /
    KV query heads over more blocks (a divisor of G, smallest first: fp32
    partials, but K and V tiles still read once a block), then halves the
    rows to 32 and then 16. Every plan fits a block's 227 KB of shared
    memory. A pure function."""
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {SUPPORTED_HEAD_DIMS}")
    if H % KV:
        raise ValueError(f"{H} heads over {KV} KV heads")

    def tiles(rows):
        return -(-S // rows)
    rows = 32 if backward and hd == 256 else FP32_ROWS[0]
    if not backward:
        while rows > FP32_ROWS[-1] and tiles(rows) * H * B < n_sm:
            rows //= 2
        return Fp32Plan(rows, fp32_step(hd), 1, 1, rows // 16, 0,
                        tiles(rows) * H * B, fp32_smem_bytes(hd, rows))
    G = H // KV
    splits = 1
    while tiles(rows) * KV * B * splits < n_sm and splits < G:
        splits = next(d for d in range(splits + 1, G + 1) if G % d == 0)
    while rows > FP32_ROWS[-1] and tiles(rows) * KV * B * splits < n_sm:
        rows //= 2
    split = fp32_col_split(hd, rows)
    return Fp32Plan(rows, FP32_BWD_STEP, split, splits, split * rows // 16,
                    tiles(rows) * KV * B * splits, tiles(rows) * H * B,
                    fp32_smem_bytes(hd, rows, True))


def cp_async16_ok(shape, strides, data_ptr: int) -> bool:
    """Whether 16-byte ``cp.async`` copies can read every row of an fp32
    (B, S, heads, hd) operand with a contiguous last dim: a 16-byte aligned
    base and (batch, seq, head) strides of whole 16 bytes (a dimension of
    size 1 is never stepped over). A pure function."""
    return data_ptr % 16 == 0 and all(
        st % 4 == 0 for n, st in zip(shape[:3], strides[:3]) if n > 1)


def _plain_scores(q, k, causal, window):
    """fp32 (B, H, S, Sk) scores q k^T * hd**-0.5, the masked ones -1e30 (the
    kernels' mask), with KV heads repeated for GQA (the ``jnp.repeat`` /
    ``torch.repeat_interleave`` order)."""
    hd = q.shape[3]
    G = q.shape[2] // k.shape[2]
    kf = k.float().repeat_interleave(G, dim=2) if G > 1 else k.float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * hd ** -0.5
    mask = key_mask(q.shape[1], k.shape[1], causal, window, q.device)
    return s if mask is None else s.masked_fill(~mask, NEG_INF)


def _plain_values(w, v, dtype):
    G = w.shape[1] // v.shape[2]
    vf = v.float().repeat_interleave(G, dim=2) if G > 1 else v.float()
    return torch.einsum("bhqk,bkhd->bqhd", w, vf).to(dtype)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) with H % KV == 0.

    Softmax attention scaled by hd**-0.5, in fp32, cast to q's dtype, over
    the keys :func:`key_mask` lets each query see (a causal sliding window
    of ``window`` keys where it is not 0); the plain version of the
    kernels, with their -1e30 mask."""
    w = torch.softmax(_plain_scores(q, k, causal, window), dim=-1)
    return _plain_values(w, v, q.dtype)


def flash_attention_plain_lse(q, k, v, *, causal: bool = True,
                              window: int = 0):
    """:func:`flash_attention_plain` and the row log-sum-exp of its scaled,
    masked scores, fp32 (B, H, S): what the kernels write for the backward,
    in its plain version."""
    s = _plain_scores(q, k, causal, window)
    lse = torch.logsumexp(s, dim=-1)
    return _plain_values(torch.exp(s - lse[..., None]), v, q.dtype), lse


def flash_attention_backward(q, k, v, dy, causal: bool = True,
                             window: int = 0):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention_plain` for the
    upstream gradient ``dy`` (B, S, H, hd). The probabilities P are
    recomputed from q and k at scale hd**-0.5 (with the -1e30 mask), then

        dV = P^T dY,  dS = P * (dY V^T - rowsum(P * dY V^T)),
        dQ = dS K * scale,  dK = dS^T Q * scale

    in fp32 per query head; dK and dV are summed over each KV head's group
    of H // KV query heads and cast back to the inputs' dtypes."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qf, kf, vf, df = q.float(), k.float(), v.float(), dy.float()
    if G > 1:
        kf = kf.repeat_interleave(G, dim=2)
        vf = vf.repeat_interleave(G, dim=2)
    p = torch.softmax(_plain_scores(q, k, causal, window), dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, df)
    dp = torch.einsum("bqhd,bkhd->bhqk", df, vf)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    del p, dp
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    if G > 1:
        dk = dk.reshape(B, S, KV, G, hd).sum(dim=3)
        dv = dv.reshape(B, S, KV, G, hd).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def kernel_window(window: int, S: int) -> int:
    """The window a kernel is given: ``window``, or 0 (none) where it is at
    least S, which under the causal mask hides no key. A negative window
    raises."""
    if window < 0:
        raise ValueError(f"window {window} < 0")
    return window if window < S else 0


def tma_strides(shape, strides) -> tuple[int, int, int]:
    """The (batch, seq, head) strides, in elements, that a tensor map is
    given for a (B, S, heads, hd) operand. A dimension of size 1 is never
    stepped over, so its stride, whatever it is, becomes hd."""
    return tuple(st if n > 1 else shape[3]
                 for n, st in zip(shape[:3], strides[:3]))


def tma_problem(shape, strides, data_ptr: int):
    """Why TMA cannot read a bf16 (B, S, heads, hd) operand with a
    contiguous last dim, these strides (in elements) and this base address,
    or None if it can."""
    if data_ptr % TMA_ALIGN:
        return f"base address {data_ptr:#x} is not {TMA_ALIGN}-byte aligned"
    for dim, st in zip("BSH", tma_strides(shape, strides)):
        nbytes = st * 2  # bytes of a bf16 element
        if nbytes % TMA_ALIGN or not 0 < nbytes < TMA_MAX_STRIDE:
            return (f"stride {st} of dim {dim} is {nbytes} bytes, not a "
                    f"positive multiple of {TMA_ALIGN} below 2**40")
    return None


def kernel_route(dtype, q_shape, q_strides, q_ptr, kv_shape, kv_layouts):
    """The route ("bf16" or "fp32") that launches for these operands;
    raises ValueError or TypeError naming why no kernel takes them.

    ``kv_layouts`` is ``((k_strides, k_ptr), (v_strides, v_ptr))``. A pure
    function of shapes, strides, addresses and dtype."""
    if dtype not in ROUTES:
        raise TypeError(f"flash_attention kernel supports one dtype of "
                        f"{list(ROUTES)}, got {dtype}")
    if len(q_shape) != 4 or len(kv_shape) != 4:
        raise ValueError(f"bad shapes q{tuple(q_shape)} k/v{tuple(kv_shape)}")
    B, S, H, hd = q_shape
    if kv_shape[0] != B or kv_shape[1] != S or kv_shape[3] != hd \
            or H % kv_shape[2]:
        raise ValueError(f"q{tuple(q_shape)} and k/v{tuple(kv_shape)} must "
                         "share B, S and hd, with H a multiple of KV")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {SUPPORTED_HEAD_DIMS}")
    layouts = [("q", q_shape, q_strides, q_ptr)] + [
        (name, kv_shape, st, ptr) for name, (st, ptr) in zip("kv", kv_layouts)]
    for name, shape, strides, _ in layouts:
        if strides[3] != 1:
            raise ValueError(f"flash_attention kernel needs a contiguous last "
                             f"dim ({name} has stride {strides[3]})")
    route = ROUTES[dtype]
    if route == "bf16":
        for name, shape, strides, ptr in layouts:
            why = tma_problem(shape, strides, ptr)
            if why:
                raise ValueError(f"bf16 flash_attention kernel cannot read "
                                 f"{name} through TMA: {why}")
    return route


# the forward entries' arguments, then the LSE pointer and the stream
_FWD_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 12
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p])
_ARGTYPES = {
    # the fp32 forward adds the plan's rows and step and the copy width
    "flash_attention": _FWD_ARGS[:-1] + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "flash_attention_sm90": _FWD_ARGS,
    "flash_attention_bwd_sm90": ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                                 + [ctypes.c_int64] * 24
                                 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]),
    "flash_attention_bwd": ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                            + [ctypes.c_int64] * 24 + [ctypes.c_float]
                            + [ctypes.c_int] * 7 + [ctypes.c_void_p])}
# each library's C entry
_ENTRIES = {"flash_attention": "repro_flash_attention_fwd",
            "flash_attention_sm90": "repro_flash_attention_sm90_fwd",
            "flash_attention_bwd_sm90": "repro_flash_attention_bwd_sm90",
            "flash_attention_bwd": "repro_flash_attention_bwd"}


@functools.cache
def _lib(name):
    lib = build.load(name)
    fn = getattr(lib, _ENTRIES[name])
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _check(lib, err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.repro_cuda_error_string(err).decode()})")


def _launch(name, q, k, v, causal, window, strides, lse, *extra):
    """Launch a forward entry; ``extra``: the arguments between the LSE
    pointer and the stream (the fp32 entry's plan numbers)."""
    B, S, H, hd = q.shape
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lib, fn = _lib(name)
    _check(lib, fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   B, S, H, k.shape[2], hd, *strides(q), *strides(k),
                   *strides(v), *out.stride()[:3], hd ** -0.5,
                   int(bool(causal)), kernel_window(window, S),
                   None if lse is None else lse.data_ptr(), *extra,
                   torch.cuda.current_stream(q.device).cuda_stream), name)
    return out


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _device_plan(q, k, backward):
    B, S, H, hd = q.shape
    return fp32_plan(B, S, H, k.shape[2], hd, backward,
                     _sm_count(q.device.index))


def _vec(*ts) -> int:
    return int(all(cp_async16_ok(t.shape, t.stride(), t.data_ptr())
                   for t in ts))


def _tma(t):
    return tma_strides(t.shape, t.stride())


def _strides(t):
    return t.stride()[:3]


def tf32_mma_rate(iters: int = 4000) -> float:
    """TFLOP/s the current card reaches with TF32 ``mma.sync.m16n8k8`` from
    registers alone (``csrc/flash_attention.cu``'s ``tf32_mma_rate``: 4
    independent sums a warp, 8 warps an SM), by CUDA events: the ceiling
    of the fp32 route's products, which 3xTF32 divides by three. Runs on
    the card only."""
    n_sm = _sm_count(torch.cuda.current_device())
    lib, _ = _lib("flash_attention")
    fn = lib.repro_tf32_mma_rate
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(2 * n_sm * 128, dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        _check(lib, fn(out.data_ptr(), 2 * n_sm, iters, stream),
               "tf32_mma_rate")
    best = float("inf")
    for _ in range(5):          # the first launches also raise the clocks
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    products = 2 * n_sm * 4 * 4 * iters        # blocks x warps x sums x iters
    return products * 2048 / (best * 1e-3) / 1e12


def flash_attention_bf16(q, k, v, *, causal: bool = True, window: int = 0,
                         lse=None):
    """The tensor-core kernel; operands already checked by ``kernel_route``.
    ``lse``: None, or a contiguous fp32 (B, H, S) the kernel fills with each
    row's log-sum-exp, for the backward."""
    out = _launch("flash_attention_sm90", q, k, v, causal, window, _tma, lse)
    flash_attention_bf16.launches += 1
    return out


def flash_attention_fp32(q, k, v, *, causal: bool = True, window: int = 0,
                         lse=None):
    """The 3xTF32 kernel, tiled by :func:`fp32_plan`; operands already
    checked by ``kernel_route``. ``lse`` as :func:`flash_attention_bf16`'s."""
    plan = _device_plan(q, k, False)
    out = _launch("flash_attention", q, k, v, causal, window, _strides, lse,
                  plan.rows, plan.step, _vec(q, k, v))
    flash_attention_fp32.launches += 1
    return out


def backward_grids(B: int, S: int, H: int, KV: int):
    """The bf16 backward's grids: the main kernel's, one block per
    (BWD_BLOCK_K-key tile, KV head's share of query heads, batch), and the
    dQ kernel's, one per (BWD_DQ_ROWS-query tile, head, batch). A pure
    function."""
    return ((-(-S // BWD_BLOCK_K), KV * backward_splits(H, KV), B),
            (-(-S // BWD_DQ_ROWS), H, B))


def backward_splits(H: int, KV: int) -> int:
    """Blocks a KV head's query heads are split over in the backward's main
    kernel: one a query head where G = H / KV > 1 (each writes fp32 dK and
    dV partials, summed per KV head by a small launch), else 1."""
    return H // KV


def backward_smem_bytes(hd: int, dq: bool = False) -> int:
    """Dynamic shared memory a block of the backward's main kernel (or,
    ``dq``, of its dQ kernel) takes, as ``Tile<HD>::SMEM`` /
    ``DqTile<HD>::SMEM`` of the source: main, K and V tiles of BWD_BLOCK_K
    rows and a ring of Q and dO tiles of BWD_BLOCK_Q rows with their LSE
    and delta rows; dQ, Q and dO tiles of BWD_DQ_ROWS rows and a ring of K
    and V tiles of BWD_DQ_KEYS rows; 1 ring stage at hd 256, else 2; the
    mbarriers and 1024 bytes of alignment. A pure function."""
    tile = 128 if hd == 112 else hd
    stages = 1 if tile == 256 else 2
    row = 128 if tile >= 64 else 64          # bytes of a swizzled row
    blocks = tile * 2 // row
    if dq:
        return (1024 + 2 * blocks * BWD_DQ_ROWS * row
                + 2 * stages * blocks * BWD_DQ_KEYS * row + 8 * (1 + 4 * stages))
    return (1024 + 2 * blocks * BWD_BLOCK_K * row
            + 2 * stages * blocks * BWD_BLOCK_Q * row
            + 2 * stages * BWD_BLOCK_Q * 4 + 8 * (1 + 2 * stages))


def backward_padded_rows(S: int) -> int:
    """S rounded up to whole BWD_BLOCK_Q tiles: the row length of the
    backward's LSE and delta scratch."""
    return -(-S // BWD_BLOCK_Q) * BWD_BLOCK_Q


def _backward_operands(q, k, v, out, lse, dy, dtype):
    """Check a backward kernel's operands (``dtype`` q, k, v, out and dy,
    an fp32 contiguous (B, H, S) lse, all on one CUDA device); return dy,
    copied where its last dim is not contiguous."""
    if not (q.is_cuda and k.device == q.device == v.device == out.device
            == lse.device == dy.device):
        raise ValueError("flash_attention backward kernel needs CUDA tensors "
                         "on one device")
    if not q.dtype == k.dtype == v.dtype == out.dtype == dy.dtype == dtype \
            or lse.dtype != torch.float32:
        raise TypeError(f"flash_attention backward kernel takes {dtype} q, k, "
                        f"v, out, dy and an fp32 lse, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}, {out.dtype}, {dy.dtype}, "
                        f"{lse.dtype}")
    B, S, H, _ = q.shape
    kernel_route(q.dtype, q.shape, q.stride(), q.data_ptr(), k.shape,
                 ((k.stride(), k.data_ptr()), (v.stride(), v.data_ptr())))
    if out.shape != q.shape or dy.shape != q.shape \
            or lse.shape != (B, H, S) or not lse.is_contiguous():
        raise ValueError(f"out{tuple(out.shape)}, dy{tuple(dy.shape)} and "
                         f"lse{tuple(lse.shape)} do not fit q{tuple(q.shape)}")
    if out.stride(3) != 1 or (dtype == torch.bfloat16 and tma_problem(
            out.shape, out.stride(), out.data_ptr())):
        raise ValueError("flash_attention backward kernel reads out in rows "
                         "with a contiguous last dim (16-byte aligned in "
                         "bf16, as TMA would)")
    if dy.stride(3) != 1 or (dtype == torch.bfloat16 and tma_problem(
            dy.shape, dy.stride(), dy.data_ptr())):
        dy = dy.contiguous()
    return dy


def flash_attention_bwd_bf16(q, k, v, out, lse, dy, *, causal: bool = True,
                             window: int = 0):
    """The bf16 backward kernel: ``(dq, dk, dv)`` of the forward that gave
    ``out`` and ``lse`` (fp32 (B, H, S)), for the upstream gradient ``dy``,
    as :func:`flash_attention_backward` computes them. q, k, v: the
    forward's operands; dy is read through its strides where TMA can (a
    contiguous copy otherwise). Raises for what the kernel does not take.
    Counts one launch."""
    dy = _backward_operands(q, k, v, out, lse, dy, torch.bfloat16)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    S_pad = backward_padded_rows(S)
    vecs = torch.empty((2, B * H * S_pad), dtype=torch.float32,
                       device=q.device)
    dq = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    splits = backward_splits(H, KV)
    part = torch.empty((2, B, S, KV * splits, hd), dtype=torch.float32,
                       device=q.device) if splits > 1 else None
    lib, fn = _lib("flash_attention_bwd_sm90")
    _check(lib, fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dy.data_ptr(), lse.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if part is None else part.data_ptr(),
        B, S, H, KV, hd, splits, *_tma(q), *_tma(k), *_tma(v), *_tma(out),
        *_tma(dy), *_tma(dq), *_tma(dk), *_tma(dv), hd ** -0.5,
        int(bool(causal)), kernel_window(window, S),
        torch.cuda.current_stream(q.device).cuda_stream),
        "flash_attention_bwd_sm90")
    flash_attention_bwd_bf16.launches += 1
    return dq, dk, dv


def flash_attention_bwd_fp32(q, k, v, out, lse, dy, *, causal: bool = True,
                             window: int = 0):
    """The float32 backward kernel (``csrc/flash_attention_bwd.cu``, 3xTF32,
    one device launch tiled by :func:`fp32_plan`): ``(dq, dk, dv)`` as
    :func:`flash_attention_bwd_bf16` gives them, from the fp32 forward's
    ``out`` and ``lse``; every operand read through its strides with a
    contiguous last dim (dy copied otherwise). Raises for what the kernel
    does not take. Counts one launch."""
    dy = _backward_operands(q, k, v, out, lse, dy, torch.float32)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    plan = _device_plan(q, k, True)
    dq = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part = counters = None
    if plan.splits > 1:
        part = torch.empty((2, plan.splits, B, S, KV, hd), dtype=torch.float32,
                           device=q.device)
        counters = _counters(q.device, stream, -(-S // plan.rows) * B * KV)
    lib, fn = _lib("flash_attention_bwd")
    _check(lib, fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dy.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(), B, S, H, KV, hd,
        *_strides(q), *_strides(k), *_strides(v), *_strides(out),
        *_strides(dy), *_strides(dq), *_strides(dk), *_strides(dv),
        hd ** -0.5, int(bool(causal)), kernel_window(window, S), plan.rows,
        plan.step, plan.split, plan.splits, _vec(q, k, v, out, dy), stream),
        "flash_attention_bwd")
    flash_attention_bwd_fp32.launches += 1
    return dq, dk, dv


# the fp32 backward's GQA counters by (device, stream): zero between
# calls (the kernel's last block of a key tile resets its own), so a call
# launches nothing but the kernel
_COUNTERS: dict = {}


def _counters(device, stream: int, n: int):
    buf = _COUNTERS.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[(device, stream)] = torch.zeros(
            max(n, 4096), dtype=torch.int32, device=device)
    return buf


flash_attention_bf16.launches = 0
flash_attention_fp32.launches = 0
flash_attention_bwd_bf16.launches = 0
flash_attention_bwd_fp32.launches = 0
KERNELS = {"bf16": flash_attention_bf16, "fp32": flash_attention_fp32}
BACKWARD_KERNELS = {"bf16": flash_attention_bwd_bf16,
                    "fp32": flash_attention_bwd_fp32}


def check_window(causal: bool, window: int) -> None:
    """K2 takes a window only under the causal mask (no config makes a
    window without it): raises ValueError for one without, or below 0."""
    if window < 0 or (window and not causal):
        raise ValueError(f"flash_attention takes a window of 0 or more, and "
                         f"only when causal (got window={window}, "
                         f"causal={causal})")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    lse=None):
    """Launch the kernel of q's dtype. q: (B, S, H, hd); k, v: (B, S, KV, hd),
    on one CUDA device; ``window``: a causal sliding window of that many
    keys (0: none). ``lse``: a contiguous fp32 (B, H, S) for the kernel to
    fill with each row's log-sum-exp, for the backward."""
    if not (q.device.type == k.device.type == v.device.type == "cuda") \
            or not (q.device == k.device == v.device):
        raise ValueError("flash_attention kernel needs CUDA tensors on one "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if k.shape != v.shape:
        raise ValueError(f"k{tuple(k.shape)} and v{tuple(v.shape)} differ")
    check_window(causal, window)
    route = kernel_route(q.dtype, q.shape, q.stride(), q.data_ptr(), k.shape,
                         ((k.stride(), k.data_ptr()),
                          (v.stride(), v.data_ptr())))
    if lse is not None:
        B, S, H, _ = q.shape
        if lse.dtype != torch.float32 or lse.shape != (B, H, S) \
                or not lse.is_contiguous() or lse.device != q.device:
            raise ValueError(f"the log-sum-exp goes into a contiguous fp32 "
                             f"({B}, {H}, {S}) on q's device")
    return KERNELS[route](q, k, v, causal=causal, window=window, lse=lse)


def new_lse(q):
    """The (B, H, S) fp32 tensor a forward kernel writes its LSE into."""
    B, S, H, _ = q.shape
    return torch.empty((B, H, S), dtype=torch.float32, device=q.device)


class FlashAttentionFunction(torch.autograd.Function):
    """The kernel of q's dtype under autograd, each direction launched and
    counted: the forward also writes the LSE, and the backward is the
    backward kernel of the same dtype (:func:`flash_attention_bwd_bf16` or
    :func:`flash_attention_bwd_fp32`) on the saved q, k, v, output and
    LSE."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.causal, ctx.window = causal, window
        lse = new_lse(q)
        out = flash_attention(q, k, v, causal=causal, window=window, lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        kernel = BACKWARD_KERNELS[ROUTES[saved[0].dtype]]
        return (*kernel(*saved, dy, causal=ctx.causal, window=ctx.window),
                None, None)

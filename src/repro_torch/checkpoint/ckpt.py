"""Msgpack tensor checkpointing (atomic writes), in the JAX package's
file format.

A checkpoint is ``ckpt_{step:08d}.msgpack``: a map ``{"step": step,
"tensors": {path: {b"dtype", b"shape", b"data"}}}`` whose paths join the
tree's dict keys (sorted) and ``#i`` list indices with ``/``, each leaf
packed with its numpy dtype string, shape and raw little-endian bytes.
The port writes the bytes the JAX package writes for the same tree, so a
file crosses between the packages. A bf16 leaf is written as that package
writes it, with the dtype string ``'<V2'`` (ml_dtypes' bfloat16 has no
numpy type code); neither package can restore such a leaf: numpy has no
cast from ``'<V2'`` (the JAX package's ``restore_checkpoint`` raises
``ValueError: No cast function available``), and this one raises a
``ValueError`` naming the leaf.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from . import _msgpack

BF16_DTYPE_STR = "<V2"     # what ml_dtypes' bfloat16 reports as dtype.str


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _pack_array(a):
    """A leaf (tensor, numpy array or number) as the file's map."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return {b"dtype": BF16_DTYPE_STR, b"shape": list(a.shape),
                    b"data": a.contiguous().view(torch.int16).numpy()
                    .tobytes()}
        a = a.numpy()
    a = np.asarray(a)
    return {b"dtype": a.dtype.str, b"shape": list(a.shape),
            b"data": a.tobytes()}


def _unpack_array(key, d):
    if d[b"dtype"] == BF16_DTYPE_STR:
        raise ValueError(
            f"checkpoint leaf `{key}` is bf16, written with dtype "
            f"'{BF16_DTYPE_STR}' as the JAX package writes it; numpy has "
            f"no cast from it, and the JAX package's restore fails on it "
            f"too")
    return np.frombuffer(d[b"data"], dtype=np.dtype(d[b"dtype"])) \
        .reshape(d[b"shape"])


def save_checkpoint(path: str, step: int, tree) -> str:
    os.makedirs(path, exist_ok=True)
    flat = {k: _pack_array(v) for k, v in _flatten(tree).items()}
    payload = _msgpack.packb({"step": step, "tensors": flat})
    fname = os.path.join(path, f"ckpt_{step:08d}.msgpack")
    fd, tmp = tempfile.mkstemp(dir=path)
    with os.fdopen(fd, "wb") as f:
        f.write(payload)
    os.replace(tmp, fname)
    return fname


def latest_step(path: str):
    if not os.path.isdir(path):
        return None
    steps = [int(f[5:13]) for f in os.listdir(path)
             if f.startswith("ckpt_") and f.endswith(".msgpack")]
    return max(steps) if steps else None


def restore_checkpoint(path: str, step: int, like_tree):
    """``(step, tree)``: the tree of ``like_tree``'s structure with each
    leaf restored from the file; a tensor leaf of ``like_tree`` gives a
    tensor of its dtype on its device, a numpy leaf an array of its dtype,
    any other leaf the stored array."""
    fname = os.path.join(path, f"ckpt_{step:08d}.msgpack")
    with open(fname, "rb") as f:
        payload = _msgpack.unpackb(f.read())
    tensors = {k: _unpack_array(k, v) for k, v in payload["tensors"].items()}

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k], f"{prefix}{k}/") for k in tree}
        if isinstance(tree, (tuple, list)):
            vals = [rebuild(v, f"{prefix}#{i}/") for i, v in enumerate(tree)]
            return type(tree)(vals)
        arr = tensors[prefix[:-1]]
        if isinstance(tree, torch.Tensor):
            return torch.from_numpy(arr.copy()).to(dtype=tree.dtype,
                                                   device=tree.device)
        return arr.astype(tree.dtype) if hasattr(tree, "dtype") else arr

    return payload["step"], rebuild(like_tree)

"""Checkpointing: parameter / optimizer-state trees in one file.

Counterpart of ``repro/training/checkpoint.py``, which packs leaves as
(dtype, shape, raw bytes) with msgpack.  The port keeps the same idea in
a format of its own (the card's machine has no msgpack): a magic line,
an 8-byte little-endian header length, a JSON header ``{"step": int,
"leaves": {path: {"dtype", "shape", "offset", "nbytes"}}}`` and then the
leaves' raw bytes, each at its offset.  Paths are
:func:`repro_torch.tree.tree_flatten`'s, the JAX
checkpoints' naming.  bf16 leaves are stored as their raw 16-bit
patterns, so every leaf round-trips bit for bit.
"""
from __future__ import annotations

import json
import pathlib
import struct

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_map

MAGIC = b"REPRO_TORCH_CKPT 1\n"


def _raw(t: torch.Tensor) -> tuple:
    """(dtype name, bytes) of a tensor, bf16 as its bit patterns."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return "bfloat16", t.view(torch.int16).numpy().tobytes()
    arr = t.numpy()
    return arr.dtype.str, arr.tobytes()


def save_checkpoint(path, tree, step: int = 0) -> None:
    """Write the tree to ``path`` (atomically: a temporary file, then a
    rename)."""
    header, blobs, offset = {}, [], 0
    for key, leaf in tree_flatten(tree).items():
        dtype, data = _raw(leaf)
        header[key] = {"dtype": dtype, "shape": list(leaf.shape),
                       "offset": offset, "nbytes": len(data)}
        blobs.append(data)
        offset += len(data)
    head = json.dumps({"step": int(step), "leaves": header}).encode()
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in blobs:
            f.write(data)
    tmp.replace(p)


def restore_checkpoint(path, like_tree):
    """Restore into the structure of ``like_tree``, each leaf on its
    counterpart's device; returns (tree, step)."""
    raw = pathlib.Path(path).read_bytes()
    if not raw.startswith(MAGIC):
        raise ValueError(f"{path} is not a checkpoint of this format")
    n = struct.unpack("<Q", raw[len(MAGIC):len(MAGIC) + 8])[0]
    start = len(MAGIC) + 8
    payload = json.loads(raw[start:start + n])
    data = memoryview(raw)[start + n:]
    stored = payload["leaves"]
    flat = tree_flatten(like_tree)
    out = {}
    for key, like in flat.items():
        rec = stored[key]
        buf = data[rec["offset"]:rec["offset"] + rec["nbytes"]]
        if rec["dtype"] == "bfloat16":
            t = torch.from_numpy(np.frombuffer(buf, np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.frombuffer(buf, np.dtype(rec["dtype"]))
                                 .copy())
        t = t.reshape(rec["shape"])
        assert tuple(t.shape) == tuple(like.shape), (key, t.shape,
                                                     like.shape)
        out[key] = t.to(like.device)
    it = iter(out.values())
    return tree_map(lambda _: next(it), like_tree), payload["step"]

"""StateRec serialization — persistence principle P3 made literal.

A checkpoint "StateRec" mirrors the paper's record layout:

    [ st (the payload pytree) | ReturnVal[0..n-1] | Deactivate[0..n-1] ]

``pack`` flattens the payload pytree into ONE contiguous byte buffer
(header + leaf data back-to-back), so the combiner persists a slot with a
single sequential write + one fsync — the paper's "place data to be
persisted in consecutive memory addresses so they are persisted all
together".  Responses and deactivate bits ride in the same buffer.

The byte format (``PSCR1``) is the reference package's, so a record
written by either package reads back in the other.  The pytree
flattener here stands in for ``jax.tree_util`` and visits leaves in
the same order: dict keys sorted, lists and tuples in order, ``None``
contributing no leaf.  Leaves are numpy arrays, torch tensors or
scalars; bf16 leaves are stored as their raw 16-bit words under the
dtype string ``"bfloat16"``, as the reference writes them.
"""

from __future__ import annotations

import io
import json
import struct
from typing import Any, Iterator, List, Sequence, Tuple

import numpy as np
import torch

_MAGIC = b"PSCR1\n"


def tree_leaves(tree) -> List[Any]:
    """Leaves of a pytree in ``jax.tree_util`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_unflatten(template, leaves: Iterator[Any]):
    """Rebuild ``template``'s structure with leaves taken in order."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: tree_unflatten(template[k], leaves)
                for k in sorted(template)}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*[tree_unflatten(x, leaves) for x in template])
    if isinstance(template, (list, tuple)):
        return type(template)(tree_unflatten(x, leaves) for x in template)
    return next(leaves)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array, dtype string); bf16 tensors become their uint16 words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _restore(tmpl, arr: np.ndarray):
    """Cast a decoded leaf to its template's type, dtype and shape."""
    if isinstance(tmpl, torch.Tensor):
        if tmpl.dtype == torch.bfloat16:
            words = np.ascontiguousarray(arr).view(np.int16).copy()
            return torch.from_numpy(words).view(torch.bfloat16) \
                .reshape(tmpl.shape)
        return torch.from_numpy(arr.copy()).to(tmpl.dtype).reshape(tmpl.shape)
    tmpl_np = np.asarray(tmpl)
    if tmpl_np.dtype != arr.dtype:       # bf16 round-trip via uint16
        arr = arr.view(tmpl_np.dtype) if arr.itemsize == tmpl_np.itemsize \
            else arr.astype(tmpl_np.dtype)
    return arr.reshape(tmpl_np.shape)


def pack(payload, return_val: Sequence[Any], deactivate: Sequence[int]) -> bytes:
    """Serialize (payload pytree, ReturnVal, Deactivate) contiguously."""
    arrs = [_to_numpy(leaf) for leaf in tree_leaves(payload)]
    meta = {
        "treedef": f"PyTree(<{len(arrs)} leaves>)",
        "leaves": [{"shape": a.shape, "dtype": dt} for a, dt in arrs],
        "return_val": list(return_val),
        "deactivate": list(int(d) for d in deactivate),
    }
    mbytes = json.dumps(meta).encode()
    out = io.BytesIO()
    out.write(_MAGIC)
    out.write(struct.pack("<Q", len(mbytes)))
    out.write(mbytes)
    for a, _ in arrs:
        out.write(np.ascontiguousarray(a).tobytes())
    return out.getvalue()


def unpack(data: bytes, payload_template) -> Tuple[Any, List[Any], List[int]]:
    """Deserialize against a template pytree (for structure + dtypes)."""
    assert data[:len(_MAGIC)] == _MAGIC, "corrupt or torn StateRec"
    off = len(_MAGIC)
    (mlen,) = struct.unpack_from("<Q", data, off)
    off += 8
    meta = json.loads(data[off:off + mlen].decode())
    off += mlen
    leaves = tree_leaves(payload_template)
    arrs = []
    for spec in meta["leaves"]:
        dt = np.dtype(spec["dtype"]) if spec["dtype"] != "bfloat16" \
            else np.dtype("uint16")
        n = int(np.prod(spec["shape"])) if spec["shape"] else 1
        raw = np.frombuffer(data, dtype=dt, count=n, offset=off)
        off += n * dt.itemsize
        arrs.append(raw.reshape(spec["shape"]))
    if len(arrs) != len(leaves):
        raise ValueError("template/record leaf mismatch")
    restored = [_restore(t, a) for t, a in zip(leaves, arrs)]
    payload = tree_unflatten(payload_template, iter(restored))
    return payload, meta["return_val"], meta["deactivate"]


def payload_nbytes(payload) -> int:
    return sum(_to_numpy(leaf)[0].nbytes for leaf in tree_leaves(payload))

"""The ESRLANE1 lane-state wire format (a byte-compatible copy of
``esr_tpu/serving/replica.py:pack_lane_state``, ``read_wire`` and
``unpack_lane_state``).

One stream's recurrent state (``inference.engine.extract_lane_state``: a
tuple of numpy arrays, forward and backward ConvGRU states) to bytes and
back, bit-exactly: the ``ESRLANE1`` magic, a little-endian u64 header
length, a JSON header (``schema``, each leaf's key path as
``jax.tree_util.keystr`` writes it for the reference's state tree, and a
sha256 over each leaf's key, shape, dtype and bytes), then an uncompressed
``.npz`` body. A packet from either package unpacks in the other; a torn
or altered packet raises ``ValueError``.

The port keeps every lane state a flat tuple, in the reference's
``tree_leaves`` order; only the keys follow the reference's tree
(:func:`lane_state_keys`): ``[0]``, ``[1]`` for the flagship's pair of
ConvGRU states, ``[i][0]``, ``[i][1]`` for a UNet ConvLSTM encoder's
``(h, c)`` pair.

A bf16 lane state (the bf16 rung) travels as its raw 16-bit words: numpy
has no bfloat16, and neither has the card's machine a package that adds
it. Its leaves are :data:`BF16_WORDS` arrays; the header names their
dtype in ``dtypes`` (``"bfloat16"``), and the digest hashes the name ``bfloat16``, as the reference's recipe does for an
``ml_dtypes`` array. A packet of f32 leaves has no ``dtypes`` and stays
byte-identical to the reference's. The reference writes a bf16 leaf as
numpy's raw ``|V2`` and then fails its own digest check on reading it; the
port reads such a leaf as bf16 words, so it takes the reference's bf16
packets.
"""

from __future__ import annotations

import hashlib
import io
import json
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["BF16_WORDS", "WIRE_MAGIC", "lane_state_keys", "pack_lane_state", "read_wire",
           "unpack_lane_state"]

WIRE_MAGIC = b"ESRLANE1"
_LEN = struct.Struct("<Q")
_BF16 = "bfloat16"
#: a bf16 array on the host: its raw 16-bit words, the dtype named in the
#: metadata (numpy has no bfloat16)
BF16_WORDS = np.dtype(np.uint16, metadata={"dtype": _BF16})


def _dtype_name(arr: np.ndarray) -> str:
    meta = arr.dtype.metadata or {}
    return _BF16 if meta.get("dtype") == _BF16 else str(arr.dtype)


def _keys(n: int) -> List[str]:
    return [f"[{i}]" for i in range(n)]


def lane_state_keys(model, n: int) -> List[str]:
    """The wire keys of ``model``'s ``n``-leaf lane state: the model's own
    ``lane_state_keys()`` where it has one (the UNet family), else the
    flat tuple's ``[i]`` (the flagship's)."""
    keys = model.lane_state_keys() if hasattr(model, "lane_state_keys") else _keys(n)
    if len(keys) != n:
        raise ValueError(f"the model names {len(keys)} lane-state leaves, the state has {n}")
    return keys


def _wire_digest(keys: Sequence[str], arrays: Sequence[np.ndarray]) -> str:
    h = hashlib.sha256()
    for key, arr in zip(keys, arrays):
        arr = np.ascontiguousarray(arr)
        h.update(str(key).encode())
        h.update(str(arr.shape).encode())
        h.update(_dtype_name(arr).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def pack_lane_state(state: Sequence[np.ndarray], keys: Optional[Sequence[str]] = None) -> bytes:
    """A lane state tuple -> bytes under ``keys`` (:func:`lane_state_keys`;
    the flat ``[i]`` when None); equal states give equal bytes."""
    arrays = [np.asarray(a) for a in state]
    keys = _keys(len(arrays)) if keys is None else list(keys)
    if len(keys) != len(arrays):
        raise ValueError(f"{len(keys)} keys for {len(arrays)} lane-state leaves")
    buf = io.BytesIO()
    # bf16 words are stored as plain uint16; the header names them
    np.savez(buf, **{f"a{i}": a.view(np.uint16) if _dtype_name(a) == _BF16 else a
                     for i, a in enumerate(arrays)})
    head = {"schema": 1, "keys": keys, "digest": _wire_digest(keys, arrays)}
    names = [_dtype_name(a) for a in arrays]
    if _BF16 in names:
        head["dtypes"] = names
    header = json.dumps(head, sort_keys=True).encode()
    return WIRE_MAGIC + _LEN.pack(len(header)) + header + buf.getvalue()


def read_wire(data: bytes) -> Tuple[Dict, List[np.ndarray]]:
    """``(header, arrays in key order)`` of a packet; raises ``ValueError``
    on a bad magic, a torn packet or a digest mismatch."""
    if data[: len(WIRE_MAGIC)] != WIRE_MAGIC:
        raise ValueError(f"not a lane-state packet (magic {data[:8]!r}, "
                         f"want {WIRE_MAGIC!r})")
    off = len(WIRE_MAGIC)
    try:
        (hlen,) = _LEN.unpack_from(data, off)
        off += _LEN.size
        header = json.loads(data[off: off + hlen].decode())
        with np.load(io.BytesIO(data[off + hlen:]), allow_pickle=False) as z:
            arrays = [z[f"a{i}"] for i in range(len(header["keys"]))]
        names = header.get("dtypes") or [None] * len(arrays)
        # bf16 leaves: named in the header, or the reference's raw |V2
        arrays = [a.view(BF16_WORDS) if n == _BF16 or a.dtype == np.dtype("V2") else a
                  for a, n in zip(arrays, names)]
    except ValueError:
        raise
    except Exception as e:  # noqa: BLE001 - a torn packet is a ValueError
        raise ValueError(f"torn lane-state packet: {e!r}") from e
    got = _wire_digest(header["keys"], arrays)
    if got != header["digest"]:
        raise ValueError(f"lane-state digest mismatch (packet {header['digest'][:12]}, "
                         f"recomputed {got[:12]}): refusing to inject corrupted state")
    return header, arrays


def unpack_lane_state(data: bytes, template: Sequence,
                      keys: Optional[Sequence[str]] = None) -> Tuple[np.ndarray, ...]:
    """Bytes -> a flat lane state tuple shaped like ``template`` (only its
    number of leaves is read) whose packet carries ``keys`` (the flat
    ``[i]`` when None); a packet of another state structure raises."""
    header, arrays = read_wire(data)
    want = _keys(len(template)) if keys is None else list(keys)
    if header["keys"] != want:
        raise ValueError(f"lane-state packet keys {header['keys']} do not match "
                         f"the model state structure {want}")
    return tuple(arrays)

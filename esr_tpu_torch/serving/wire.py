"""The ESRLANE1 lane-state wire format (a byte-compatible copy of
``esr_tpu/serving/replica.py:pack_lane_state``, ``read_wire`` and
``unpack_lane_state``).

One stream's recurrent state (``inference.engine.extract_lane_state``: a
tuple of numpy arrays, forward and backward ConvGRU states) to bytes and
back, bit-exactly: the ``ESRLANE1`` magic, a little-endian u64 header
length, a JSON header (``schema``, the leaves' key paths ``[0]``, ``[1]``
as ``jax.tree_util.keystr`` writes them for a tuple, and a sha256 over each
leaf's key, shape, dtype and bytes), then an uncompressed ``.npz`` body. A
packet from either package unpacks in the other; a torn or altered packet
raises ``ValueError``.
"""

from __future__ import annotations

import hashlib
import io
import json
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["WIRE_MAGIC", "pack_lane_state", "read_wire", "unpack_lane_state"]

WIRE_MAGIC = b"ESRLANE1"
_LEN = struct.Struct("<Q")


def _keys(n: int) -> List[str]:
    return [f"[{i}]" for i in range(n)]


def _wire_digest(keys: Sequence[str], arrays: Sequence[np.ndarray]) -> str:
    h = hashlib.sha256()
    for key, arr in zip(keys, arrays):
        arr = np.ascontiguousarray(arr)
        h.update(str(key).encode())
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def pack_lane_state(state: Sequence[np.ndarray]) -> bytes:
    """A lane state tuple -> bytes; equal states give equal bytes."""
    arrays = [np.asarray(a) for a in state]
    keys = _keys(len(arrays))
    buf = io.BytesIO()
    np.savez(buf, **{f"a{i}": a for i, a in enumerate(arrays)})
    header = json.dumps({"schema": 1, "keys": keys,
                         "digest": _wire_digest(keys, arrays)},
                        sort_keys=True).encode()
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
    except ValueError:
        raise
    except Exception as e:  # noqa: BLE001 - a torn packet is a ValueError
        raise ValueError(f"torn lane-state packet: {e!r}") from e
    got = _wire_digest(header["keys"], arrays)
    if got != header["digest"]:
        raise ValueError(f"lane-state digest mismatch (packet {header['digest'][:12]}, "
                         f"recomputed {got[:12]}): refusing to inject corrupted state")
    return header, arrays


def unpack_lane_state(data: bytes, template: Sequence) -> Tuple[np.ndarray, ...]:
    """Bytes -> a lane state tuple shaped like ``template`` (only its
    number of leaves is read); a packet of another state structure raises."""
    header, arrays = read_wire(data)
    want = _keys(len(template))
    if header["keys"] != want:
        raise ValueError(f"lane-state packet keys {header['keys']} do not match "
                         f"the model state structure {want}")
    return tuple(arrays)

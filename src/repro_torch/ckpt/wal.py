"""Mutation write-ahead log for MutableIVF (PyTorch port of
`repro/ckpt/wal.py`, byte for byte the same log; DESIGN.md §3.11).

Snapshots alone make durability O(index) per mutation batch — unusable at
serving cadence. The WAL closes the gap: every mutation (``add`` /
``remove`` / ``harden_soft_deletes`` / ``compact``) appends one
CRC-framed record BEFORE it is applied, so

    recovery = load latest valid snapshot + replay records with
               seq > snapshot.wal_seq

reproduces the live index **bitwise** (every mutation path is
deterministic given the same starting state: fused assignment against
the frozen codebook, stable counting sorts, stable compaction argsort —
the same property the mutate-≡-rebuild contract of §3.7 already pins).

Record framing (little-endian)::

    [u32 magic "WAL1"] [u32 seq] [u32 type] [u32 payload_len]
    [u32 payload_crc]  [u32 header_crc]     [payload ...]

- ``header_crc`` covers the first 20 header bytes, so a flipped bit in a
  length field cannot send the reader off the rails;
- a **torn final record** (crash mid-append: the remaining bytes are a
  strict prefix of the record) is tolerated and dropped — the mutation
  never committed, the state before it is the recovery point. The opener
  truncates the torn bytes so subsequent appends re-use the tail;
- an invalid record that IS fully present (bad magic / failed CRC with
  enough bytes on disk) is corruption, not tearing → raises
  ``CorruptSnapshotError``: committed mutations must never be silently
  skipped.

``fsync`` policy: ``"always"`` fsyncs after every record (a record
returned to the caller survives power loss), ``"never"`` leaves flushing
to the OS (crash-consistent — a prefix of records survives — but the
tail may be lost; the right trade for bulk loads). Appends thread
through ckpt/faults.py (stream ``"wal:append"``, point ``"wal:record"``)
for the crash matrix.

Payloads carry JSON meta + raw numpy arrays in an inline framed form
(dtype/shape header per array) — no pickle anywhere in the recovery
path.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Iterator, Optional, Tuple

import numpy as np

from repro_torch.ckpt import faults
from repro_torch.ckpt.index_store import CorruptSnapshotError

_MAGIC = 0x314C4157                    # b"WAL1" little-endian
_HDR = struct.Struct("<IIIII")         # magic, seq, type, plen, pcrc
_HCRC = struct.Struct("<I")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

# record types — applied by repro_torch.core.mutable.MutableIVF.replay_record
REC_ADD = 1
REC_REMOVE = 2
REC_HARDEN = 3
REC_COMPACT = 4


def _crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def encode_payload(meta: Optional[dict], arrays: Optional[dict]) -> bytes:
    mj = json.dumps(meta or {}).encode()
    parts = [_U32.pack(len(mj)), mj,
             _U32.pack(len(arrays) if arrays else 0)]
    for name, arr in (arrays or {}).items():
        a = np.ascontiguousarray(np.asarray(arr))
        hdr = json.dumps({"name": name, "dtype": str(a.dtype),
                          "shape": list(a.shape)}).encode()
        parts += [_U32.pack(len(hdr)), hdr, _U64.pack(a.nbytes),
                  a.tobytes()]
    return b"".join(parts)


def decode_payload(buf: bytes) -> Tuple[dict, dict]:
    try:
        off = _U32.size
        (mlen,) = _U32.unpack_from(buf, 0)
        meta = json.loads(buf[off:off + mlen].decode())
        off += mlen
        (n,) = _U32.unpack_from(buf, off)
        off += _U32.size
        arrays = {}
        for _ in range(n):
            (hlen,) = _U32.unpack_from(buf, off)
            off += _U32.size
            hdr = json.loads(buf[off:off + hlen].decode())
            off += hlen
            (nbytes,) = _U64.unpack_from(buf, off)
            off += _U64.size
            dt = np.dtype(hdr["dtype"])
            arrays[hdr["name"]] = np.frombuffer(
                buf, dtype=dt, count=nbytes // dt.itemsize,
                offset=off).reshape(hdr["shape"]).copy()
            off += nbytes
        return meta, arrays
    except (struct.error, json.JSONDecodeError, UnicodeDecodeError,
            ValueError, KeyError) as e:
        # CRC passed but the payload doesn't parse — still corruption
        raise CorruptSnapshotError(f"undecodable WAL payload: {e}") from e


def scan(path: str):
    """Walk the log: yields (seq, rtype, payload_bytes, end_offset) for
    every valid record; returns at a torn tail (recording where the valid
    prefix ends); raises CorruptSnapshotError on a fully-present invalid
    record (mid-file corruption). Use via `read_records` / `MutationWAL`.
    """
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        off = 0
        while off < size:
            remaining = size - off
            full_hdr = _HDR.size + _HCRC.size
            if remaining < full_hdr:
                return off             # torn header → drop
            hdr = f.read(_HDR.size)
            (hcrc,) = _HCRC.unpack(f.read(_HCRC.size))
            magic, seq, rtype, plen, pcrc = _HDR.unpack(hdr)
            if _crc(hdr) != hcrc or magic != _MAGIC:
                # the full header is on disk yet invalid: appends write
                # strict prefixes, so this cannot be a torn write
                raise CorruptSnapshotError(
                    f"corrupt WAL record header at byte {off} of {path}")
            if remaining < full_hdr + plen:
                return off             # torn payload → drop the record
            payload = f.read(plen)
            if _crc(payload) != pcrc:
                raise CorruptSnapshotError(
                    f"corrupt WAL payload (seq {seq}) at byte {off} of "
                    f"{path}")
            off += full_hdr + plen
            yield seq, rtype, payload, off
    return off


def read_records(path: str) -> Iterator[Tuple[int, int, dict, dict]]:
    """Yield (seq, rtype, meta, arrays) for every committed record,
    dropping a torn tail, raising CorruptSnapshotError on corruption."""
    for seq, rtype, payload, _ in scan(path):
        meta, arrays = decode_payload(payload)
        yield seq, rtype, meta, arrays


class MutationWAL:
    """Append-side handle. Opening scans the existing log (validating
    every record), TRUNCATES a torn tail, and positions the next append
    after the last committed record with a monotonically increasing
    sequence number. `start_seq` floors the sequence — pass the
    snapshot's wal_seq when the log was rotated at save time, so sequence
    numbers never move backwards across a rotation."""

    def __init__(self, path: str, fsync: str = "always",
                 start_seq: int = 0):
        if fsync not in ("always", "never"):
            raise ValueError(f"fsync policy {fsync!r} not in "
                             f"('always', 'never')")
        self.path = path
        self.fsync = fsync
        last_seq = int(start_seq)
        valid_end = 0
        if os.path.exists(path):
            for seq, _, _, end in scan(path):
                last_seq = max(last_seq, seq)
                valid_end = end
            if os.path.getsize(path) > valid_end:
                with open(path, "r+b") as f:
                    f.truncate(valid_end)    # drop the torn tail
        self._seq = last_seq
        self._f = open(path, "ab")
        d = os.path.dirname(os.path.abspath(path)) or "."
        fd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(fd)               # the log file itself is durable
        finally:
            os.close(fd)

    @property
    def last_seq(self) -> int:
        return self._seq

    def append(self, rtype: int, meta: Optional[dict] = None,
               arrays: Optional[dict] = None) -> int:
        """Frame + append one record; returns its sequence number. The
        record is on disk (fsync="always": durably) before this returns —
        the write-ahead contract callers rely on."""
        seq = self._seq + 1
        payload = encode_payload(meta, arrays)
        hdr = _HDR.pack(_MAGIC, seq, rtype, len(payload), _crc(payload))
        rec = hdr + _HCRC.pack(_crc(hdr)) + payload
        faults.write(self._f, rec, stream="wal:append")
        self._f.flush()
        if self.fsync == "always":
            os.fsync(self._f.fileno())
        faults.crash_point("wal:record")
        self._seq = seq
        return seq

    def rotate(self, upto_seq: int):
        """Drop the log body after a successful snapshot covering
        `upto_seq` (all records are ≤ upto_seq by the append protocol).
        Sequence numbers continue from the snapshot's wal_seq, so a crash
        between snapshot commit and rotation is benign — replay skips
        records ≤ wal_seq either way."""
        if upto_seq < self._seq:
            raise ValueError(f"cannot rotate to seq {upto_seq}: records "
                             f"up to {self._seq} are in the log")
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.truncate(0)
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self):
        if self._f is not None:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

"""Uplink frame codec: what an edge sequencer actually sends home
(``repro/field/uplink.py``; the wire image is JAX's byte for byte).

A field deployment (see :mod:`repro_torch.field`) pushes accepted Read-Until
reads from N edge devices to one aggregator over mobile links — the
bandwidth economy the paper's edge tier exists for.  Raw nanopore signal
is ~4 float32 samples per base (16 B/base); the uplink ships the *called*
read instead:

  * bases pack 2 bits each (:func:`pack_bases` — 0.25 B/base, a 64x
    density win over the raw signal they decode from);
  * optional signal snippets (for aggregator-side QC / requant) ride the
    shared :mod:`repro_torch.distributed.compression` int8 / top-k codecs
    — the same symmetric scheme as gradient compression and the edge
    basecaller's MAC path, per the one-quantizer rule;
  * telemetry frames carry ``Telemetry.to_dict()`` JSON so per-device
    accounting merges losslessly into the fleet rollup.

Every frame carries ``(device_id, seq, read_id)`` where ``seq`` is the
device's monotone frame sequence number: the aggregator uses it to detect
duplicates and reordering, so a lossy channel degrades into *counted*
anomalies, never corrupted state.  ``to_bytes``/``from_bytes`` give the
exact wire image; ``wire_bytes`` is what the bytes-on-wire benchmark sums.
"""
from __future__ import annotations

import dataclasses
import json
import struct
import zlib

import numpy as np
import torch

MAGIC = 0xF1E1
VERSION = 1

KIND_READ = 0
KIND_TELEMETRY = 1

#: raw signal cost the uplink avoids: float32 samples
RAW_SAMPLE_BYTES = 4

# frame header: magic, version, kind, device_id, seq, read_id, payload len
_HEADER = struct.Struct("<HBBHIiI")
# read payload header: mapped_pos, samples_at_decision, samples_sequenced,
# total_samples, n_bases, n_signal, signal_scale
_READ_HEAD = struct.Struct("<iIIIHHf")


def raw_signal_bytes(n_samples: int) -> int:
    """Bytes the same information costs as raw float32 signal."""
    return int(n_samples) * RAW_SAMPLE_BYTES


# ------------------------------------------------------------ base packing --
def pack_bases(tokens: np.ndarray) -> bytes:
    """(L,) base tokens 1..4 -> ceil(L/4) bytes, 2 bits per base."""
    t = np.asarray(tokens, np.uint8) - 1
    if t.size == 0:
        return b""
    pad = (-len(t)) % 4
    if pad:
        t = np.concatenate([t, np.zeros(pad, np.uint8)])
    t = t.reshape(-1, 4)
    packed = t[:, 0] | (t[:, 1] << 2) | (t[:, 2] << 4) | (t[:, 3] << 6)
    return packed.astype(np.uint8).tobytes()


def unpack_bases(buf: bytes, n_bases: int) -> np.ndarray:
    """Inverse of :func:`pack_bases` -> (n_bases,) int32 tokens 1..4."""
    if n_bases == 0:
        return np.zeros(0, np.int32)
    b = np.frombuffer(buf, np.uint8)
    out = np.empty((len(b), 4), np.uint8)
    out[:, 0] = b & 3
    out[:, 1] = (b >> 2) & 3
    out[:, 2] = (b >> 4) & 3
    out[:, 3] = (b >> 6) & 3
    return (out.reshape(-1)[:n_bases].astype(np.int32) + 1)


# ------------------------------------------------------- signal snippets ----
def encode_signal_int8(signal: np.ndarray) -> tuple[bytes, float]:
    """Symmetric int8 signal snippet via the shared codec (4x vs float32)."""
    from repro_torch.distributed import compression
    q, scale = compression.compress_int8(
        torch.from_numpy(np.array(signal, np.float32)))
    return q.cpu().numpy().astype(np.int8).tobytes(), float(scale)


def decode_signal_int8(buf: bytes, scale: float) -> np.ndarray:
    from repro_torch.distributed import compression
    q = torch.from_numpy(np.frombuffer(buf, np.int8).copy())
    return compression.decompress_int8(
        q, torch.tensor(scale, dtype=torch.float32)).numpy()


def encode_signal_topk(signal: np.ndarray,
                       frac: float) -> tuple[np.ndarray, np.ndarray, int]:
    """Magnitude top-k snippet (values, indices, n) via the shared codec —
    the sparse alternative for event-dense squiggle excerpts."""
    from repro_torch.distributed import compression
    vals, idx, n = compression.compress_topk(
        torch.from_numpy(np.array(signal, np.float32)), frac)
    return (vals.cpu().numpy().astype(np.float32),
            idx.cpu().numpy().astype(np.int32), int(n))


def decode_signal_topk(vals, idx, n: int) -> np.ndarray:
    from repro_torch.distributed import compression
    return compression.decompress_topk(
        torch.from_numpy(np.array(vals, np.float32)),
        torch.from_numpy(np.array(idx, np.int32)), n, (n,)).numpy()


# ------------------------------------------------------------------ frames --
@dataclasses.dataclass(frozen=True)
class UplinkFrame:
    """One device->aggregator datagram.

    ``seq`` is per-device and strictly monotone at the sender; ``read_id``
    is the device's arrival-ranked molecule id (-1 for telemetry frames).
    ``payload`` is opaque at this layer — :func:`decode_read` /
    :func:`decode_telemetry` interpret it per ``kind``.
    """
    device_id: int
    seq: int
    kind: int
    read_id: int
    payload: bytes

    @property
    def wire_bytes(self) -> int:
        return _HEADER.size + len(self.payload)

    def to_bytes(self) -> bytes:
        return _HEADER.pack(MAGIC, VERSION, self.kind, self.device_id,
                            self.seq, self.read_id,
                            len(self.payload)) + self.payload

    @staticmethod
    def from_bytes(buf: bytes) -> "UplinkFrame":
        magic, ver, kind, device_id, seq, read_id, n = _HEADER.unpack_from(
            buf, 0)
        if magic != MAGIC:
            raise ValueError(f"bad uplink magic {magic:#x}")
        if ver != VERSION:
            raise ValueError(f"unsupported uplink version {ver}")
        payload = bytes(buf[_HEADER.size:_HEADER.size + n])
        if len(payload) != n:
            raise ValueError(f"truncated frame: payload {len(payload)}/{n}")
        return UplinkFrame(device_id=device_id, seq=seq, kind=kind,
                           read_id=read_id, payload=payload)


@dataclasses.dataclass(frozen=True)
class DecodedRead:
    """Aggregator-side view of one read frame."""
    device_id: int
    read_id: int
    bases: np.ndarray               # (L,) tokens 1..4, the decision prefix
    mapped_pos: int                 # device's prefix-map position (-1: none)
    samples_at_decision: int
    samples_sequenced: int
    total_samples: int
    signal: np.ndarray | None       # optional int8-round-tripped snippet


def encode_read(record, *, signal_snippet: int = 0) -> bytes:
    """Payload for an accepted
    :class:`repro_torch.realtime.session.ReadRecord`.

    ``signal_snippet`` > 0 additionally packs the first that-many raw
    samples through the shared int8 codec (QC evidence; off by default —
    the bases already carry the information)."""
    bases = record.bases if record.bases is not None else np.zeros(0)
    sig_bytes, scale, n_sig = b"", 0.0, 0
    if signal_snippet > 0:
        raise ValueError(
            "signal_snippet encoding needs the raw signal: use "
            "encode_read_signal(record, signal, n)")
    return _encode_read(bases, int(record.mapped_pos),
                        int(record.samples_at_decision),
                        int(record.samples_sequenced),
                        int(record.total_samples), sig_bytes, scale, n_sig)


def encode_read_signal(record, signal: np.ndarray, n: int) -> bytes:
    """Like :func:`encode_read` but with the first ``n`` raw samples as an
    int8 snippet."""
    bases = record.bases if record.bases is not None else np.zeros(0)
    snip = np.asarray(signal, np.float32)[:n]
    sig_bytes, scale = encode_signal_int8(snip)
    return _encode_read(bases, int(record.mapped_pos),
                        int(record.samples_at_decision),
                        int(record.samples_sequenced),
                        int(record.total_samples), sig_bytes, scale,
                        len(snip))


def _encode_read(bases, mapped_pos, at_decision, sequenced, total,
                 sig_bytes: bytes, scale: float, n_sig: int) -> bytes:
    bases = np.asarray(bases)
    head = _READ_HEAD.pack(mapped_pos, at_decision, sequenced, total,
                           len(bases), n_sig, scale)
    return head + pack_bases(bases) + sig_bytes


def decode_read(frame: UplinkFrame) -> DecodedRead:
    if frame.kind != KIND_READ:
        raise ValueError(f"not a read frame (kind={frame.kind})")
    (mapped_pos, at_decision, sequenced, total, n_bases, n_sig,
     scale) = _READ_HEAD.unpack_from(frame.payload, 0)
    off = _READ_HEAD.size
    n_base_bytes = (n_bases + 3) // 4
    bases = unpack_bases(frame.payload[off:off + n_base_bytes], n_bases)
    off += n_base_bytes
    signal = None
    if n_sig:
        signal = decode_signal_int8(frame.payload[off:off + n_sig], scale)
    return DecodedRead(device_id=frame.device_id, read_id=frame.read_id,
                       bases=bases, mapped_pos=mapped_pos,
                       samples_at_decision=at_decision,
                       samples_sequenced=sequenced, total_samples=total,
                       signal=signal)


def read_frame(device_id: int, seq: int, record, *,
               signal: np.ndarray | None = None,
               signal_snippet: int = 0) -> UplinkFrame:
    """Build the uplink frame for one accepted read."""
    if signal_snippet > 0 and signal is not None:
        payload = encode_read_signal(record, signal, signal_snippet)
    else:
        payload = encode_read(record)
    return UplinkFrame(device_id=device_id, seq=seq, kind=KIND_READ,
                       read_id=int(record.read_id), payload=payload)


def telemetry_frame(device_id: int, seq: int, telemetry) -> UplinkFrame:
    """Per-device accounting as a zlib-compressed ``Telemetry.to_dict()``
    JSON payload — the aggregator restores and ``Telemetry.merge``-s it
    into the fleet rollup.  Compressed because exact-mode latency
    histograms carry raw observations: uncompressed snapshots would
    dominate bytes-on-wire and bury the read-frame bandwidth win."""
    payload = zlib.compress(json.dumps(telemetry.to_dict()).encode(), 6)
    return UplinkFrame(device_id=device_id, seq=seq, kind=KIND_TELEMETRY,
                       read_id=-1, payload=payload)


def decode_telemetry(frame: UplinkFrame):
    if frame.kind != KIND_TELEMETRY:
        raise ValueError(f"not a telemetry frame (kind={frame.kind})")
    from repro_torch.engine.telemetry import Telemetry
    try:
        raw = zlib.decompress(frame.payload)
    except zlib.error as e:
        raise ValueError(f"corrupt telemetry payload: {e}") from None
    return Telemetry.from_dict(json.loads(raw.decode()))

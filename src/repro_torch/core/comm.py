"""Unified communication plane: wire codecs + byte-accounted transport.

The survey's communication-reduction chapter observes that transfer
volume — ghost activations, remote feature rows, cache fills — is the
dominant scaling bottleneck of distributed GNN systems, and that the
systems which beat it (Dorylus' quantized lambda traffic, SANCUS'
bounded-error broadcast avoidance) all compress the wire format while
bounding the induced error.  This module is the repo's one implementation
of that idea: every remote byte in all three system families flows
through it.

* :class:`WireCodec` — pluggable payload encodings with a per-row wire
  size and host (numpy) encode/decode.  (The reference's in-step
  quantize-dequantize, ``jax_qdq``, arrives with the async slice.)

  - ``fp32``: identity; bit-exact with the pre-codec behavior.
  - ``bf16``: round-to-nearest-even truncation, 2 bytes/element.
  - ``int8``: per-row affine quantization (row min + 255 steps), 1
    byte/element + 8 bytes/row of scale/offset metadata, with optional
    **error-feedback** residuals on the sender so the bias of repeated
    sends of the same row averages out (the SANCUS-style bounded-error
    argument: the running mean of decoded sends converges to the truth).

* :class:`Transport` — one sender↔receiver channel: frames each send as
  ``[HEADER_BYTES envelope][n_rows × wire_bytes_per_row]``, owns the
  error-feedback residual state, and accounts payload/header bytes,
  rows, and RPCs.  A send that moves zero rows costs zero bytes (no
  envelope) — the invariant the ``fetch_masked`` regression tests pin.

Consumers: :class:`repro_torch.core.halo.HaloExchange` (ghost-plane refresh
accounting + in-step qdq via :func:`repro_torch.models.gnn.model.forward_stale`),
:class:`repro_torch.core.caching.FeatureStore` /
:class:`repro_torch.distributed.sampler.PartitionFeatureStore` (remote feature
fetches), and :class:`repro_torch.serving.cache.EmbeddingCache` (cache-fill
payloads).  Select with ``--wire-codec {fp32,bf16,int8}`` on
``launch/train_gnn.py`` and ``launch/serve_gnn.py``, or
``GNNConfig.wire_codec``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Union

import numpy as np

from repro_torch.core import telemetry


class QuantizedRows(NamedTuple):
    """An int8 wire batch kept in its wire format: ``q`` (n, F) uint8
    codes with per-row affine metadata ``mn``/``scale`` (n, 1) float32;
    row i dequantizes to ``mn[i] + q[i] * scale[i]``.

    This is the type the int8-in/fp32-accumulate kernel consumes
    directly (K4, :func:`repro_torch.kernels.segment_sum.
    gather_scale_segment_sum_q_cuda`, the Hopper counterpart of the
    reference's ``gather_scale_segment_sum_q_pallas``) —
    :meth:`FeatureStore.fetch_masked_wire` hands fetched rows to the
    aggregation without a decode round-trip.  Fields are numpy arrays.
    """
    q: "np.ndarray"
    mn: "np.ndarray"
    scale: "np.ndarray"

    @property
    def num_rows(self) -> int:
        return self.q.shape[0]

    def rows(self, index) -> "QuantizedRows":
        """Row-sliced view (same wire format)."""
        return QuantizedRows(self.q[index], self.mn[index],
                             self.scale[index])

    def dequantize(self):
        """The receiver's float32 view — identical math to
        :meth:`Int8Codec.decode` (``mn + q * scale``)."""
        return (self.mn + self.q.astype("float32") * self.scale
                ).astype("float32")

# per-RPC envelope cost of one remote transfer (DistDGL KVStore-style
# request header: keys, shard route, lengths) — charged once per send
# that actually moves rows, never for sends fully served locally.  This
# is the ONE definition; `core.caching` and `core.halo` import it.
HEADER_BYTES = 64

# int8 per-row affine metadata: row offset (min) + quantization step
# (scale), one float32 each
INT8_ROW_META_BYTES = 8


# ---------------------------------------------------------------------------
# bfloat16 emulation (numpy has no native bf16)
# ---------------------------------------------------------------------------

def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit pattern (uint16), round-to-nearest-even —
    matches jnp's ``astype(bfloat16)`` on finite values."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    rounded = b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))
    return (rounded >> np.uint32(16)).astype(np.uint16)


def _bf16_value(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit pattern (uint16) -> float32 value."""
    return (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WirePayload:
    """One encoded message body: opaque per-codec arrays + its wire size.

    ``data`` is codec-specific (quantized values, row metadata); only
    ``nbytes`` (payload bytes on the wire, excluding the per-RPC header)
    and ``n_rows`` are interpreted by :class:`Transport`.
    """
    codec: str
    n_rows: int
    nbytes: int
    data: tuple


class WireCodec:
    """A wire encoding for float32 row batches.

    Subclasses define ``name``, :meth:`wire_bytes_per_row`,
    and :meth:`encode` / :meth:`decode` (host-side, numpy).  ``identity`` marks the lossless fp32 codec so
    hot paths can skip encode/decode entirely and stay bit-exact;
    ``error_feedback`` marks codecs whose senders should keep residuals.
    """

    name: str = "abstract"
    identity: bool = False
    error_feedback: bool = False

    def wire_bytes_per_row(self, dim: int) -> int:
        """Payload bytes one ``dim``-wide row occupies on the wire
        (excluding the per-RPC :data:`HEADER_BYTES` envelope)."""
        raise NotImplementedError

    def encode(self, rows: np.ndarray) -> WirePayload:
        """Encode ``(n, dim)`` float rows into a wire payload."""
        raise NotImplementedError

    def decode(self, payload: WirePayload) -> np.ndarray:
        """Decode a payload back to ``(n, dim)`` float rows (what the
        receiver sees; lossy codecs do not round-trip exactly)."""
        raise NotImplementedError

    def qdq(self, rows: np.ndarray) -> np.ndarray:
        """Host-side quantize→dequantize: the receiver's view of ``rows``."""
        return self.decode(self.encode(rows))


class Fp32Codec(WireCodec):
    """Identity codec: 4 bytes/element, bit-exact — today's raw-fp32 wire
    format, kept as the behavior-preserving default."""

    name = "fp32"
    identity = True

    def wire_bytes_per_row(self, dim: int) -> int:
        """4 bytes per element, no row metadata."""
        return 4 * dim

    def encode(self, rows: np.ndarray) -> WirePayload:
        """Pass-through (the payload carries the rows verbatim)."""
        rows = np.asarray(rows)
        return WirePayload(self.name, len(rows),
                           self.wire_bytes_per_row(rows.shape[1])
                           * len(rows), (rows,))

    def decode(self, payload: WirePayload) -> np.ndarray:
        """Pass-through."""
        return payload.data[0]

    def qdq(self, rows: np.ndarray) -> np.ndarray:
        """Identity (no copy): fp32 is lossless."""
        return np.asarray(rows)


class Bf16Codec(WireCodec):
    """Truncating bfloat16 codec: 2 bytes/element, relative error
    ≤ 2⁻⁸ per element (8-bit mantissa), no per-row metadata."""

    name = "bf16"

    def wire_bytes_per_row(self, dim: int) -> int:
        """2 bytes per element, no row metadata."""
        return 2 * dim

    def encode(self, rows: np.ndarray) -> WirePayload:
        """Round-to-nearest-even each float32 to its top 16 bits."""
        rows = np.asarray(rows, np.float32)
        return WirePayload(self.name, len(rows),
                           self.wire_bytes_per_row(rows.shape[1])
                           * len(rows), (_bf16_bits(rows),))

    def decode(self, payload: WirePayload) -> np.ndarray:
        """Re-widen the 16-bit pattern to float32."""
        return _bf16_value(payload.data[0])


class Int8Codec(WireCodec):
    """Per-row affine uint8 quantization with sender-side error feedback.

    Each row is encoded as ``q = round((x - min) / scale)`` with
    ``scale = (max - min) / 255`` (raised to the smallest float32 step
    with ``255 * scale >= max - min`` where that quotient underflows in
    the subnormals, so ``q <= 255`` holds) — 1 byte/element plus
    :data:`INT8_ROW_META_BYTES` of float32 ``(min, scale)`` metadata.
    The per-element error is bounded by ``scale / 2`` (half a
    quantization step; ``tests/test_torch_comm.py`` checks it on
    subnormal-range rows).

    ``error_feedback = True``: a :class:`Transport` (or the in-step
    residual carried by ``forward_stale``) adds the previous send's
    quantization error to the next send of the same row before encoding,
    so the running mean of decoded sends converges to the true value —
    repeated ghost refreshes accumulate no bias.
    """

    name = "int8"
    error_feedback = True

    def wire_bytes_per_row(self, dim: int) -> int:
        """1 byte per element + per-row (min, scale) metadata."""
        return dim + INT8_ROW_META_BYTES

    def encode(self, rows: np.ndarray) -> WirePayload:
        """Quantize each row against its own float32 (min, scale)."""
        rows = np.asarray(rows)
        n, dim = rows.shape
        if n == 0:
            return WirePayload(self.name, 0, 0,
                               (np.zeros((0, dim), np.uint8),
                                np.zeros((0, 1), np.float32),
                                np.zeros((0, 1), np.float32)))
        # metadata is float32 on the wire; quantize against the rounded
        # values so the scale/2 error bound holds for what was sent
        mn = rows.min(axis=1, keepdims=True).astype(np.float32)
        mx = rows.max(axis=1, keepdims=True).astype(np.float32)
        rng = mx.astype(np.float64) - mn
        scale = (rng / 255.0).astype(np.float32)
        # a positive range whose range / 255 underflows to 0 or rounds down
        # in the subnormals so far that the row's max would need q = 256
        # takes the smallest float32 step with 255 * scale >= range; every
        # other row keeps its scale bit for bit
        fix = (rng > 0) & (rng >= 255.5 * scale.astype(np.float64))
        while (short := fix & (rng > 255.0 * scale.astype(np.float64))).any():
            scale = np.where(short, np.nextafter(scale, np.float32(np.inf)),
                             scale)
        safe = np.where(scale > 0, scale, 1.0).astype(np.float64)
        q = np.rint((rows.astype(np.float64) - mn) / safe)
        q = np.clip(np.where(scale > 0, q, 0.0), 0, 255).astype(np.uint8)
        return WirePayload(self.name, n,
                           n * self.wire_bytes_per_row(dim),
                           (q, mn, scale))

    def decode(self, payload: WirePayload) -> np.ndarray:
        """``min + q * scale`` in float64, emitted as float32."""
        q, mn, scale = payload.data
        return (mn.astype(np.float64)
                + q.astype(np.float64) * scale.astype(np.float64)
                ).astype(np.float32)



CODECS: Dict[str, WireCodec] = {
    c.name: c for c in (Fp32Codec(), Bf16Codec(), Int8Codec())
}


def resolve_codec(codec: Union[str, WireCodec, None]) -> WireCodec:
    """Normalize a codec name / instance / ``None`` (→ fp32) to a
    :class:`WireCodec`, raising ``KeyError`` on unknown names."""
    if codec is None:
        return CODECS["fp32"]
    if isinstance(codec, WireCodec):
        return codec
    if codec not in CODECS:
        raise KeyError(f"unknown wire codec {codec!r}; "
                       f"choose from {sorted(CODECS)}")
    return CODECS[codec]


# ---------------------------------------------------------------------------
# transport: framing + accounting + error-feedback state
# ---------------------------------------------------------------------------

class ResidualStore:
    """Lazily grown per-row error-feedback state for a sender.

    Only rows that have actually crossed the wire get a residual row —
    a partition's remote-fetch path touches its halo set, a small
    fraction of a big graph, so a dense ``(num_nodes, dim)`` value
    buffer would dwarf the feature matrix itself.  The id→slot map is a
    dense int32 vector (4 bytes per id — negligible), keeping gather and
    scatter fully vectorized on the fetch hot path; residuals are
    bounded by half a quantization step, so float32 values are plenty.
    """

    def __init__(self, n_rows: int, dim: int):
        self.dim = dim
        self._slot = np.full(n_rows, -1, np.int32)
        self._used = 0
        self._buf = np.zeros((16, dim), np.float32)

    def gather(self, row_ids: np.ndarray) -> np.ndarray:
        """Current residual rows for ``row_ids`` (zeros if never sent)."""
        slots = self._slot[np.asarray(row_ids)]
        out = np.zeros((len(slots), self.dim), np.float32)
        known = slots >= 0
        out[known] = self._buf[slots[known]]
        return out

    def scatter(self, row_ids: np.ndarray, values: np.ndarray) -> None:
        """Store updated residual rows (allocating slots on first send)."""
        row_ids = np.asarray(row_ids)
        fresh = np.unique(row_ids[self._slot[row_ids] < 0])
        if len(fresh):
            self._slot[fresh] = self._used + np.arange(len(fresh),
                                                       dtype=np.int32)
            self._used += len(fresh)
            while self._used > len(self._buf):
                self._buf = np.concatenate(
                    [self._buf, np.zeros_like(self._buf)])
        self._buf[self._slot[row_ids]] = values.astype(np.float32)


class Transport:
    """One byte-accounted sender→receiver channel over a wire codec.

    Every remote transfer in the repo is a :meth:`send`: the payload is
    encoded, charged as ``n_rows × wire_bytes_per_row + HEADER_BYTES``
    (one envelope per RPC that moves rows — a zero-row send is free and
    unframed), decoded, and the receiver's view returned.  For
    error-feedback codecs constructed with ``n_rows``, the channel keeps
    one residual row per sender-side row id (grown lazily, only for rows
    that actually cross the wire): ``send(x)`` transmits ``Q(x + r)``
    and stores ``r' = (x + r) - decode(Q(x + r))``, so repeated sends of
    a row are unbiased on average.

    Args:
        codec: wire codec name or instance.
        n_rows: sender-side row-id space for error-feedback residuals
            (``None`` = stateless sends, residuals disabled; the value
            bounds nothing — residual rows are allocated per *touched*
            id via :class:`ResidualStore`).
        path: telemetry label naming the transfer path this channel
            serves (``"serving.features"``, ``"minibatch.features"``,
            ``"serving.fill"``, ...).  Every send is mirrored into the
            process telemetry plane (:mod:`repro_torch.core.telemetry`) as
            ``comm_bytes_total{path,codec,kind=payload|header}`` /
            ``comm_rows_total`` / ``comm_sends_total`` — transports
            sharing a path aggregate into the same series.
    """

    def __init__(self, codec: Union[str, WireCodec] = "fp32", *,
                 n_rows: Optional[int] = None, path: str = "default"):
        self.codec = resolve_codec(codec)
        self.path = path
        self._n_rows = n_rows if n_rows else 0
        self._ef_enabled = bool(n_rows) and self.codec.error_feedback
        self.residuals: Optional[ResidualStore] = None    # lazy, per dim
        self.payload_bytes = 0
        self.header_bytes = 0
        self.rows_sent = 0
        self.requests = 0
        lab = dict(path=path, codec=self.codec.name)
        self._m_payload = telemetry.counter(
            "comm_bytes_total", "bytes moved by the communication plane",
            kind="payload", **lab)
        self._m_header = telemetry.counter(
            "comm_bytes_total", kind="header", **lab)
        self._m_rows = telemetry.counter(
            "comm_rows_total", "rows moved by the communication plane",
            **lab)
        self._m_sends = telemetry.counter(
            "comm_sends_total", "RPCs issued by the communication plane",
            **lab)

    def _record(self, payload: int, n_rows: int) -> None:
        """Mirror one accounted send into the telemetry plane."""
        self._m_payload.inc(payload)
        self._m_header.inc(HEADER_BYTES)
        self._m_rows.inc(n_rows)
        self._m_sends.inc()

    @property
    def total_bytes(self) -> int:
        """Payload + per-RPC envelope bytes moved so far."""
        return self.payload_bytes + self.header_bytes

    def _residuals_for(self, dim: int) -> Optional[ResidualStore]:
        if not self._ef_enabled:
            return None
        if self.residuals is None or self.residuals.dim != dim:
            self.residuals = ResidualStore(self._n_rows, dim)
        return self.residuals

    def send(self, rows: np.ndarray,
             row_ids: Optional[np.ndarray] = None) -> np.ndarray:
        """One RPC: encode → account → decode; returns the receiver's
        float32 view of ``rows``.  ``row_ids`` keys the error-feedback
        residuals (ignored for stateless codecs/transports).  A zero-row
        send returns immediately and charges nothing."""
        rows = np.asarray(rows, np.float32)
        if rows.ndim != 2:
            raise ValueError(f"send expects (n, dim) rows, got {rows.shape}")
        n, dim = rows.shape
        if n == 0:
            return rows
        if self.codec.identity:
            # fast path: fp32 is the wire format — account the send and
            # hand the rows through untouched (zero copies on the
            # default-codec hot paths)
            payload = n * self.codec.wire_bytes_per_row(dim)
            self.payload_bytes += payload
            self.header_bytes += HEADER_BYTES
            self.rows_sent += n
            self.requests += 1
            self._record(payload, n)
            return rows
        res = self._residuals_for(dim)
        if res is not None and row_ids is not None:
            row_ids = np.asarray(row_ids)
            pre = rows.astype(np.float64) + res.gather(row_ids)
            payload = self.codec.encode(pre)
            out = self.codec.decode(payload)
            res.scatter(row_ids, pre - out)
            out = out.astype(np.float32)
        else:
            payload = self.codec.encode(rows)
            out = self.codec.decode(payload).astype(np.float32)
        self.payload_bytes += payload.nbytes
        self.header_bytes += HEADER_BYTES
        self.rows_sent += n
        self.requests += 1
        self._record(payload.nbytes, n)
        return out

    def send_wire(self, rows: np.ndarray,
                  row_ids: Optional[np.ndarray] = None) -> QuantizedRows:
        """One RPC that hands the receiver the *wire format* instead of
        the decoded view: identical accounting and error-feedback
        residual updates to :meth:`send`, but the int8 payload is
        returned as :class:`QuantizedRows` so the receiver can feed it
        straight into the int8-in/fp32-accumulate kernel — no decode
        round-trip through an HBM-resident fp32 feature matrix.

        Only meaningful for the ``int8`` codec (the one wire format the
        kernel consumes); other codecs raise."""
        if self.codec.name != "int8":
            raise ValueError(
                f"send_wire requires the int8 codec (got "
                f"{self.codec.name!r}); use send() for decoded rows")
        rows = np.asarray(rows, np.float32)
        if rows.ndim != 2:
            raise ValueError(f"send_wire expects (n, dim) rows, got "
                             f"{rows.shape}")
        n, dim = rows.shape
        if n == 0:
            return QuantizedRows(np.zeros((0, dim), np.uint8),
                                 np.zeros((0, 1), np.float32),
                                 np.zeros((0, 1), np.float32))
        res = self._residuals_for(dim)
        if res is not None and row_ids is not None:
            row_ids = np.asarray(row_ids)
            pre = rows.astype(np.float64) + res.gather(row_ids)
            payload = self.codec.encode(pre)
            res.scatter(row_ids, pre - self.codec.decode(payload))
        else:
            payload = self.codec.encode(rows)
        self.payload_bytes += payload.nbytes
        self.header_bytes += HEADER_BYTES
        self.rows_sent += n
        self.requests += 1
        self._record(payload.nbytes, n)
        q, mn, scale = payload.data
        return QuantizedRows(q, mn, scale)

    def account_opaque(self, n_rows: int, bytes_per_row: int) -> None:
        """Charge a send whose payload is not float rows (e.g. raw node
        ids on a feature-less graph): same framing, no codec."""
        if n_rows <= 0:
            return
        self.payload_bytes += n_rows * bytes_per_row
        self.header_bytes += HEADER_BYTES
        self.rows_sent += n_rows
        self.requests += 1
        self._record(n_rows * bytes_per_row, n_rows)

    def reset_counters(self) -> None:
        """Zero the traffic counters (error-feedback residuals are kept —
        they are sender state, not accounting).  Used to exclude warmup
        traffic from reported stats.  The channel's telemetry series are
        reset too so the exposed ``comm_*`` numbers keep matching the
        instance counters (note: transports sharing a ``path`` share the
        series, so a reset excludes *everyone's* pre-reset traffic — in
        practice same-path transports are reset together, e.g. serving
        warmup)."""
        self.payload_bytes = 0
        self.header_bytes = 0
        self.rows_sent = 0
        self.requests = 0
        for m in (self._m_payload, self._m_header, self._m_rows,
                  self._m_sends):
            m.reset()

    def stats(self) -> dict:
        """Lifetime channel counters for summaries."""
        return {
            "wire_codec": self.codec.name,
            "payload_bytes": self.payload_bytes,
            "header_bytes": self.header_bytes,
            "total_bytes": self.total_bytes,
            "rows_sent": self.rows_sent,
            "requests": self.requests,
        }

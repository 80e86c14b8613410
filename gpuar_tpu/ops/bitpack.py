"""Host-side bit packing of encoder emission descriptors (SPEC/TEST tier).

pack_batch loops over lanes in Python — intentional: this module exists to
turn the XLA scan's emission descriptors into golden bitstreams for tests
and readable spec, not to serve production traffic (that is the coder
op's job, ops/coder_op.py; the host production path is the native golden
codec).

The vectorized XLA scan encoder emits, per
symbol step, a fixed-size *descriptor* of the variable-length bit emission
instead of writing bits serially (SURVEY.md §7.4 item 1):

    b0       first settled bit (top bit of the old upper bound), if any
    u_drain  number of pending-underflow complement bits drained after b0
    m        number of settled MSBs (0..16); emission exists iff m > 0
    pat      the remaining m-1 settled bits (after b0), MSB-first

plus one tail descriptor per packet for the final flush
(writeRemaining, src/gpuar_kernel.cu:379-388): tail bit then
(underflow+1) complements.

The emission for one step is:  [b0] + [~b0]*u_drain + bits(pat, m-1).
Packing descriptors to bytes is a pure data-layout task:
``np.repeat`` expands runs and ``np.packbits`` packs MSB-first with the
same left-aligned zero padding as writeClose (src/gpuar_kernel.cu:430-439).
"""

from __future__ import annotations

import numpy as np

from gpuar_tpu.config import PACKET_HEADER_LENGTH


def unpack_descriptors(desc: np.ndarray):
    """Split the packed per-step descriptor word.

    Layout (see ops.xla_codec): bit0 = b0, bits1..5 = m, bits6.. = u_drain.
    """
    b0 = desc & 1
    m = (desc >> 1) & 0x1F
    u = desc >> 6
    return b0, m, u


def pack_lane(desc: np.ndarray, pat: np.ndarray, tail_bit: int, tail_run: int,
              raw_size: int) -> bytes:
    """Pack one packet's descriptor stream into header + bitstream bytes.

    desc/pat are the per-step i32 arrays for this lane (length >= steps
    taken; steps with m == 0 and u == 0 contribute nothing).
    """
    b0, m, u = unpack_descriptors(desc)

    # Per-step items, in emission order: b0 (len 0/1), run of ~b0 (len u),
    # then the m-1 pattern bits individually.
    has = (m > 0).astype(np.int64)
    npat = np.maximum(m - 1, 0)
    # Pattern bit j (MSB-first among m-1 bits): (pat >> (m-2-j)) & 1.
    j = np.arange(15)
    shifts = (m[:, None] - 2 - j[None, :])
    patbits = (pat[:, None] >> np.maximum(shifts, 0)) & 1
    patmask = (j[None, :] < npat[:, None]).astype(np.int64)

    values = np.concatenate(
        [b0[:, None], (1 - b0)[:, None], patbits], axis=1
    ).ravel()
    lengths = np.concatenate(
        [has[:, None], u[:, None].astype(np.int64), patmask], axis=1
    ).ravel()

    bits = np.repeat(values.astype(np.uint8), lengths)
    tail = np.concatenate(
        [
            np.array([tail_bit], dtype=np.uint8),
            np.full(tail_run, 1 - tail_bit, dtype=np.uint8),
        ]
    )
    stream = np.concatenate([bits, tail])
    payload = np.packbits(stream)  # MSB-first, zero-padded: matches writeClose

    total = PACKET_HEADER_LENGTH + payload.size
    header = np.array(
        [total & 0xFF, (total >> 8) & 0xFF, raw_size & 0xFF, (raw_size >> 8) & 0xFF],
        dtype=np.uint8,
    )
    return header.tobytes() + payload.tobytes()


def pack_batch(desc: np.ndarray, pat: np.ndarray, tail_bits: np.ndarray,
               tail_runs: np.ndarray, raw_sizes: np.ndarray,
               out_stride: int) -> tuple[np.ndarray, np.ndarray]:
    """Pack all lanes: desc/pat are [steps, lanes]; returns fixed-stride
    packets [lanes, out_stride] and their total lengths."""
    lanes = desc.shape[1]
    out = np.zeros((lanes, out_stride), dtype=np.uint8)
    lengths = np.zeros(lanes, dtype=np.int32)
    for l in range(lanes):
        steps = int(raw_sizes[l])
        pkt = pack_lane(
            desc[:steps, l], pat[:steps, l], int(tail_bits[l]),
            int(tail_runs[l]), steps,
        )
        lengths[l] = len(pkt)
        out[l, : len(pkt)] = np.frombuffer(pkt, dtype=np.uint8)
    return out, lengths

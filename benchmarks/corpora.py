"""Seeded test and smoke corpora that mix the codec's content classes.

Classes: uniform random bytes (incompressible), the pinned enwik8
stand-in (benchmarks/enwik_proxy.py), its high-byte UTF-8 variant, zeros,
and one packet built against the live coder state so that its underflow
runs grow past a hundred pending bits (the stream shape that a fixed bit
budget per step cannot hold).
"""

from __future__ import annotations

import numpy as np

from benchmarks import enwik_proxy

PACKET = 8192


def adversarial_underflow_packet(n: int = PACKET) -> np.ndarray:
    """Greedy adversary against the live coder state: each step picks a
    symbol whose coded interval straddles the midpoint tightly, so the
    pending-underflow run reaches ~133 consecutive bits."""
    U16 = 0xFFFF
    C = np.arange(257, dtype=np.int64)
    lower, upper, cum, under = 0, U16, 256, 0
    syms = []
    for _ in range(n):
        span = upper - lower + 1
        lo_all = lower + C[:-1] * span // cum
        up_all = lower + C[1:] * span // cum - 1
        ok = ((lo_all >= 0x4000) & (lo_all < 0x8000)
              & (up_all >= 0x8000) & (up_all < 0xC000))
        s = int(np.argmax(ok)) if ok.any() and under < 150 else 0
        syms.append(s)
        lo2, up2 = int(lo_all[s]) & U16, int(up_all[s]) & U16
        C[s + 1:] += 1
        cum += 1
        while True:
            if (lo2 ^ up2) & 0x8000 == 0:
                under = 0
                lo2 = (lo2 << 1) & U16
                up2 = ((up2 << 1) | 1) & U16
            elif (lo2 & 0x4000) and not (up2 & 0x4000):
                under += 1
                lo2 = (lo2 << 1) & 0x7FFF
                up2 = (((up2 << 1) | 1) | 0x8000) & U16
            else:
                break
        lower, upper = lo2, up2
    return np.array(syms, np.uint8)


class Mixer:
    """Content blocks of each class, made once and reused: the proxy
    generators run at a few MB/s, so large corpora repeat one generated
    block per text class."""

    def __init__(self, seed: int, text_block: int = 8 << 20):
        self.rng = np.random.default_rng(seed)
        self.text = np.frombuffer(enwik_proxy.generate(text_block), np.uint8)
        self.utf8 = np.frombuffer(enwik_proxy.generate_utf8(text_block),
                                  np.uint8)
        self.adversarial = adversarial_underflow_packet()

    def block(self, kind: int, size: int) -> np.ndarray:
        if kind == 0:
            return self.rng.integers(0, 256, size, np.uint8)
        if kind == 3:
            return np.zeros(size, np.uint8)
        src = self.text if kind == 1 else self.utf8
        reps = -(-size // src.size)
        return np.tile(src, reps)[:size]

    def packets(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """n packets [n, PACKET] u8 and their raw sizes: the four classes
        in runs of 64 packets, the adversarial packet first, and a short
        tail packet last."""
        data = np.empty((n, PACKET), np.uint8)
        for start in range(0, n, 64):
            stop = min(start + 64, n)
            data[start:stop] = self.block(
                (start // 64) % 4, (stop - start) * PACKET).reshape(-1, PACKET)
        data[0] = self.adversarial
        sizes = np.full(n, PACKET, np.int32)
        sizes[-1] = PACKET // 3 + 5
        data[-1, sizes[-1]:] = 0
        return data, sizes

    def write_file(self, path, size: int, segment: int = 64 << 20) -> None:
        """A file of ``size`` bytes cycling the classes in ``segment``
        runs, the adversarial packet at its start."""
        with open(path, "wb") as f:
            f.write(self.adversarial.tobytes()[:size])
            done = min(size, PACKET)
            kind = 0
            while done < size:
                n = min(segment, size - done)
                f.write(self.block(kind, n).tobytes())
                done += n
                kind = (kind + 1) % 4

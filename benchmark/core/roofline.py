"""The yardstick for kernels: the card's peaks and a kernel's least time.

Copied from chip_smoke.py (:277-284 the constants, :362 ``Bound``, :386
``nbytes``), with the card's maximum SM clock taken from the table of peaks
below rather than read from nvidia-smi, so that the yardstick is fixed.

A kernel's least time is the larger of the bytes it must move (each input
read once, each output written once) over HBM bandwidth and its 32-bit
integer multiplies over the card's rate for them (SMs x 64 per clock x the
maximum SM clock).  A W-word CIOS Montgomery multiply is 2 W^2 + W
32x32->64-bit products, each two 32-bit multiplies (low and high word).
"""

from __future__ import annotations

# Montgomery multiplies per lane of one mixed add, as the kernels do it
# (csrc/curve.cuh)
MIXED_ADD_MULS = 11

# NVIDIA's data sheet, SXM part at its 700 W limit: HBM bandwidth, SMs,
# 32-bit integer multiply-adds per SM per clock (compute capability 9.0)
# and the maximum SM clock
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "sms": 132,
                              "imul_per_clk_per_sm": 64, "max_sm_mhz": 1980.0},
}


def peaks_for(kind: str):
    """The table's entry for a card, by the name torch gives it; None for a
    card the table does not hold (a roofline is then not read)."""
    return PEAKS.get(kind)


class Bound:
    def __init__(self, peaks: dict):
        self.imul_per_s = peaks["sms"] * peaks["imul_per_clk_per_sm"] * peaks["max_sm_mhz"] * 1e6
        self.bytes_per_s = peaks["hbm_bytes_per_s"]

    @staticmethod
    def imuls(W: int, montmuls: float) -> float:
        return 2 * (2 * W * W + W) * montmuls

    def seconds(self, W: int, montmuls: float, nbytes: float) -> float:
        return max(self.imuls(W, montmuls) / self.imul_per_s, nbytes / self.bytes_per_s)


def nbytes(*tensors) -> int:
    """Bytes of the distinct elements each tensor addresses: a broadcast
    (stride 0) dimension is read once."""
    total = 0
    for t in tensors:
        n = 1
        for size, stride in zip(t.shape, t.stride()):
            if stride != 0:
                n *= size
        total += n * t.element_size()
    return total

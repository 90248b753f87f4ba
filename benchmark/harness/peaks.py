"""Published peaks by the card's name (NVIDIA data sheets, dense rates, at
the full power limit): fp32 outside the tensor cores, bf16 on the tensor
cores (FLOP/s), and device memory bandwidth (bytes/s). The first match of
the name wins."""

from __future__ import annotations

from typing import Optional

PEAKS = (("H100 PCIe", 51.2e12, 756e12, 2.0e12), ("H100 NVL", 60.0e12, 835e12, 3.9e12),
         ("H200", 67.0e12, 989e12, 4.8e12), ("H100", 67.0e12, 989e12, 3.35e12))


def peaks(card: Optional[str]) -> Optional[dict]:
    """{"fp32", "bf16", "bytes"} of a card, or None for a card the table
    does not know (or no card)."""
    for key, fp32, bf16, bw in PEAKS:
        if card and key in card:
            return {"fp32": fp32, "bf16": bf16, "bytes": bw}
    return None


def bound_s(ops: float, nbytes: float, peak_ops: float, peak_bytes: float) -> float:
    """The least time: the larger of operations over the peak rate and bytes
    over the bandwidth."""
    return max(ops / peak_ops if peak_ops else 0.0, nbytes / peak_bytes)

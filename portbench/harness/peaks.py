"""Published peaks of the cards the benchmark runs on, looked up by the
name ``torch.cuda.get_device_name()`` gives.  NVIDIA's H100 SXM data
sheet: 3.35 TB/s of HBM3, 67 TFLOP/s of float32 outside the tensor cores,
at the full power limit of 700 W.  A card not in the table has no peak,
and a roofline share is then not reported."""

from __future__ import annotations

from typing import Optional

__all__ = ["PEAKS", "peaks_for"]

PEAKS = {
    "H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "fp32_flop_per_s": 67e12},
}


def peaks_for(card: str) -> Optional[dict]:
    for key, val in PEAKS.items():
        if key in card:
            return val
    return None

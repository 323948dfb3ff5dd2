"""Published peaks of the cards the benchmark runs on.

NVIDIA H100 SXM (NVIDIA's data sheet; dense rates, no sparsity, at the
full 700 W power limit): 989 TFLOP/s bf16 and fp16, 495 TF32, 67 fp32
outside the tensor cores, 80 GB of HBM3 at 3.35 TB/s.  A card set below
700 W reaches less; the run prints the card's power limit beside its
shares.
"""

from __future__ import annotations

from typing import Dict, Optional

__all__ = ["PEAKS", "peaks_for"]

PEAKS: Dict[str, Dict[str, float]] = {
    "H100": {"bf16_flops": 989e12, "tf32_flops": 495e12,
             "fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12,
             "hbm_bytes": 80e9},
}


def peaks_for(device_kind: str) -> Optional[Dict[str, float]]:
    """The peaks of the card whose `torch.cuda.get_device_name()` is
    `device_kind`, or None for a card the table does not hold."""
    for key, peaks in PEAKS.items():
        if key in device_kind:
            return peaks
    return None

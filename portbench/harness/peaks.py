"""Published peaks of the cards the benchmark runs on (datasheets, dense
rates, full power limit). A device not listed has no peak: the readers
that need one then report nothing."""
from __future__ import annotations

#: name fragment as ``torch.cuda.get_device_name()`` gives it -> peaks.
#: NVIDIA H100 SXM5 datasheet: 989 TFLOP/s dense bf16, HBM3 3.35 TB/s.
PEAKS = {
    "H100": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def of(device_kind: str):
    for frag, p in PEAKS.items():
        if frag in device_kind:
            return p
    return None

"""Published peaks of the chips the benchmark runs on (NVIDIA's data sheet
for the H100 SXM: dense rates, no sparsity, at the full 700 W power
limit).  A roofline or utilisation share is stated against these, with
the card's power limit printed beside it."""

from __future__ import annotations

PEAKS = {
    "H100": {
        "flops": {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
                  "float16": 989e12, "fp8": 1979e12},
        "hbm_bytes_per_s": 3.35e12,
        "memory_bytes": 80e9,
    },
}


def peaks_of(kind: str) -> dict:
    """The peaks of the card named ``kind`` (`torch.cuda.get_device_name`);
    raises for a card the table does not hold."""
    for key, p in PEAKS.items():
        if key in kind:
            return p
    raise KeyError(f"no published peaks for {kind!r}")

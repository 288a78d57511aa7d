"""The whole unit's share of the chip's peak, %: the least time of its work
(benchmark/roofline.py: the SI steps' bytes, the analysis's ensemble
bytes and products) over the untraced units' wall time."""


def read(rec: dict):
    b = rec.get("bounds", {}).get("step")
    w = rec.get("plain_s", 0.0)
    return 100.0 * b / w if b and w > 0 else None

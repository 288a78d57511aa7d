"""The allocator's peak over the window, GiB
(torch.cuda.max_memory_allocated after a reset at the window's start)."""


def read(rec: dict):
    v = rec.get("peak_bytes", 0)
    return v / 2 ** 30 if v > 0 else None

"""The device's idle share of a unit, %: one less the device's busy time
in the traced units (the union of their kernel, copy and set intervals)
over the wall time of as many untraced units run just before them, so
that the profiler's own host time between launches does not count as
idle."""


def read(rec: dict):
    busy, w = rec.get("busy_s", 0.0), rec.get("plain_s", 0.0)
    return 100.0 * (1.0 - busy / w) if busy > 0 and w > 0 else None

"""Seconds a unit in the program's `das_letkf/select` section (the
analysis's localized obs selection), over the untraced units of a traced
run."""


def read(rec: dict):
    v = rec.get("spans", {}).get("das_letkf/select")
    return None if v is None else v / rec["units"]

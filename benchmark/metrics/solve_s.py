"""Seconds a unit in the program's `das_letkf/solve` section (kernel #1
and its operands), over the untraced units of a traced run."""


def read(rec: dict):
    v = rec.get("spans", {}).get("das_letkf/solve")
    return None if v is None else v / rec["units"]

"""Seconds a unit in the program's `das_letkf` section (the analysis), over
the untraced units of a traced run."""


def read(rec: dict):
    v = rec.get("spans", {}).get("das_letkf")
    return None if v is None else v / rec["units"]

"""Seconds a unit in the program's `forecast/acoustic` section (the SI
core's acoustic substeps), over the untraced units of a traced run."""


def read(rec: dict):
    v = rec.get("spans", {}).get("forecast/acoustic")
    return None if v is None else v / rec["units"]

"""Seconds a unit in the program's `forecast/physics` section (Kessler, or
the physics suite), over the untraced units of a traced run."""


def read(rec: dict):
    v = rec.get("spans", {}).get("forecast/physics")
    return None if v is None else v / rec["units"]

"""Seconds a unit in the program's `forecast/physics/radiation` section (the
physics suite's radiation: its recomputation and the cached tendency's
use), over the untraced units of a traced run."""


def read(rec: dict):
    v = rec.get("spans", {}).get("forecast/physics/radiation")
    return None if v is None else v / rec["units"]

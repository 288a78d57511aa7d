"""Seconds a unit in the program's `forecast/boundary` section (the Davies
relaxation toward the boundary data after every step), over the untraced
units of a traced run."""


def read(rec: dict):
    v = rec.get("spans", {}).get("forecast/boundary")
    return None if v is None else v / rec["units"]

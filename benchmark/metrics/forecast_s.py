"""Seconds a unit in the program's `forecast` section, over the untraced
units of a traced run."""


def read(rec: dict):
    v = rec.get("spans", {}).get("forecast")
    return None if v is None else v / rec["units"]

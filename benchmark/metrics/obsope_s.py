"""Seconds a unit in the program's `obsope` section (H(x) of the volume),
over the untraced units of a traced run."""


def read(rec: dict):
    v = rec.get("spans", {}).get("obsope")
    return None if v is None else v / rec["units"]

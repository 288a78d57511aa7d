"""Seconds a unit in the program's `forecast/tendencies` section (the slow
tendencies of the SI core's three stages: over terrain the plain
terrain-following tendency), over the untraced units of a traced run."""


def read(rec: dict):
    v = rec.get("spans", {}).get("forecast/tendencies")
    return None if v is None else v / rec["units"]

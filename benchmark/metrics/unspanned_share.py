"""The share of a unit's wall time outside every top-level section of the
program, %: one less the top-level spans' sum (their keys hold no '/')
over the untraced units' wall time of a traced run."""


def read(rec: dict):
    top = [v for k, v in rec.get("spans", {}).items() if "/" not in k]
    w = rec.get("plain_s", 0.0)
    return 100.0 * (1.0 - sum(top) / w) if top and w > 0 else None

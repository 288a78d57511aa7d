"""Synchronising calls a unit that the program made
(torch.cuda.set_sync_debug_mode('warn') over the untraced units of a
traced run)."""


def read(rec: dict):
    v = rec.get("sync_calls")
    return None if v is None else v / rec["units"]

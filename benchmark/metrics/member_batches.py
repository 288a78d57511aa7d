"""Member batches a unit's forecast runs in: ⌈K / members per batch⌉
(CycleDriver.batch, sized from the free device memory), as the
cell's entry passes it on with its bounds."""


def read(rec: dict):
    return rec.get("bounds", {}).get("member_batches")

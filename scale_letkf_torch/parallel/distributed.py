"""Multi-process runtime: torch.distributed bring-up and process-local data.

Port of scale_letkf_tpu/parallel/distributed.py (reference: the MPI launcher
layer and rank-addressed staging, common_mpi_scale.f90:367-512
set_mem_node_proc). The JAX package starts jax.distributed and lays one
mesh over the global device set; the port starts a torch.distributed
process group (NCCL for CUDA devices, gloo for the CPU) on a TCP store at
the coordinator's address and lays one ProcessGrid (parallel/mesh.py) over
its processes, `local_device_count` blocks to each — the counterpart of the
JAX package's forced virtual devices, and the way one card holds several
blocks. Each process reads its own members (`ProcessGrid.local_members`)
and `ensemble_from_process_local` turns them into its blocks.
"""

from __future__ import annotations

import torch

from scale_letkf_torch.parallel.mesh import ProcessGrid, Sharded

__all__ = [
    "init_distributed", "global_device_mesh", "ensemble_from_process_local",
]

# blocks per process, as init_distributed was told (the process group is
# process-wide state; so is this)
_LOCAL_BLOCKS: list[int] = []


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     local_device_count: int | None = None,
                     backend: str | None = None) -> None:
    """Start the process group: coordinator "host:port" (process 0's TCP
    store, the MPI launcher's rank-0 rendezvous), world size num_processes,
    this process's rank process_id. local_device_count: the grid blocks
    each process holds (1 when None). backend: 'nccl' when CUDA is
    available, else 'gloo', unless given; a CUDA process binds the card
    of its local rank first (NCCL's point-to-point calls need it)."""
    import torch.distributed as dist
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    _LOCAL_BLOCKS[:] = [local_device_count or 1]
    # the first collective of the group is a global one, as
    # batch_isend_irecv asks of NCCL
    if backend == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def global_device_mesh(n_member: int, n_dy: int, n_dx: int) -> ProcessGrid:
    """The (member, dy, dx) grid over every process of the group, blocks in
    process order: with blocks per process a multiple of n_dy·n_dx each
    member slab lands on whole processes (the reference's member↔node
    mapping, common_mpi_scale.f90:429-512)."""
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    per = _LOCAL_BLOCKS[0] if _LOCAL_BLOCKS else 1
    want = n_member * n_dy * n_dx
    if want != world * per:
        raise ValueError(f"grid {n_member}x{n_dy}x{n_dx} needs {want} "
                         f"blocks, have {world} processes x {per}")
    return ProcessGrid(n_member, n_dy, n_dx, rank=rank, world=world)


def ensemble_from_process_local(mesh: ProcessGrid, local_members,
                                K: int | None = None) -> Sharded:
    """This process's blocks from its own members: local_members (a
    DycoreState or tensor, leading axis) holds the members of its member
    slabs in order (`mesh.local_members(K)`), over the whole domain — the
    counterpart of the reference's rank-addressed restart stage-in. K: the
    global member count (the slabs' width times n_member when None)."""
    fields = list(local_members) if isinstance(local_members, tuple) \
        else [local_members]
    slabs = sorted({mesh.coords(b)[0] for b in mesh.local})
    n_loc = fields[0].shape[0]
    if n_loc % len(slabs):
        raise ValueError(f"{n_loc} local members over {len(slabs)} slabs")
    width = n_loc // len(slabs)
    K = K or width * mesh.n_member
    if K != width * mesh.n_member:
        raise ValueError(f"{n_loc} local members do not make slabs of "
                         f"K/n_member = {K // mesh.n_member}")
    ny, nx = fields[0].shape[-2:]
    blocks = {}
    for b in mesh.local:
        o = slabs.index(mesh.coords(b)[0]) * width
        ys, xs = mesh.rows(b, ny), mesh.cols(b, nx)
        parts = [f[o:o + width][..., ys, xs].contiguous() for f in fields]
        blocks[b] = (type(local_members)(*parts)
                     if isinstance(local_members, tuple) else parts[0])
    return Sharded(blocks, K, ny, nx)

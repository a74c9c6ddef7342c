"""Training on several cards: one process per card in a
``torch.distributed`` process group (counterpart of
``vision3d_tpu/parallel/mesh.py``).

The JAX package trains on a device mesh: the batch is sharded over its
data axis, the parameters are replicated, and XLA computes every sum over
the batch (the batch norms' statistics, the loss normalisers, the
gradient) over the global batch. The port runs one process per card, each
on its own shard of the global batch (``DataLoader(num_shards,
shard_id)``), and makes the same sums global by hand. ``global_sum``
all-reduces a tensor and carries its gradient: the backward of a sum over
the ranks is the sum of the ranks' gradients. The batch norms and the
losses take their statistics and counts through it, so each rank's loss is
its share of the global loss, and ``all_reduce_gradients`` sums the
parameters' gradients over the ranks before the clip and Adam, so every
rank makes the same update from the same parameters.

Without a process group every function here is the identity and nothing
is communicated. In one, every collective runs, also at world size 1.
"""

import contextlib
import json
import os
import socket
import tempfile

import torch
import torch.distributed as dist


def initialize_distributed(device="cuda", backend=None) -> bool:
    """Join the process group the environment describes (a no-op when it
    describes none). ``COORDINATOR_ADDRESS`` (host:port of rank 0),
    ``NUM_PROCESSES`` and ``PROCESS_ID`` give the address, the world size
    and the rank explicitly, as the JAX package's ``initialize_distributed``
    takes them; ``VISION3D_MULTIHOST=1`` reads torch's own ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` (``env://``). The backend
    is NCCL for a CUDA ``device`` and gloo on the CPU, unless ``backend``
    names one (gloo puts several ranks on one card). On the card the rank
    takes ``cuda:<rank mod visible cards>`` (``local_device``), and NCCL
    binds to it. Returns True if a group was joined."""
    if os.environ.get("COORDINATOR_ADDRESS"):
        kw = dict(init_method=f"tcp://{os.environ['COORDINATOR_ADDRESS']}",
                  world_size=int(os.environ["NUM_PROCESSES"]),
                  rank=int(os.environ["PROCESS_ID"]))
    elif os.environ.get("VISION3D_MULTIHOST") == "1":
        kw = dict(init_method="env://")
    else:
        return False
    d = torch.device(device)
    backend = backend or ("nccl" if d.type == "cuda" else "gloo")
    if d.type == "cuda":
        if d.index is None:
            r = kw.get("rank", int(os.environ.get("RANK", 0)))
            d = torch.device("cuda", r % torch.cuda.device_count())
        torch.cuda.set_device(d)
        if backend == "nccl":
            kw["device_id"] = d
    dist.init_process_group(backend, **kw)
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_device(device="cuda") -> torch.device:
    """This rank's card, ``cuda:<rank mod visible cards>``; ``device``
    itself on the CPU or where it names a card."""
    d = torch.device(device)
    if d.type != "cuda" or d.index is not None:
        return d
    return torch.device("cuda", rank() % torch.cuda.device_count())


def local_batch(global_batch: int) -> int:
    """Each rank's share of a global batch, which the world size must
    divide (as the JAX CLI asserts)."""
    n = world_size()
    if global_batch % n:
        raise ValueError(f"batch {global_batch} does not divide over {n} processes")
    return global_batch // n


def rank_slice(x):
    """This rank's slice of a tensor drawn for the global batch (its
    leading axis)."""
    b = x.shape[0] // world_size()
    return x[rank() * b:(rank() + 1) * b]


def devices_for(batch_size: int, count: int) -> int:
    """The largest number of cards, at most ``count``, that divides the
    batch: the JAX CLI's rule for one process on several devices."""
    n = max(count, 1)
    while batch_size % n:
        n -= 1
    return n


def free_port() -> int:
    """A free TCP port on localhost for a coordinator address."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world, port, argv, out):
    """One rank of ``fn(argv)`` started by ``launch``; rank 0 writes what
    it returns to ``out`` as JSON."""
    os.environ.update(COORDINATOR_ADDRESS=f"localhost:{port}",
                      NUM_PROCESSES=str(world), PROCESS_ID=str(rank))
    result = fn(argv)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(result, f)


def launch(fn, world: int, argv):
    """``fn(argv)`` (a module-level entry point that joins the group the
    coordinator variables describe) in ``world`` spawned processes, one per
    card, joined through a coordinator on a free localhost port. Returns
    rank 0's result; a rank that fails ends the others and raises here."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.json")
        mp.start_processes(_rank_main, args=(fn, world, free_port(), argv, out),
                           nprocs=world, join=True, start_method="spawn")
        with open(out) as f:
            return json.load(f)


@contextlib.contextmanager
def rank0_first():
    """Rank 0 runs the block before the other ranks do (it writes a cache
    that they then read)."""
    if rank() > 0:
        dist.barrier()
    yield
    if rank() == 0 and world_size() > 1:
        dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, with its gradient (the sum of every
    rank's gradient of it); ``x`` itself without a process group."""
    if not dist.is_initialized():
        return x
    return _AllReduceSum.apply(x)


def sum_over_ranks(values: dict) -> dict:
    """A dict of 0-d tensors (losses, counters), each summed over the ranks,
    without gradient: one all-reduce per dtype, in the dict's order (the
    same on every rank)."""
    if not dist.is_initialized() or not values:
        return values
    out = {}
    for dtype in dict.fromkeys(v.dtype for v in values.values()):
        keys = [k for k, v in values.items() if v.dtype == dtype]
        flat = torch.stack([values[k].detach() for k in keys])
        dist.all_reduce(flat)
        out.update(zip(keys, flat.unbind()))
    return {k: out[k] for k in values}


def all_reduce_gradients(params) -> None:
    """Every parameter's ``.grad`` replaced by its sum over the ranks, in
    one all-reduce of the flattened gradients (parameters without a
    gradient take part in none: the ranks run one model, so the set is the
    same on each)."""
    if not dist.is_initialized():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    for g, s in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(s.view_as(g))

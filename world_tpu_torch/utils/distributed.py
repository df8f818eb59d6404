"""Multi-process initialization and corpus sharding helpers (port of
world_tpu/utils/distributed.py).

The reference has no distributed runtime.  ``initialize`` joins a
torch.distributed process group (gloo on the CPU, nccl on the card),
``shard_utterances`` splits a corpus across processes, and
``allreduce_metrics`` sums metric dicts over processes.  The device mesh
(the JAX package's ``mesh`` argument) is not ported yet.
"""

import torch
import torch.distributed as dist

from ..device import resolve_device


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, device=None):
    """Join the process group at ``coordinator_address`` ("host:port" or
    an init-method URL such as "tcp://host:port") as rank
    ``process_id`` of ``num_processes``, on the backend for ``device``
    (the GPU unless given: nccl; "cpu": gloo).  A no-op for one process
    or when the group already exists."""
    if num_processes in (None, 1) and coordinator_address is None:
        return
    if dist.is_initialized():
        return
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    url = coordinator_address
    if url is not None and "://" not in url:
        url = f"tcp://{url}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def _rank_and_size():
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_utterances(paths, process_index=None, process_count=None):
    """Deterministic round-robin split of a corpus across processes."""
    rank, size = _rank_and_size()
    pi = rank if process_index is None else process_index
    pc = size if process_count is None else process_count
    return list(paths)[pi::pc]


def allreduce_metrics(metrics, mesh=None):
    """Sum each process's numeric metrics across all processes (keys
    sorted; other values dropped).  The identity for one process; with
    several, one float64 all_reduce(SUM) over the group."""
    if mesh is not None:
        raise NotImplementedError("mesh sharding is not ported yet")
    keys = sorted(k for k, v in metrics.items()
                  if isinstance(v, (int, float)))
    values = [float(metrics[k]) for k in keys]
    if _rank_and_size()[1] == 1:
        return dict(zip(keys, values))
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    total = torch.tensor(values, dtype=torch.float64, device=dev)
    dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return dict(zip(keys, total.cpu().tolist()))

"""Multi-process runtime on torch.distributed (counterpart of
tpu_smc/ensemble.py:817-861).

The reference's parallel model is independent replicas, one per MPI rank,
pooled offline from per-rank files (SMC.c:66-96). Here a run's chain axis
is split over processes: rank p owns a contiguous chain range, its
engines key every draw by the GLOBAL chain index (`chain0`), and the
pooled statistics cross the process boundary in a few collectives at the
end of the run (and, for one PT ladder spanning the processes, one gather
per exchange).

The collectives carry host numpy arrays over gloo, as tpu_smc pools host
arrays (multihost_utils.process_allgather): ranks that share one card
cannot use NCCL (it refuses two ranks on one GPU), and what crosses the
boundary is small (per-chain summaries, traces, one ladder's
configurations per exchange).

Every failure is fatal to the whole job: a peer that dies closes its
sockets and the others' next collective raises; a peer that hangs is cut
by the collective timeout; unequal shapes raise on every rank before any
data moves (the hazard that wedges a collective, tpu_smc/cli.py:1777).
"""

from __future__ import annotations

import atexit
import datetime

import numpy as np

# the rendezvous: every rank must reach the coordinator within this
INIT_TIMEOUT_S = 60.0
# one collective: a peer that has not joined it within this is hung
COLLECTIVE_TIMEOUT_S = 300.0


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def check_coordinator(coordinator: str, num_processes: int,
                      process_id: int) -> tuple[str, int]:
    """(host, port) of a HOST:PORT coordinator; ValueError on a malformed
    address or a process id outside [0, num_processes)."""
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"--coordinator {coordinator}: need HOST:PORT")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} outside "
                         f"[0, {num_processes})")
    return host, int(port)


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     timeout: float = INIT_TIMEOUT_S,
                     collective_timeout: float = COLLECTIVE_TIMEOUT_S) -> int:
    """Join the gloo process group of `num_processes` ranks whose rank 0
    serves the rendezvous at `coordinator` (HOST:PORT) and return this
    rank (check_coordinator's errors first). A peer missing after
    `timeout` seconds fails the rendezvous; a collective that waits
    `collective_timeout` seconds raises. The group is destroyed at exit."""
    dist = _dist()
    host, port = check_coordinator(coordinator, num_processes, process_id)
    store = dist.TCPStore(host, port, num_processes,
                          is_master=process_id == 0,
                          timeout=datetime.timedelta(seconds=timeout))
    dist.init_process_group(
        "gloo", store=store, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=collective_timeout))
    atexit.register(_destroy)
    # a first collective: every rank is up before any work starts
    dist.barrier()
    return dist.get_rank()


def _destroy() -> None:
    if is_initialized():
        _dist().destroy_process_group()


def process_count() -> int:
    """Processes of the job (1 without init_distributed)."""
    return _dist().get_world_size() if is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without init_distributed)."""
    return _dist().get_rank() if is_initialized() else 0


def allgather_object(obj) -> list:
    """Every rank's picklable `obj`, in rank order."""
    if not is_initialized():
        return [obj]
    out = [None] * process_count()
    _dist().all_gather_object(out, obj)
    return out


def allgather_chain_axis(x) -> np.ndarray:
    """Concatenate the per-process host arrays along axis 0 in rank
    order, keeping the dtype; every rank receives the whole array. The
    shapes and dtypes are gathered first and must agree (a chain split
    evenly over the processes): otherwise every rank raises, instead of
    one erroring and the others blocking in the collective."""
    import torch

    x = np.ascontiguousarray(x)
    if x.ndim == 0:
        raise ValueError("allgather_chain_axis needs a leading chain axis")
    if not is_initialized():
        return x.copy()
    metas = allgather_object((x.shape, x.dtype.str))
    if any(m != metas[0] for m in metas):
        raise ValueError(f"allgather_chain_axis: per-process shapes/dtypes "
                         f"differ across ranks: {metas}")
    if x.size == 0:
        return np.concatenate([x] * process_count())
    raw = torch.from_numpy(x.reshape(-1).view(np.uint8).copy())
    parts = [torch.empty_like(raw) for _ in range(process_count())]
    _dist().all_gather(parts, raw)
    return np.concatenate([p.numpy().view(x.dtype).reshape(x.shape)
                           for p in parts])


def chain_range(n_chains: int, nproc: int, rank: int) -> tuple[int, int]:
    """(chain0, count): rank's contiguous share of n_chains chains split
    evenly over nproc processes."""
    if n_chains % nproc:
        raise ValueError(f"{n_chains} chains do not divide evenly over "
                         f"{nproc} processes")
    per = n_chains // nproc
    return rank * per, per

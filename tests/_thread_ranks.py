"""A model group of n ranks as n threads of one process, for the port's
sequence- and tensor-parallel tests that need no worker processes.

``ThreadGroup(n)`` stands where a torch.distributed process group stands:
with ``patched(monkeypatch)`` in force, ``torch.distributed.all_reduce``
on such a group sums the n threads' tensors in rank order, and
``get_rank`` / ``get_world_size`` answer for the calling thread.
``run_ranks(group, fn)`` runs ``fn(rank)`` on every rank's thread and
returns the results in rank order; an exception in one thread breaks the
others' barrier and is raised.
"""

from __future__ import annotations

import threading

import torch
import torch.distributed as dist

TIMEOUT_S = 60.0


class ThreadGroup:
    def __init__(self, n: int):
        self.n = n
        self.barrier = threading.Barrier(n, timeout=TIMEOUT_S)
        self.bufs = [None] * n
        self.local = threading.local()

    @property
    def rank(self) -> int:
        return self.local.rank

    def all_reduce(self, t: torch.Tensor) -> None:
        self.bufs[self.rank] = t.clone()
        self.barrier.wait()
        total = self.bufs[0].clone()
        for b in self.bufs[1:]:
            total += b
        self.barrier.wait()
        t.copy_(total)


def patched(monkeypatch) -> None:
    """Route torch.distributed's all_reduce, get_rank and get_world_size to
    a ThreadGroup where one is passed."""
    originals = {k: getattr(dist, k) for k in ("all_reduce", "get_rank", "get_world_size")}

    def all_reduce(t, op=None, group=None, async_op=False):
        if isinstance(group, ThreadGroup):
            return group.all_reduce(t)
        return originals["all_reduce"](t, group=group)

    def get_rank(group=None):
        return group.rank if isinstance(group, ThreadGroup) else originals["get_rank"](group)

    def get_world_size(group=None):
        return group.n if isinstance(group, ThreadGroup) else originals["get_world_size"](group)

    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    monkeypatch.setattr(dist, "get_rank", get_rank)
    monkeypatch.setattr(dist, "get_world_size", get_world_size)


def run_ranks(group: ThreadGroup, fn) -> list:
    """[fn(0), ..., fn(n - 1)], each on its own thread as that rank."""
    out, errors = [None] * group.n, []

    def run(r):
        group.local.rank = r
        try:
            out[r] = fn(r)
        except BaseException as e:     # noqa: BLE001 - re-raised below
            errors.append(e)
            group.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(group.n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(4 * TIMEOUT_S)
    if errors:
        raise errors[0]
    assert not any(t.is_alive() for t in threads), "a rank's thread did not finish"
    return out

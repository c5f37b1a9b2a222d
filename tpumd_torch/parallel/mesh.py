"""The process group a run is decomposed over, and its collectives.

PyTorch counterpart of tpumd/parallel/mesh.py.  tpumd block-shards the
verlet carry over a 1-D ``jax.sharding.Mesh`` and leaves the rest to XLA's
partitioner: on the cell grid the z-rolls become collective-permutes of
one boundary plane, on the matrix engine the positions are all-gathered.
PyTorch has no partitioner, so the port does explicitly what XLA did: a
``Mesh`` holds the process group (``torch.distributed``: NCCL on the
cards, gloo on the CPU), its rank, size and device, and every collective
the run makes goes through it, counted by kind (calls and bytes of
``exchange``, ``all_reduce`` and ``all_gather``), so that the tests and
the chip check can say what a step moved.  ``parallel/decomp.py`` lays the
cell grid and the matrix engine's rows out over it; ``parallel/halo.py``
moves the halos and migrates the atoms.

A world of one without a process group (``Mesh()``) is today's one-card
run: nothing is decomposed and no collective runs.  A process group of
one (``spawn_world(..., 1, ...)``) takes the decomposed path, which then
splits no axis and exchanges no halo.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

KINDS = ("exchange", "all_reduce", "all_gather")


class Counters:
    """Calls and bytes of the mesh's collectives by kind, and, where
    ``timed``, the CUDA events around each exchange (read by
    ``exchange_ms``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.calls = dict.fromkeys(KINDS, 0)
        self.bytes = dict.fromkeys(KINDS, 0)
        self.events: list = []

    def add(self, kind: str, nbytes: int):
        self.calls[kind] += 1
        self.bytes[kind] += int(nbytes)

    def exchange_ms(self) -> float:
        """The card's time in the timed exchanges since the last reset, in
        ms (a synchronize)."""
        if not self.events:
            return 0.0
        torch.cuda.synchronize()
        return float(sum(a.elapsed_time(b) for a, b in self.events))

    def snapshot(self) -> dict:
        return {"calls": dict(self.calls), "bytes": dict(self.bytes)}


@dataclasses.dataclass(eq=False)
class Mesh:
    """A rank of a process group (``distributed``), or a world of one
    without one.  ``device`` is the rank's device: ``cuda:LOCAL_RANK`` on
    the cards, the CPU under gloo."""

    rank: int = 0
    size: int = 1
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cpu"))
    distributed: bool = False
    counters: Counters = dataclasses.field(default_factory=Counters)
    # CUDA events around each exchange (Counters.exchange_ms)
    timed: bool = False

    def _dist(self):
        import torch.distributed as dist
        return dist

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The reduction of t over the ranks (a new tensor): "sum" or
        "max"."""
        if not self.distributed:
            return t
        dist = self._dist()
        out = t.detach().clone().contiguous()
        self.counters.add("all_reduce", out.numel() * out.element_size())
        dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                                 "max": dist.ReduceOp.MAX}[op])
        return out

    def sum_packed(self, *vals):
        """vals (tensors, or None) each summed over the ranks by one
        float64 all-reduce of them packed, each back in its dtype and
        shape: the sums over atoms that a fix's call site reads, of which
        every rank holds its own atoms' share."""
        live = [v for v in vals if v is not None]
        if not self.distributed or not live:
            return vals
        flat = self.all_reduce(torch.cat(
            [v.reshape(-1).to(torch.float64) for v in live]))
        out, k = [], 0
        for v in vals:
            if v is None:
                out.append(None)
                continue
            out.append(flat[k:k + v.numel()].reshape(v.shape).to(v.dtype))
            k += v.numel()
        return tuple(out)

    def agree_max(self, value) -> int:
        """The largest of an int or a () tensor over the ranks, on the
        host: a decision every rank takes alike."""
        t = torch.as_tensor(value, device=self.device).reshape(1).to(
            torch.int64)
        return int(self.all_reduce(t, "max")[0])

    def all_gather_rows(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's t (n_r, ...) rows, the counts n_r free: padded to
        the largest (the counts gathered first) and cut back."""
        if not self.distributed:
            return [t]
        dist = self._dist()
        n = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
        counts = [torch.empty_like(n) for _ in range(self.size)]
        self.counters.add("all_gather", n.numel() * 8 * self.size)
        dist.all_gather(counts, n)
        counts = [int(c[0]) for c in counts]
        width = max(max(counts), 1)
        pad = torch.zeros((width,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        pad[:t.shape[0]] = t
        out = [torch.empty_like(pad) for _ in range(self.size)]
        self.counters.add("all_gather",
                          pad.numel() * pad.element_size() * self.size)
        dist.all_gather(out, pad)
        return [o[:c] for o, c in zip(out, counts)]

    def all_gather_equal(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' t (n, ...), all of one shape, stacked in rank order
        along dim 0: (size n, ...)."""
        out = torch.empty((self.size * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        if not self.distributed:
            out.copy_(t)
            return out
        self.counters.add("all_gather", out.numel() * out.element_size())
        self._dist().all_gather(list(out.chunk(self.size)), t.contiguous())
        return out

    def exchange(self, sends, recvs):
        """Point-to-point messages of one round: sends [(peer, tensor,
        tag)], recvs [(peer, tensor, tag)] (written in place), posted
        together (``batch_isend_irecv``) and waited for.  Two messages
        between one pair of ranks are told apart by their tags (gloo) and
        matched in the order posted (NCCL): every caller posts them in one
        order."""
        if not sends and not recvs:
            return
        dist = self._dist()
        nbytes = sum(t.numel() * t.element_size() for _, t, _ in sends)
        self.counters.add("exchange", nbytes)
        ev = None
        if self.timed and self.device.type == "cuda":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        ops = ([dist.P2POp(dist.isend, t.contiguous(), peer, tag=tag)
                for peer, t, tag in sends]
               + [dist.P2POp(dist.irecv, t, peer, tag=tag)
                  for peer, t, tag in recvs])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if ev is not None:
            ev[1].record()
            self.counters.events.append(ev)


def make_mesh(device=None) -> Mesh:
    """The mesh of this process: from torchrun's environment (WORLD_SIZE,
    RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) where WORLD_SIZE is above 1
    or a process group is already up, NCCL on ``cuda:LOCAL_RANK`` for a
    CUDA device and gloo on the CPU; else a world of one.  The
    counterpart of tpumd's ``make_mesh(n)``: a process group has its
    size, and ``GridDecomp.shard``/``unshard`` (``parallel/decomp.py``)
    do what its ``shard_carry`` and ``jax.device_get`` of the carry do."""
    import torch.distributed as dist
    dev = torch.device("cuda" if device is None else device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if not dist.is_initialized() and world <= 1:
        return Mesh(device=dev)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
    return Mesh(rank=dist.get_rank(), size=dist.get_world_size(),
                device=dev, distributed=True)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def block_bounds(n: int, parts: int) -> np.ndarray:
    """(parts + 1,) bounds of n items split into parts contiguous blocks
    at n k // parts (every block non-empty where n >= parts)."""
    return np.array([n * k // parts for k in range(parts + 1)])

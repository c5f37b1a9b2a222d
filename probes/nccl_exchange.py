"""The halo exchange of lj864's z-slab layout alone, over NCCL across
every card of the host: ``GridHalo.fill`` of one rank's local grid
(35x35x35 cells of cap 36 cut into as many slabs as cards) and, beside
it, an all-reduce of the same 1.06 MB, each timed by CUDA events and the
host clock over 50 calls after 10, the ranks in step (a barrier first).

Run from the repository root on a host with several cards: ``env
NCCL_DEBUG=INFO NCCL_DEBUG_SUBSYS=INIT,P2P NCCL_DEBUG_FILE=nccl.%h.%p.log
python3 probes/nccl_exchange.py`` prints each rank's (card ms, host ms) a
call; the NCCL logs name the transport of each channel ("via
P2P/CUMEM").
"""

import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def work(mesh):
    import torch
    import torch.distributed as dist
    from tpumd_torch.ops.cellgrid import CellGridConfig
    from tpumd_torch.parallel.decomp import GridLayout
    from tpumd_torch.parallel.halo import GridHalo
    cfg = CellGridConfig(cutneigh=2.8, skin=0.3, nx=35, ny=35, nz=35, cap=36)
    lay = GridLayout(cfg, mesh.size, 1, mesh.rank)
    halo = GridHalo(lay, mesh)
    x = torch.randn((lay.local_cfg.capacity, 3), device=mesh.device)
    plane = lay.local_cfg.ny * lay.local_cfg.nx * lay.local_cfg.cap * 3
    out = {}
    for name, fn in (("fill", lambda: halo.fill(x)),
                     ("all_reduce", lambda: mesh.all_reduce(
                         x[:2 * plane // 3].reshape(-1), "sum"))):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        dist.barrier()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        for _ in range(50):
            fn()
        e1.record()
        torch.cuda.synchronize()
        out[name] = (e0.elapsed_time(e1) / 50,
                     (time.perf_counter() - t0) * 1e3 / 50)
    return out


def main():
    import torch
    from tpumd_torch.parallel.launch import spawn_world
    print(f"cards {torch.cuda.device_count()}", flush=True)
    with tempfile.TemporaryDirectory() as d:
        ranks = spawn_world(work, torch.cuda.device_count(), "nccl",
                            Path(d) / "pg")
    for r, o in enumerate(ranks):
        print(f"rank {r}", {k: (round(a, 4), round(b, 4))
                            for k, (a, b) in o.items()}, flush=True)


if __name__ == "__main__":
    main()

"""Where a world of one over NCCL loses time against the one-card run on
lj864 (bench/in.lj with x, y, z 3: 864,000 atoms, f32).

Run from the repository root on a host with a card:
``python3 probes/decomp_one_rank.py``.  It builds the kernels, opens a
process group of one (NCCL, a file rendezvous) and sets lj864 up four
times in this process: one card, world of one, world of one, one card.
Each run takes ``run 100`` to warm up, then ``run 100`` timed (the run's
loop time, as ``chip_smoke.py``'s ``decomp_path`` times it), 100 steps
of ``run_segment`` alone (no thermo row, no flag read; its re-bins
included), the 19 steps between two re-bins alone, 10 re-bins alone
(``rebuild_now``) and ``run 100`` under ``torch.profiler`` (the run's
end included, where a world of one gathers the state back).  It prints each run's figures, then, for the
first pair, the device kernels and the host calls whose count or time
differ between the two by more than a tenth of a count or 5 us a step
(the CUDA runtime's synchronizing calls among them).
"""

import json
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

STEPS = 100
REBINS = 10


def profiled(script, steps):
    """(device us by kernel, device count by kernel, host count by call,
    host us by call) of ``run steps`` under the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        script.run_string(f"run {steps}")
        torch.cuda.synchronize()
    dev_us, dev_n, host_n, host_us = Counter(), Counter(), Counter(), \
        Counter()
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            dev_us[ev.key] += ev.self_device_time_total
            dev_n[ev.key] += ev.count
        else:
            host_n[ev.key] += ev.count
            host_us[ev.key] += ev.self_cpu_time_total
    return dev_us, dev_n, host_n, host_us


def one_run(mesh, label):
    import torch
    from tpumd_torch.bench_targets import IN_LJ_BENCH
    from tpumd_torch.md.verlet import rebuild_now, run_segment
    from tpumd_torch.script.parser import LammpsScript
    script = LammpsScript(device="cuda", dtype=torch.float32, mesh=mesh,
                          var_overrides={"x": 3, "y": 3, "z": 3})
    script.run_string(IN_LJ_BENCH.rsplit("\nrun", 1)[0])
    sim = script.sim
    sim.verbose = False
    script.run_string(f"run {STEPS}")
    t0 = sim.loop_time
    script.run_string(f"run {STEPS}")
    run_ms = (sim.loop_time - t0) * 1e3 / STEPS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_segment(*sim._carry, sim._ctx, STEPS, step0=sim.step)
    torch.cuda.synchronize()
    seg_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    # the steps between two re-bins alone (the run stands at one)
    s, neigh, fs = sim._carry
    every = sim._ctx.neigh_cfg.every
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_segment(s, neigh, fs, sim._ctx, every - 1, step0=sim.step)
    torch.cuda.synchronize()
    between_ms = (time.perf_counter() - t0) * 1e3 / (every - 1)
    if int(out[1].nbuilds) != int(neigh.nbuilds):
        raise AssertionError("a re-bin between the re-bins")
    # the re-bin alone, REBINS times from the same carry
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REBINS):
        rebuild_now(s, neigh, sim._ctx)
    torch.cuda.synchronize()
    rebin_ms = (time.perf_counter() - t0) * 1e3 / REBINS
    del out, s, neigh, fs
    unshard_ms = None
    if sim.decomposed:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim._ctx.decomp.unshard(*sim._carry[:2])
        torch.cuda.synchronize()
        unshard_ms = (time.perf_counter() - t0) * 1e3
    prof = profiled(script, STEPS)
    dev_ms = sum(prof[0].values()) / 1e3 / STEPS
    out = {"run": label, "run_ms_a_step": run_ms,
           "timesteps_s": 1e3 / run_ms, "segment_ms_a_step": seg_ms,
           "between_rebins_ms_a_step": between_ms, "rebin_ms": rebin_ms,
           "device_busy_ms_a_step": dev_ms,
           "device_ops_a_step": sum(prof[1].values()) / STEPS,
           "rebuilds": int(sim._carry[1].nbuilds),
           "run_end_gather_ms": unshard_ms}
    print(json.dumps(out), flush=True)
    del script, sim
    torch.cuda.empty_cache()
    return out, prof


def diff(name, a, b, scale, floor):
    """Lines of the keys whose per-step a and b differ by floor or more."""
    lines = []
    for k in sorted(set(a) | set(b)):
        x, y = a.get(k, 0) / scale, b.get(k, 0) / scale
        if abs(x - y) >= floor:
            lines.append(f"  {name} {k[:70]}: one card {x:.3f}, world of "
                         f"one {y:.3f} a step")
    return lines


def main():
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    from tpumd_torch.ops import _build
    from tpumd_torch.parallel.mesh import Mesh
    smi = cs.environment()
    _build.load()
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/pg",
                                rank=0, world_size=1)
        world = Mesh(rank=0, size=1, device=torch.device("cuda", 0),
                     distributed=True)
        runs = [one_run(m, label) for m, label in (
            (None, "one card"), (world, "world of one"),
            (world, "world of one"), (None, "one card"))]
        dist.destroy_process_group()
    (_, a), (_, b) = runs[0], runs[1]
    print(f"the first pair's differences ({smi}):")
    for line in (diff("device us", a[0], b[0], STEPS, 5.0)
                 + diff("device ops", a[1], b[1], STEPS, 0.1)
                 + diff("host calls", a[2], b[2], STEPS, 0.1)
                 + diff("host us", a[3], b[3], STEPS, 5.0)):
        print(line, flush=True)


if __name__ == "__main__":
    main()

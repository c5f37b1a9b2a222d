#!/usr/bin/env python3
"""Chip check of the tpumd_torch port on one CUDA card.

Run from the repository root: ``python3 chip_smoke.py``.  Phases, one
line each (any failure raises and exits non-zero):

1. environment: card name and power limit (nvidia-smi), torch, CUDA, nvcc;
2. build: nvcc builds tpumd_torch/csrc into build/ (or loads the cache);
3. kernel against plain version on the card: the LJ cell-grid kernel and
   its plain PyTorch version on perturbed fcc lattices at the 32k in.lj
   grid (11^3 cells, cap 40) and the 864-atom grid (3^3, cap 52), f32 and
   f64, energy/virial on and off; timed at the 32k shape;
4. main path: the 6^3 deck on the card against the CPU (f64, step 40),
   then the 32k in.lj deck through LammpsScript on the card in f32:
   step-0 and step-100 gates, 500 warm-up and 500 timed steps, and the
   kernel launch counts of that run;
5. a JSON line of the kernels, then the result line.

Imports nothing of JAX or tpumd.
"""

from __future__ import annotations

import importlib.metadata
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

# |kernel - plain| <= TOL * max|f| (forces) or TOL * |value| (energy),
# TOL * max|virial component| (virial).  f64 differs by summation order
# only; f32 also by the order of ~1,000 f32 terms per slot (the f32 Pallas
# kernel sat at 1.2e-5 of max|f| against f64).
TOL = {torch.float64: 1e-12, torch.float32: 5e-5}


def phase(name: str, msg: str):
    print(f"[{name}] {msg}", flush=True)


def run_cmd(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def environment() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()[0]
    from tpumd_torch.ops._build import _nvcc
    nvcc = run_cmd([_nvcc(), "--version"]).splitlines()[-1]
    try:
        triton = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton = "absent"
    phase("env", f"{smi} | torch {torch.__version__} | cuda "
                 f"{torch.version.cuda} | {nvcc} | triton {triton}")
    return smi


def perturbed_grid(nlat: int, seed: int, device, dtype):
    """Slot-ordered positions and validity of an fcc in.lj lattice of
    nlat^3 cells, each atom moved by up to +-0.05 sigma per axis."""
    from tpumd_torch.core.create import create_atoms_lattice
    from tpumd_torch.core.lattice import Lattice
    from tpumd_torch.core.state import Box, make_state, wrap_pbc
    from tpumd_torch.ops import cellgrid as cg
    lat = Lattice("fcc", 0.8442)
    hi = nlat * lat.spacing
    x, t = create_atoms_lattice(lat, None, np.zeros(3), hi)
    x = x + np.random.default_rng(seed).uniform(-0.05, 0.05, x.shape)
    box = Box.orthogonal(np.zeros(3), hi, device=device, dtype=dtype)
    s = wrap_pbc(make_state(x, np.zeros_like(x), t, box, device=device,
                            dtype=dtype))
    cfg = cg.choose_cellgrid_config(box, 2.8, 0.3, len(x))
    s = cg.pad_state(s, cfg.capacity)
    valid0 = torch.arange(cfg.capacity, device=device) < len(x)
    perm, valid, _, over = cg.bin_permutation(s.x, valid0, s.box, cfg)
    if bool(over):
        raise AssertionError("cell overflow in the test lattice")
    return cg.apply_permutation(s, perm, valid).x, valid, box, cfg


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def kernel_vs_plain() -> dict:
    from tpumd_torch.ops.lj_cellgrid import LJCoeffs, lj_cellgrid, \
        lj_cellgrid_plain
    c = LJCoeffs(48.0, 24.0, 4.0, 4.0, 0.0, 6.25)
    out = {}
    for nlat in (20, 6):
        for dtype in (torch.float32, torch.float64):
            x, valid, box, cfg = perturbed_grid(nlat, 7 + nlat, "cuda", dtype)
            tol = TOL[dtype]
            worst = 0.0
            for eflag, vflag in ((0, 0), (1, 1), (1, 0), (0, 1)):
                fk, ek, wk = lj_cellgrid(x, valid, box, cfg, c, eflag, vflag)
                fp, ep, wp = lj_cellgrid_plain(x, valid, box, cfg, c, eflag,
                                               vflag)
                torch.cuda.synchronize()
                if not torch.isfinite(fk).all():
                    raise AssertionError("kernel forces not finite")
                fmax = float(fp.abs().max())
                err = float((fk - fp).abs().max())
                worst = max(worst, err / fmax)
                if err > tol * fmax:
                    raise AssertionError(
                        f"forces {nlat}^3 {dtype} e{eflag}v{vflag}: "
                        f"{err} > {tol} * {fmax}")
                if eflag and abs(float(ek - ep)) > tol * abs(float(ep)):
                    raise AssertionError(f"energy {float(ek)} vs {float(ep)}")
                if vflag and float((wk - wp).abs().max()) > \
                        tol * float(wp.abs().max()):
                    raise AssertionError(f"virial {wk.tolist()} vs "
                                         f"{wp.tolist()}")
            phase("kernel", f"grid {cfg.nx}x{cfg.ny}x{cfg.nz} cap {cfg.cap} "
                            f"{str(dtype)[6:]}: max|f_kernel - f_plain| = "
                            f"{worst:.3g} max|f| (tol {tol:g}), energy and "
                            f"virial within tol")
            if nlat == 20 and dtype == torch.float32:
                fk, _, _ = lj_cellgrid(x, valid, box, cfg, c, 0, 0)
                fp, _, _ = lj_cellgrid_plain(x, valid, box, cfg, c, 0, 0)
                out["max_abs_err"] = float((fk - fp).abs().max())
                # plain, kernel, kernel, plain
                p1 = cuda_ms(lambda: lj_cellgrid_plain(x, valid, box, cfg, c,
                                                       0, 0), 10)
                k1 = cuda_ms(lambda: lj_cellgrid(x, valid, box, cfg, c, 0, 0),
                             200)
                k2 = cuda_ms(lambda: lj_cellgrid(x, valid, box, cfg, c, 0, 0),
                             200)
                p2 = cuda_ms(lambda: lj_cellgrid_plain(x, valid, box, cfg, c,
                                                       0, 0), 10)
                ke = cuda_ms(lambda: lj_cellgrid(x, valid, box, cfg, c, 1, 1),
                             200)
                out["ms"] = min(k1, k2)
                out["plain_ms"] = min(p1, p2)
                phase("kernel", f"32k shape f32 forces: kernel {k1:.4f} / "
                                f"{k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms; "
                                f"kernel with energy+virial {ke:.4f} ms")
    return out


def small_deck_card_vs_cpu():
    """The 6^3 deck to step 40 (two rebuilds) on the card and on the CPU,
    f64: thermo agrees to 1e-10 relative."""
    from tpumd_torch.bench_targets import IN_LJ
    from tpumd_torch.script.parser import LammpsScript
    rows = {}
    for dev in ("cuda", "cpu"):
        script = LammpsScript(device=dev, dtype=torch.float64)
        script.run_string(IN_LJ.format(n=6))
        script.sim.verbose = False
        script.run_string("run 40")
        rows[dev] = script.sim.last_thermo
    for k in ("temp", "epair", "etotal", "press"):
        a, b = rows["cuda"][k], rows["cpu"][k]
        if not abs(a - b) <= 1e-10 * abs(b):
            raise AssertionError(f"6^3 deck step 40 {k}: card {a} cpu {b}")
    phase("main", f"6^3 deck f64 step 40 card = cpu to 1e-10: "
                  f"etotal {rows['cuda']['etotal']!r}")


def main_path(smi: str) -> dict:
    from tpumd_torch.bench_targets import IN_LJ, SANITY, STEP0, STEP0_RTOL, \
        gate_failures
    from tpumd_torch.ops.lj_cellgrid import counts
    from tpumd_torch.script.parser import LammpsScript

    counts.reset()
    t0 = time.perf_counter()
    script = LammpsScript(device="cuda", dtype=torch.float32)
    script.run_string(IN_LJ.format(n=20))
    sim = script.sim
    sim.verbose = False
    script.run_string("run 0")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    bad = gate_failures(sim.last_thermo, {
        k: (v, STEP0_RTOL) for k, v in STEP0["lj"].items()})
    if bad:
        raise AssertionError(f"step-0 gate: {bad}")
    script.run_string("run 100")
    row100 = dict(sim.last_thermo)
    bad = gate_failures(row100, SANITY["lj"])
    if bad:
        raise AssertionError(f"step-100 gate: {bad}")
    script.run_string("run 500")
    lt0 = sim.loop_time
    script.run_string("run 500")
    dt = sim.loop_time - lt0
    launches, plain = counts.kernel_launches, counts.plain_calls
    # setup evaluates once; each run of n > 0 steps with thermo 0 is one
    # segment: n in-step evaluations plus one energy evaluation
    force_evals = 1 + (100 + 1) + 2 * (500 + 1)
    if launches < force_evals or plain != 0:
        raise AssertionError(f"kernel launches {launches} < force "
                             f"evaluations {force_evals}, or plain calls "
                             f"{plain} != 0")
    s = sim.state
    if (tuple(s.x.shape) != (sim._neigh_cfg.capacity, 3)
            or not torch.isfinite(s.x).all()
            or sorted(s.tag[s.tag > 0].tolist()) != list(range(1, 32001))):
        raise AssertionError("final state malformed")
    sps = 500 / dt
    phase("main", f"32k in.lj f32: set-up {setup_s:.3f} s (deck, grid, "
                  f"first forces; library already loaded), step 0 "
                  f"and step 100 gates pass (step 100 temp "
                  f"{row100['temp']!r} epair {row100['epair']!r} etotal "
                  f"{row100['etotal']!r}); step 1200 etotal "
                  f"{sim.last_thermo['etotal']!r}")
    phase("main", f"timed 500 steps: {sps:.2f} timesteps/s, "
                  f"{sps * 32000 / 1e6:.3f} Matom-step/s on {smi}; kernel "
                  f"launches {launches} >= force evaluations {force_evals}, "
                  f"plain calls {plain}")
    return {"launches": launches}


def main():
    smi = environment()
    from tpumd_torch.ops import _build
    lib = _build.load()
    log = lib.ptxas_log
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores", log)
    phase("build", f"{'cached' if lib.cached else 'cold'} "
                   f"{lib.seconds:.2f} s -> {lib.path.name}; ptxas: "
                   f"registers {'/'.join(regs) or 'n/a'}, spill stores "
                   f"{'/'.join(spills) or 'n/a'} bytes")
    k = kernel_vs_plain()
    small_deck_card_vs_cpu()
    m = main_path(smi)
    print(json.dumps({"kernels": [{
        "name": "lj_cellgrid", "route": "cuda",
        "source": "tpumd_torch/csrc/lj_cellgrid.cu",
        "replaces": "tpumd/ops/pallas_lj.py:25",
        "launches": m["launches"], "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

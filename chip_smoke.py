#!/usr/bin/env python3
"""Chip check of the tpumd_torch port on one CUDA card.

Run from the repository root: ``python3 chip_smoke.py``.  Phases, one
line each (any failure raises and exits non-zero):

1. environment: card name and power limit (nvidia-smi), torch, CUDA, nvcc;
2. build: one nvcc per source of tpumd_torch/csrc, all at once, into
   build/ (or the cached library);
3. kernels against their plain versions on the card, f32 and f64, every
   energy/virial flag combination:
   - LJ (B1) on perturbed fcc lattices at the 32k in.lj grid (11^3 cells,
     cap 40) and the 864-atom grid (3^3, cap 52);
   - LJ+FENE (B2) on the generated chain decks' grids after setup: the 32k
     chain grid (11^3, cap 40) and a 2^3 grid where bonds count at the
     minimum image;
   each timed at its 32k shape in the order plain, kernel, kernel, plain,
   beside its bound (the larger of this input's in-range pair arithmetic
   over the f32 peak and its bytes over the memory rate);
4. main path, in.lj: the 6^3 deck on the card against the CPU (f64, step
   40), then the 32k deck through LammpsScript in f32: step-0 and step-100
   gates, 500 warm-up and 500 timed steps, the launch counts of that run
   and a profile of 100 steps;
5. main path, chain: a 500-atom chain deck on the card against the CPU (f64,
   RanMars langevin on both, step 40), then the 32k chain deck in f32 with
   the device RNG: step-0 and step-100 gates, 500 warm-up and 500 timed
   steps, the launch counts of that run, the cost of the per-step rebuild
   check and a profile of 100 steps;
6. main path, eam: the EAM density (B3) and force (B4) kernels against
   their plain versions on perturbed fcc lattices of the generated Cu-like
   potential at the 32k in.eam grid (12^3, cap 32) and a 2^3 grid, f32 and
   f64, every flag combination, each timed at its 32k shape beside its
   bound; a 500-atom eam deck on the card against the CPU (f64, step 40);
   then the 32k in.eam deck through LammpsScript in f32: step-0 and
   step-100 gates, 500 warm-up and 500 timed steps, the launch counts of
   that run and a profile of 100 steps;
7. main path, rhodo_class: the lj/charmm/coul/long kernel (B5) against
   its plain version on the card, f32 and f64, every flag combination, on
   the 32k rhodo_class grid and the 2^3 peptide grid after set-up, timed
   at the 32k shape with and without energy beside its bound, with its
   registers and spills; the 2,004-atom peptide with the rhodo_class
   settings on the card against the CPU (f64, step 40); then the 32,064-
   atom deck through LammpsScript in f32: the reference binary's step-0
   and step-100 gates, the PPPM mesh, 500 warm-up and 500 timed steps, the
   launch counts of that run and a profile of 100 steps;
8. main path, chute: the gran/hooke/history kernel (B6) against its
   plain version on the card, f32 and f64, both shearupdate values, on the
   32k chute grid after set-up and 10 steps and on a generated pack's grid
   with a 2-cell periodic axis (5x2x3), the history as it is and scaled
   by 40 (slipping contacts); timed at the 32k shape in the order plain,
   kernel, kernel, plain beside its bound, with its registers and spills;
   a 480-sphere chute deck on the card against the CPU (f64, step 40);
   then the 32,000-sphere deck through LammpsScript in f32: step-0 and
   step-100 gates, 500 warm-up and 500 timed steps, the launch counts of
   that run and a profile of 100 steps;
9. the matrix neighbor engine: the row gather (P1) against its plain
   version on the card, bit for bit, for f32, f64 and int32 tables of
   widths 1, 5, 12, 16 and 128 up to the last row and at the 32k matrix
   decks' widths and index shapes, then timed at the
   gather probe's shapes (a 32,768 x L f32 table, 524,288 rows, L = 128
   and 16) in the order plain, kernel, kernel, plain, beside its bound and
   torch.index_select; the 6^3 in.lj deck and the 480-sphere chute pack on
   the matrix engine, card against CPU (f64, step 40); small_box (periodic
   images) and tri_lj (a triclinic box) on the card against the reference
   binary's logs; then the 32k in.lj and chute decks through LammpsScript
   with neighbor_mode "matrix" in f32 (P1 bit-equal to its plain
   version on every kind of input their set-up gave it): step-0 and
   step-100 gates, 500
   warm-up and 500 timed steps beside the cell grid's figure of this
   call, P1's launch counts of those runs and a profile of 100 steps;
10. a JSON line of the kernels, the card's name and power limit as
   nvidia-smi prints them, then the result line.

Imports nothing of JAX or tpumd.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.metadata
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# |kernel - plain| <= TOL * max|f| (forces) or TOL * |value| (energy),
# TOL * max|virial component| (virial).  f64 differs by summation order
# only; f32 also by the order of ~1,000 f32 terms per slot (the f32 Pallas
# kernel sat at 1.2e-5 of max|f| against f64).
TOL = {torch.float64: 1e-12, torch.float32: 5e-5}

# published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
# cores, and the HBM3 memory rate
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# least arithmetic per in-range pair, from the kernels' loops, counted
# once per unordered pair (the force on j is minus the force on i): d (3),
# r2 (5), cutoff test (1), 1/r2 (1), r^-6 (2), fpair (4); a bonded pair: d
# and r2 (8), 1/r2 (1), the FENE log argument, clamp and quotient (5), the
# WCA test and term (10); then f += d fpair on each of its two atoms (2 x 6)
OPS_LJ_PAIR = 16
OPS_BOND_PAIR = 24
OPS_ACCUM = 12
# an in-range EAM pair, from eam_cellgrid.cu's loops: d and r2 (8), cutoff
# test (1), sqrt (1), the spline row (p = r / dr + 1, clamps, fraction: 7);
# the density pass adds rho(r) by Horner (6) and accumulates it on both
# atoms (2); the force pass evaluates rho'(r), z2(r), z2'(r) (4 + 6 + 4),
# 1/r, phi, phi' (5), psip and fpair (5), then f += d fpair on both atoms
# (OPS_ACCUM).  Per atom, the density pass finds F'(rho): the row (7) and
# the derivative (4).
OPS_EAM_RHO_PAIR = 8 + 1 + 1 + 7 + 6 + 2
OPS_EAM_FORCE_PAIR = 8 + 1 + 1 + 7 + 14 + 5 + 5 + OPS_ACCUM
OPS_EAM_EMBED = 7 + 4
# an in-range lj/charmm/coul/long pair, from charmm_cellgrid.cu's loop:
# every such pair d and r2 (8), the cutoff test (1), 1/r2 (1), fpair from
# both terms (3) and f += d fpair on both atoms (OPS_ACCUM); within the
# Coulomb cutoff sqrt, g r, the exponent and exp (5), the polynomial's
# argument and reciprocal (3), the polynomial (9) and its factor (1), the
# prefactor (3), the force's erfc and Gaussian terms (4) and the exclusion
# term (3); within the LJ cutoff r^-6 (2), the force (3) and its weight
# (1); between the inner and outer LJ cutoffs the switch (18).  The walk
# over the special list compares integers and is not counted.
OPS_CHARMM_PAIR = 8 + 1 + 1 + 3 + OPS_ACCUM
OPS_CHARMM_COUL = 5 + 3 + 9 + 1 + 3 + 4 + 3
OPS_CHARMM_LJ = 2 + 3 + 1
OPS_CHARMM_SWITCH = 18
# a gran/hooke/history contact, from gran_cellgrid.cu's loop, counted once
# per unordered pair (the force on j is minus the force on i): d, r2 and
# the contact test (11), sqrt, 1/r and 1/r2 (3), the relative velocity and
# its normal and tangential parts (15), the rotational part (9), the
# effective mass (3), the normal damping and force (7), the tangential
# relative velocity (12), the shear's advance, length and rotation (24),
# the tangential force and its length (19), the Coulomb limit and test (4),
# the rescale of force and shear (19), f += on both atoms (OPS_ACCUM) and
# the torque: d x fs, 1/r, and radius and sum on each atom (24).  The
# history's tag match compares integers and is not counted.
OPS_GRAN_PAIR = 11 + 3 + 15 + 9 + 3 + 7 + 12 + 24 + 19 + 4 + 19 + \
    OPS_ACCUM + 24
GOLDEN = Path(__file__).resolve().parent / "tests" / "golden" / "peptide"


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


def perturbed_grid(nlat: int, seed: int, device, dtype, eam=False):
    """Slot-ordered positions and validity of an fcc lattice of nlat^3
    cells: in.lj's, each atom moved by up to +-0.05 sigma per axis, or with
    eam in.eam's (3.615 A, cutneigh 5.95 A), moved by up to +-0.15 A."""
    from tpumd_torch.core.create import create_atoms_lattice
    from tpumd_torch.core.lattice import Lattice
    from tpumd_torch.core.state import Box, make_state, wrap_pbc
    from tpumd_torch.ops import cellgrid as cg
    lat, amp, cutneigh, skin = ((Lattice("fcc", 3.615, units="metal"), 0.15,
                                 5.95, 1.0) if eam else
                                (Lattice("fcc", 0.8442), 0.05, 2.8, 0.3))
    hi = nlat * lat.spacing
    x, t = create_atoms_lattice(lat, None, np.zeros(3), hi)
    x = x + np.random.default_rng(seed).uniform(-amp, amp, x.shape)
    box = Box.orthogonal(np.zeros(3), hi, device=device, dtype=dtype)
    s = wrap_pbc(make_state(x, np.zeros_like(x), t, box, device=device,
                            dtype=dtype))
    cfg = cg.choose_cellgrid_config(box, cutneigh, skin, len(x))
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


def pair_counts(x, valid, box, cfg, cutsq, tag=None, bond_tags=None):
    """(in-cutoff non-bonded pairs, bonded pairs) of these inputs,
    unordered, counted with the plain sweep in f64 (its sums take 1/2 per
    ordered pair)."""
    from tpumd_torch.ops.cellgrid import cellgrid_pair_sums

    def inside(r2, ti, tj):
        return torch.zeros_like(r2), (r2 < cutsq).to(r2.dtype)

    def bonded(r2, btype):
        return torch.zeros_like(r2), torch.ones_like(r2)
    bond = None if bond_tags is None else (
        bond_tags, torch.ones_like(bond_tags), bonded, tag)
    out = cellgrid_pair_sums(x.double(), None, valid, box_f64(box), cfg,
                             inside, True, False, bond=bond)
    nb = 0 if bond is None else round(float(out[3]))
    return round(float(out[1])), nb


def warp_rows(x, valid, box, cfg, cutsq) -> tuple[int, int]:
    """(candidate rows, rows in range) of the cell-grid kernels' loop: a
    row is one j slot against every i slot of a cell, one loop iteration
    of the cell's warp where cap <= 32.  It has work where j and some i of
    the cell are valid, and takes the in-range path, on every lane, where
    some pair of it lies within the cutoff."""
    from tpumd_torch.ops.cellgrid import stencil_blocks
    rows = hits = 0
    for _, _, r2, mask, _ in stencil_blocks(x.double(), valid,
                                            box_f64(box), cfg):
        rows += int(mask.any(dim=-2).sum())
        hits += int((mask & (r2 < cutsq)).any(dim=-2).sum())
    return rows, hits


def box_f64(box):
    from tpumd_torch.core.state import Box
    return Box(lo=box.lo.double(), hi=box.hi.double())


def roof(ops: int, nbytes: int) -> tuple[float, str]:
    """Least time (ms) the card could take: ops over the f32 peak, or
    the bytes read and written once over the memory rate, whichever is
    larger."""
    t_ops = ops / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def bound(nlj: int, nbond: int, nbytes: int) -> tuple[float, str]:
    """roof() of nlj non-bonded and nbond bonded unordered pairs."""
    return roof(nlj * (OPS_LJ_PAIR + OPS_ACCUM)
                + nbond * (OPS_BOND_PAIR + OPS_ACCUM), nbytes)


def check_close(what, fk, fp, ek, ep, wk, wp, tol, eflag, vflag):
    """Raise unless the kernel's forces, energies and virial agree with
    the plain version's; returns max|df| / max|f|."""
    torch.cuda.synchronize()
    if not torch.isfinite(fk).all():
        raise AssertionError(f"{what}: kernel forces not finite")
    fmax = float(fp.abs().max())
    err = float((fk - fp).abs().max())
    if err > tol * fmax:
        raise AssertionError(f"{what} forces: {err} > {tol} * {fmax}")
    if eflag:
        for a, b in zip(ek, ep):
            if abs(float(a - b)) > tol * abs(float(b)):
                raise AssertionError(f"{what} energy {float(a)} vs "
                                     f"{float(b)}")
    if vflag and float((wk - wp).abs().max()) > tol * float(wp.abs().max()):
        raise AssertionError(f"{what} virial {wk.tolist()} vs "
                             f"{wp.tolist()}")
    return err / fmax


def time_kernel(name, kernel, plain, kernel_ev, reps=200) -> dict:
    """plain, kernel, kernel, plain; then the kernel with energy+virial."""
    p1 = cuda_ms(plain, 10)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, 10)
    ke = cuda_ms(kernel_ev, reps)
    phase("kernel", f"{name} at the 32k shape, f32 forces: kernel {k1:.4f} "
                    f"/ {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms; kernel "
                    f"with energy+virial {ke:.4f} ms")
    return {"ms": min(k1, k2), "plain_ms": min(p1, p2), "ev_ms": ke}


def lj_kernel_vs_plain() -> dict:
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
                worst = max(worst, check_close(
                    f"lj {nlat}^3 {dtype} e{eflag}v{vflag}", fk, fp, (ek,),
                    (ep,), wk, wp, tol, eflag, vflag))
            phase("kernel", f"lj_cellgrid grid {cfg.nx}x{cfg.ny}x{cfg.nz} "
                            f"cap {cfg.cap} {str(dtype)[6:]}: max|f_kernel "
                            f"- f_plain| = {worst:.3g} max|f| (tol {tol:g}),"
                            f" energy and virial within tol")
            if nlat == 20 and dtype == torch.float32:
                fk, _, _ = lj_cellgrid(x, valid, box, cfg, c, 0, 0)
                fp, _, _ = lj_cellgrid_plain(x, valid, box, cfg, c, 0, 0)
                out["max_abs_err"] = float((fk - fp).abs().max())
                out.update(time_kernel(
                    "lj_cellgrid",
                    lambda: lj_cellgrid(x, valid, box, cfg, c, 0, 0),
                    lambda: lj_cellgrid_plain(x, valid, box, cfg, c, 0, 0),
                    lambda: lj_cellgrid(x, valid, box, cfg, c, 1, 1)))
                nlj, _ = pair_counts(x, valid, box, cfg, c.cutsq)
                np_ = cfg.capacity
                nbytes = np_ * (12 + 1 + 12) + 12
                out["bound_ms"], out["bound_by"] = bound(nlj, 0, nbytes)
                phase("kernel", f"lj_cellgrid bound: {nlj} unordered "
                                f"in-cutoff pairs ({2 * nlj} of "
                                f"{np_ * 27 * cfg.cap} candidates (i, j)), "
                                f"{nbytes} bytes -> {out['bound_ms']:.6f} "
                                f"ms ({out['bound_by']})")
    return out


def chain_setup(tmp: Path, natoms: int, chain_len: int, device, dtype,
                thermo: int = 100):
    """LammpsScript of the chain deck on a generated data file, verbose
    off, before its first run."""
    from tpumd_torch.bench_targets import IN_CHAIN, chain_data
    from tpumd_torch.script.parser import LammpsScript
    path = tmp / f"data.chain.{natoms}"
    if not path.exists():
        chain_data(path, natoms, chain_len)
    script = LammpsScript(device=device, dtype=dtype)
    script.run_string(IN_CHAIN.format(data=path).replace(
        "thermo          100", f"thermo          {thermo}"))
    script.sim.verbose = False
    return script


def fene_kernel_vs_plain(tmp: Path) -> dict:
    from tpumd_torch.core.state import Box
    from tpumd_torch.ops.lj_fene_cellgrid import lj_fene_cellgrid, \
        lj_fene_cellgrid_plain
    out = {}
    for natoms, chain_len in ((32000, 100), (60, 10)):
        script = chain_setup(tmp, natoms, chain_len, "cuda", torch.float64)
        script.run_string("run 0")
        sim = script.sim
        s, neigh, _ = sim._carry
        cfg, valid, tag, btags = sim._neigh_cfg, neigh.valid, s.tag, \
            s.bond_tags
        lj, fene = sim.pair.kernel_coeffs(), sim._ctx.kernel_bond \
            .kernel_coeffs()
        for dtype in (torch.float32, torch.float64):
            x = s.x.to(dtype)
            box = Box(lo=s.box.lo.to(dtype), hi=s.box.hi.to(dtype))
            tol = TOL[dtype]
            worst = 0.0
            for eflag, vflag in ((0, 0), (1, 1), (1, 0), (0, 1)):
                fk, ek, wk, bk = lj_fene_cellgrid(x, valid, tag, btags, box,
                                                  cfg, lj, fene, eflag, vflag)
                fp, ep, wp, bp = lj_fene_cellgrid_plain(
                    x, valid, tag, btags, box, cfg, lj, fene, eflag, vflag)
                worst = max(worst, check_close(
                    f"lj_fene {natoms} {dtype} e{eflag}v{vflag}", fk, fp,
                    (ek, bk), (ep, bp), wk, wp, tol, eflag, vflag))
            phase("kernel", f"lj_fene_cellgrid grid {cfg.nx}x{cfg.ny}x"
                            f"{cfg.nz} cap {cfg.cap} {str(dtype)[6:]}: "
                            f"max|f_kernel - f_plain| = {worst:.3g} max|f| "
                            f"(tol {tol:g}), lj and bond energies and virial"
                            f" within tol")
            if natoms == 32000 and dtype == torch.float32:
                args = (x, valid, tag, btags, box, cfg, lj, fene)
                fk, _, _, _ = lj_fene_cellgrid(*args, 0, 0)
                fp, _, _, _ = lj_fene_cellgrid_plain(*args, 0, 0)
                out["max_abs_err"] = float((fk - fp).abs().max())
                out.update(time_kernel(
                    "lj_fene_cellgrid",
                    lambda: lj_fene_cellgrid(*args, 0, 0),
                    lambda: lj_fene_cellgrid_plain(*args, 0, 0),
                    lambda: lj_fene_cellgrid(*args, 1, 1)))
                nlj, nbond = pair_counts(x, valid, box, cfg, lj.cutsq, tag,
                                         btags)
                nneigh, _ = pair_counts(x, valid, box, cfg, cfg.cutneigh ** 2)
                np_ = cfg.capacity
                nbytes = np_ * (12 + 1 + 4 + 4 * btags.shape[1] + 12) + 12
                out["bound_ms"], out["bound_by"] = bound(nlj, nbond, nbytes)
                cand = np_ * 27 * cfg.cap
                phase("kernel", f"lj_fene_cellgrid bound: {nlj} unordered "
                                f"in-cutoff lj pairs and {nbond} bonds "
                                f"({2 * (nlj + nbond) / cand:.4%} of {cand} "
                                f"candidates (i, j); {2 * nneigh / cand:.4%}"
                                f" within cutneigh {cfg.cutneigh}), {nbytes}"
                                f" bytes "
                                f"-> {out['bound_ms']:.6f} ms "
                                f"({out['bound_by']})")
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
    phase("main", "in.lj " + profile_steps(script, 100, 1e3 / sps))
    return {"launches": launches, "sps": sps}


def small_chain_card_vs_cpu(tmp: Path):
    """A 500-atom chain deck to step 40 (rebuilds on the displacement
    check) on the card and on the CPU, f64, the RanMars langevin stream on
    both: thermo agrees to 1e-10 relative, and the rows are equal."""
    rows = {}
    for dev in ("cuda", "cpu"):
        script = chain_setup(tmp, 500, 25, dev, torch.float64, thermo=10)
        for fx in script.sim.fixes:
            if hasattr(fx, "rng"):
                fx.rng = "lammps"
        script.run_string("run 40")
        rows[dev] = (script.sim.last_thermo, [
            ln for ln in script.sim.log_lines
            if not ln.startswith(("Loop time", "Performance"))],
            int(script.sim._carry[1].nbuilds))
    for k in ("temp", "epair", "emol", "etotal", "press"):
        a, b = rows["cuda"][0][k], rows["cpu"][0][k]
        if not abs(a - b) <= 1e-10 * abs(b):
            raise AssertionError(f"chain deck step 40 {k}: card {a} cpu {b}")
    if rows["cuda"][1:] != rows["cpu"][1:]:
        raise AssertionError(f"chain deck rows differ: {rows['cuda'][1]} "
                             f"vs {rows['cpu'][1]}")
    phase("main", f"500-atom chain deck f64 step 40 card = cpu to 1e-10, "
                  f"equal rows, {rows['cuda'][2] - 1} rebuilds: etotal "
                  f"{rows['cuda'][0]['etotal']!r}")


def profile_steps(script, nsteps: int, step_ms: float) -> str:
    """Device time per step and its share of the unprofiled step, device
    operations per step and the largest kernels, over a short window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        script.run_string(f"run {nsteps}")
        torch.cuda.synchronize()
    # device-side events only (kernels, copies, fills): the host ops that
    # launched them carry the same device time
    dev = [ev for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA]
    dev_ms = sum(ev.self_device_time_total for ev in dev) / 1e3 / nsteps
    nops = sum(ev.count for ev in dev) / nsteps
    top = sorted(dev, key=lambda ev: -ev.self_device_time_total)[:4]
    return (f"{nsteps} profiled steps: device busy {dev_ms:.4f} ms/step = "
            f"{dev_ms / step_ms:.1%} of the unprofiled {step_ms:.4f} ms "
            f"step, {nops:.1f} device operations/step; largest: " + "; ".join(
                f"{ev.key[:48]} {ev.self_device_time_total / 1e3 / nsteps:.4f}"
                f" ms/step" for ev in top))


def chain_main_path(tmp: Path, smi: str) -> dict:
    from tpumd_torch.bench_targets import CHAIN_SANITY, CHAIN_STEP0, \
        STEP0_RTOL, gate_failures
    from tpumd_torch.ops import cellgrid as cg
    from tpumd_torch.ops import lj_cellgrid, lj_fene_cellgrid

    chain_data_path = tmp / "data.chain.32000"
    chain_data_path.unlink(missing_ok=True)   # its making counts as set-up
    lj_cellgrid.counts.reset()
    lj_fene_cellgrid.counts.reset()
    t0 = time.perf_counter()
    script = chain_setup(tmp, 32000, 100, "cuda", torch.float32)
    sim = script.sim
    rngs = [fx.rng for fx in sim.fixes if hasattr(fx, "rng")]
    if rngs != ["device"]:
        raise AssertionError(f"langevin rng on the card: {rngs}")
    script.run_string("run 0")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    bad = gate_failures(sim.last_thermo, {
        k: (v, STEP0_RTOL) for k, v in CHAIN_STEP0.items()})
    if bad:
        raise AssertionError(f"chain step-0 gate: {bad}")
    script.run_string("run 100")
    row100 = dict(sim.last_thermo)
    bad = gate_failures(row100, CHAIN_SANITY)
    if bad:
        raise AssertionError(f"chain step-100 gate: {bad}")
    script.run_string("run 500")
    lt0, nb0 = sim.loop_time, int(sim._carry[1].nbuilds)
    script.run_string("run 500")
    dt = sim.loop_time - lt0
    rebuilds = int(sim._carry[1].nbuilds) - nb0
    launches = lj_fene_cellgrid.counts.kernel_launches
    plain = (lj_fene_cellgrid.counts.plain_calls
             + lj_cellgrid.counts.plain_calls)
    lj_launches = lj_cellgrid.counts.kernel_launches
    # setup evaluates once; a run of n steps at thermo 100 is n in-step
    # evaluations plus one energy evaluation per 100 steps
    force_evals = 1 + (100 + 1) + 2 * (500 + 5)
    if launches < force_evals or plain != 0 or lj_launches != 0:
        raise AssertionError(f"lj_fene launches {launches} < force "
                             f"evaluations {force_evals}, or plain calls "
                             f"{plain} != 0, or lj launches {lj_launches}")
    s = sim.state
    if (tuple(s.x.shape) != (sim._neigh_cfg.capacity, 3)
            or not torch.isfinite(s.x).all()
            or sorted(s.tag[s.tag > 0].tolist()) != list(range(1, 32001))):
        raise AssertionError("chain final state malformed")
    sps = 500 / dt
    cfg = sim._neigh_cfg
    phase("main", f"32k chain f32, device RNG: set-up {setup_s:.3f} s "
                  f"(data file, deck, grid {cfg.nx}x{cfg.ny}x{cfg.nz} cap "
                  f"{cfg.cap}, first forces), step 0 and step 100 gates "
                  f"pass (step 100 temp {row100['temp']!r} emol "
                  f"{row100['emol']!r} etotal {row100['etotal']!r}); step "
                  f"1100 etotal {sim.last_thermo['etotal']!r}")
    phase("main", f"chain timed 500 steps: {sps:.2f} timesteps/s, "
                  f"{sps * 32000 / 1e6:.3f} Matom-step/s on {smi}; "
                  f"{rebuilds} rebuilds; lj_fene launches {launches} >= "
                  f"force evaluations {force_evals}, plain calls {plain}")
    # the per-step rebuild check (every 1 delay 1 check yes) reads one
    # flag from the card: its cost alone, on the final state
    st, neigh, _ = sim._carry
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(200):
        bool(cg.displacement_exceeded(st.x, neigh.xhold, neigh.valid,
                                      st.box, cfg.skin))
    check_us = 1e6 * (time.perf_counter() - t1) / 200
    phase("main", f"chain rebuild check: {check_us:.1f} us per call "
                  f"(kernels + one device->host flag read, idle card), "
                  f"one call per step; step {1e3 / sps:.4f} ms")
    phase("main", "chain " + profile_steps(script, 100, 1e3 / sps))
    return {"launches": launches}


def eam_potential(tmp: Path) -> Path:
    from tpumd_torch.bench_targets import eam_funcfl
    path = tmp / "Cu.eam"
    eam_funcfl(path)
    return path


def eam_setup(potential: Path, n: int, device, dtype, thermo: int = 50):
    """LammpsScript of in.eam with n^3 lattice cells on the potential,
    verbose off, before its first run."""
    from tpumd_torch.bench_targets import IN_EAM
    from tpumd_torch.script.parser import LammpsScript
    script = LammpsScript(device=device, dtype=dtype)
    script.run_string(IN_EAM.format(n=n, potential=potential).replace(
        "thermo          50", f"thermo          {thermo}"))
    script.sim.verbose = False
    return script


def eam_kernels_vs_plain(tmp: Path) -> tuple[dict, dict]:
    """B3 and B4 against their plain versions on perturbed in.eam
    lattices; both force passes take the plain density pass's F'."""
    from tpumd_torch.models.pair_eam import PairEAM
    from tpumd_torch.ops.eam_cellgrid import eam_force_cellgrid, \
        eam_force_cellgrid_plain, eam_rho_cellgrid, eam_rho_cellgrid_plain
    pair = PairEAM(1)
    pair.coeff(1, 1, 1, 1, str(eam_potential(tmp)))
    pair.init()
    k_rho, k_force = {}, {}
    for nlat in (20, 4):
        for dtype in (torch.float32, torch.float64):
            x, valid, box, cfg = perturbed_grid(nlat, 17 + nlat, "cuda",
                                                dtype, eam=True)
            tab = pair.kernel_tables(x)
            tol = TOL[dtype]
            worst = 0.0
            for eflag, vflag in ((0, 0), (1, 1), (1, 0), (0, 1)):
                what = f"eam {nlat}^3 {dtype} e{eflag}v{vflag}"
                rk, fpk, ek = eam_rho_cellgrid(x, valid, box, cfg, tab, eflag)
                rp, fpp, ep = eam_rho_cellgrid_plain(x, valid, box, cfg, tab,
                                                     eflag)
                torch.cuda.synchronize()
                for name, a, b in (("rho", rk, rp), ("F'", fpk, fpp)) + (
                        (("F(rho)", ek, ep),) if eflag else ()):
                    err = float((a - b).abs().max())
                    if not err <= tol * float(b.abs().max()):
                        raise AssertionError(f"{what} {name}: {err}")
                fk, ek, wk = eam_force_cellgrid(x, valid, fpp, box, cfg, tab,
                                                eflag, vflag)
                fp, ep, wp = eam_force_cellgrid_plain(x, valid, fpp, box, cfg,
                                                      tab, eflag, vflag)
                worst = max(worst, check_close(what, fk, fp, (ek,), (ep,),
                                               wk, wp, tol, eflag, vflag))
            phase("kernel", f"eam_rho_cellgrid + eam_force_cellgrid grid "
                            f"{cfg.nx}x{cfg.ny}x{cfg.nz} cap {cfg.cap} "
                            f"{str(dtype)[6:]}: rho, F', F(rho) within tol; "
                            f"max|f_kernel - f_plain| = {worst:.3g} max|f| "
                            f"(tol {tol:g}), pair energy and virial within "
                            f"tol")
            if nlat != 20 or dtype != torch.float32:
                continue
            _, fpp, _ = eam_rho_cellgrid_plain(x, valid, box, cfg, tab, 0)
            rk, _, _ = eam_rho_cellgrid(x, valid, box, cfg, tab, 0)
            rp, _, _ = eam_rho_cellgrid_plain(x, valid, box, cfg, tab, 0)
            k_rho["max_abs_err"] = float((rk - rp).abs().max())
            fk, _, _ = eam_force_cellgrid(x, valid, fpp, box, cfg, tab, 0, 0)
            fp, _, _ = eam_force_cellgrid_plain(x, valid, fpp, box, cfg, tab,
                                                0, 0)
            k_force["max_abs_err"] = float((fk - fp).abs().max())
            k_rho.update(time_kernel(
                "eam_rho_cellgrid",
                lambda: eam_rho_cellgrid(x, valid, box, cfg, tab, 0),
                lambda: eam_rho_cellgrid_plain(x, valid, box, cfg, tab, 0),
                lambda: eam_rho_cellgrid(x, valid, box, cfg, tab, 1)))
            k_force.update(time_kernel(
                "eam_force_cellgrid",
                lambda: eam_force_cellgrid(x, valid, fpp, box, cfg, tab, 0,
                                           0),
                lambda: eam_force_cellgrid_plain(x, valid, fpp, box, cfg,
                                                 tab, 0, 0),
                lambda: eam_force_cellgrid(x, valid, fpp, box, cfg, tab, 1,
                                           1)))
            npair, _ = pair_counts(x, valid, box, cfg, tab.cutsq)
            natoms = int(valid.sum())
            np_ = cfg.capacity
            tables = 4 * (tab.rhor.numel() + tab.frho.numel())
            nbytes = np_ * (12 + 1 + 4 + 4) + 12 + tables
            k_rho["bound_ms"], k_rho["bound_by"] = roof(
                npair * OPS_EAM_RHO_PAIR + natoms * OPS_EAM_EMBED, nbytes)
            tables = 4 * (tab.rhor.numel() + tab.z2r.numel())
            nbytes_f = np_ * (12 + 1 + 4 + 12) + 12 + tables
            k_force["bound_ms"], k_force["bound_by"] = roof(
                npair * OPS_EAM_FORCE_PAIR, nbytes_f)
            cand = np_ * 27 * cfg.cap
            rows, hits = warp_rows(x, valid, box, cfg, tab.cutsq)
            phase("kernel", f"eam bounds: {npair} unordered in-cutoff pairs "
                            f"({2 * npair / cand:.4%} of {cand} candidates "
                            f"(i, j)); of {rows} candidate rows (one j "
                            f"against a cell's slots), {hits / rows:.2%} "
                            f"hold a pair in range; "
                            f"{natoms} atoms; density pass {nbytes} "
                            f"bytes -> {k_rho['bound_ms']:.6f} ms "
                            f"({k_rho['bound_by']}); force pass {nbytes_f} "
                            f"bytes -> {k_force['bound_ms']:.6f} ms "
                            f"({k_force['bound_by']})")
    return k_rho, k_force


def small_eam_card_vs_cpu(tmp: Path):
    """The 500-atom in.eam deck to step 40 (rebuilds on the displacement
    check) on the card and on the CPU, f64: thermo agrees to 1e-10
    relative, and the printed rows are equal."""
    rows = {}
    for dev in ("cuda", "cpu"):
        script = eam_setup(tmp / "Cu.eam", 5, dev, torch.float64, thermo=10)
        script.run_string("run 40")
        rows[dev] = (script.sim.last_thermo, [
            ln for ln in script.sim.log_lines
            if not ln.startswith(("Loop time", "Performance"))],
            int(script.sim._carry[1].nbuilds))
    for k in ("temp", "epair", "etotal", "press"):
        a, b = rows["cuda"][0][k], rows["cpu"][0][k]
        if not abs(a - b) <= 1e-10 * abs(b):
            raise AssertionError(f"eam deck step 40 {k}: card {a} cpu {b}")
    if rows["cuda"][1:] != rows["cpu"][1:]:
        raise AssertionError(f"eam deck rows differ: {rows['cuda'][1]} vs "
                             f"{rows['cpu'][1]}")
    phase("main", f"500-atom eam deck f64 step 40 card = cpu to 1e-10, "
                  f"equal rows, {rows['cuda'][2] - 1} rebuilds: etotal "
                  f"{rows['cuda'][0]['etotal']!r}")


def eam_main_path(tmp: Path, smi: str) -> tuple[dict, dict]:
    from tpumd_torch.bench_targets import EAM_SANITY, EAM_STEP0, \
        STEP0_RTOL, gate_failures
    from tpumd_torch.ops import eam_cellgrid, lj_cellgrid, lj_fene_cellgrid

    others = (lj_cellgrid.counts, lj_fene_cellgrid.counts)
    rho_c, force_c = eam_cellgrid.rho_counts, eam_cellgrid.force_counts
    for c in (rho_c, force_c) + others:
        c.reset()
    t0 = time.perf_counter()
    script = eam_setup(eam_potential(tmp), 20, "cuda", torch.float32)
    sim = script.sim
    script.run_string("run 0")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    bad = gate_failures(sim.last_thermo, {
        k: (v, STEP0_RTOL) for k, v in EAM_STEP0.items()})
    if bad:
        raise AssertionError(f"eam step-0 gate: {bad}")
    script.run_string("run 100")
    row100 = dict(sim.last_thermo)
    bad = gate_failures(row100, EAM_SANITY)
    if bad:
        raise AssertionError(f"eam step-100 gate: {bad}")
    script.run_string("run 500")
    lt0, nb0 = sim.loop_time, int(sim._carry[1].nbuilds)
    script.run_string("run 500")
    dt = sim.loop_time - lt0
    rebuilds = int(sim._carry[1].nbuilds) - nb0
    launches = (rho_c.kernel_launches, force_c.kernel_launches)
    plain = sum(c.plain_calls for c in (rho_c, force_c) + others)
    other = sum(c.kernel_launches for c in others)
    # setup evaluates once; a run of n steps at thermo 50 is n in-step
    # evaluations plus one energy evaluation per 50 steps
    force_evals = 1 + (100 + 2) + 2 * (500 + 10)
    if launches != (force_evals, force_evals) or plain or other:
        raise AssertionError(f"eam launches {launches} != force evaluations "
                             f"{force_evals}, or plain calls {plain}, or "
                             f"other kernels' launches {other}")
    s = sim.state
    if (tuple(s.x.shape) != (sim._neigh_cfg.capacity, 3)
            or not torch.isfinite(s.x).all()
            or sorted(s.tag[s.tag > 0].tolist()) != list(range(1, 32001))):
        raise AssertionError("eam final state malformed")
    sps = 500 / dt
    cfg = sim._neigh_cfg
    phase("main", f"32k in.eam f32: set-up {setup_s:.3f} s (potential file, "
                  f"deck, grid {cfg.nx}x{cfg.ny}x{cfg.nz} cap {cfg.cap}, "
                  f"first forces), step 0 and step 100 gates pass (step 100 "
                  f"temp {row100['temp']!r} epair {row100['epair']!r} "
                  f"etotal {row100['etotal']!r}); step 1100 etotal "
                  f"{sim.last_thermo['etotal']!r}")
    phase("main", f"eam timed 500 steps: {sps:.2f} timesteps/s, "
                  f"{sps * 32000 / 1e6:.3f} Matom-step/s on {smi}; "
                  f"{rebuilds} rebuilds; eam_rho / eam_force launches "
                  f"{launches[0]} / {launches[1]} = force evaluations "
                  f"{force_evals}, plain calls {plain}")
    phase("main", "eam " + profile_steps(script, 100, 1e3 / sps))
    return {"launches": launches[0]}, {"launches": launches[1]}


def rhodo_setup(replicate: str, device, dtype, thermo: int = 0):
    """LammpsScript of the rhodo_class deck on the peptide replicated as
    given, verbose off, before its first run."""
    from tpumd_torch.bench_targets import IN_RHODO_CLASS
    from tpumd_torch.script.parser import LammpsScript
    script = LammpsScript(device=device, dtype=dtype)
    script.run_string(IN_RHODO_CLASS.format(golden=GOLDEN).replace(
        "replicate       2 2 4", f"replicate       {replicate}")
        + (f"thermo          {thermo}\n" if thermo else ""))
    script.sim.verbose = False
    return script


def charmm_counts(args):
    """(pairs within the Coulomb cutoff, within the LJ cutoff, in the
    LJ switching shell, within either) of these inputs, unordered, counted
    with the plain sweep in f64."""
    from tpumd_torch.ops.cellgrid import cellgrid_pair_sums
    from tpumd_torch.ops.charmm_cellgrid import special_weights
    x, q, type_, valid, tag, stags, scodes, box, cfg, c = args
    wl, wc = special_weights(scodes, c, x.double())
    cutsq = max(c.cut_coulsq, c.cut_ljsq)
    out = []
    for a, b in ((c.cut_coulsq, c.cut_ljsq), (c.cut_lj_innersq, cutsq)):
        def count(r2, ti, tj, w_lj, w_coul, qi, qj, a=a, b=b):
            return (torch.zeros_like(r2), (r2 < b).to(r2.dtype),
                    (r2 < a).to(r2.dtype), torch.zeros_like(r2))
        _, nb_, _, na_ = cellgrid_pair_sums(
            x.double(), type_, valid, box_f64(box), cfg, count, True, False,
            q=q.double(), special=(tag, stags, wl, wc), cutsq=cutsq,
            max_pairs=1 << 26)
        out += [round(float(na_)), round(float(nb_))]
    ncoul, nlj, ninner, nall = out
    return ncoul, nlj, nlj - ninner, nall


def charmm_args(script, dtype):
    """The arguments of charmm_cellgrid for a set-up script's state."""
    from tpumd_torch.core.state import Box
    sim = script.sim
    s, neigh, _ = sim._carry
    x = s.x.to(dtype)
    box = Box(lo=s.box.lo.to(dtype), hi=s.box.hi.to(dtype))
    c = sim.pair.kernel_coeffs(x, *sim._special_weights())
    return (x, s.q.to(dtype), s.type, neigh.valid, s.tag, s.special_tags,
            s.special_codes, box, sim._neigh_cfg, c)


def charmm_kernel_vs_plain(ptxas_log: str) -> dict:
    """B5 against its plain version on the 32k rhodo_class grid and the
    2^3 peptide grid after set-up, f32 and f64, every flag combination;
    timed and bounded at the 32k shape."""
    from tpumd_torch.ops.charmm_cellgrid import charmm_cellgrid, \
        charmm_cellgrid_plain
    regs = re.findall(r"charmm_cellgrid_kernelI([fd])Lb(\d)ELb(\d)E.*?\n"
                      r".*?(\d+) bytes spill stores.*?\n.*?Used (\d+) "
                      r"registers", ptxas_log)
    phase("kernel", "charmm_cellgrid ptxas (type, eflag, vflag: registers, "
                    "spill store bytes): " + "; ".join(
                        f"{t}{e}{v}: {r}, {sp}" for t, e, v, sp, r in regs))
    out = {}
    for replicate in ("2 2 4", "1 1 1"):
        script = rhodo_setup(replicate, "cuda", torch.float64)
        script.run_string("run 0")
        for dtype in (torch.float32, torch.float64):
            args = charmm_args(script, dtype)
            cfg = args[8]
            tol = TOL[dtype]
            worst = 0.0
            for eflag, vflag in ((0, 0), (1, 1), (1, 0), (0, 1)):
                what = f"charmm {replicate} {dtype} e{eflag}v{vflag}"
                fk, evk, eck, wk = charmm_cellgrid(*args, eflag, vflag)
                fp, evp, ecp, wp = charmm_cellgrid_plain(*args, eflag,
                                                         vflag)
                worst = max(worst, check_close(what, fk, fp, (evk, eck),
                                               (evp, ecp), wk, wp, tol,
                                               eflag, vflag))
                if eflag and vflag:
                    eerr = max(abs(float(evk - evp)) / abs(float(evp)),
                               abs(float(eck - ecp)) / abs(float(ecp)))
                    verr = float((wk - wp).abs().max()
                                 / wp.abs().max())
            phase("kernel", f"charmm_cellgrid grid {cfg.nx}x{cfg.ny}x"
                            f"{cfg.nz} cap {cfg.cap} S "
                            f"{args[5].shape[1]} {str(dtype)[6:]}: "
                            f"max|f_kernel - f_plain| = {worst:.3g} max|f|, "
                            f"evdwl/ecoul {eerr:.3g}, virial {verr:.3g} of "
                            f"max (tol {tol:g})")
            if replicate != "2 2 4" or dtype != torch.float32:
                continue
            fk, _, _, _ = charmm_cellgrid(*args, 0, 0)
            fp, _, _, _ = charmm_cellgrid_plain(*args, 0, 0)
            out["max_abs_err"] = float((fk - fp).abs().max())
            out.update(time_kernel(
                "charmm_cellgrid",
                lambda: charmm_cellgrid(*args, 0, 0),
                lambda: charmm_cellgrid_plain(*args, 0, 0),
                lambda: charmm_cellgrid(*args, 1, 1), reps=50))
            out["v_ms"] = cuda_ms(lambda: charmm_cellgrid(*args, 0, 1), 50)
            ncoul, nlj, nsw, nall = charmm_counts(args)
            np_ = cfg.capacity
            S = args[5].shape[1]
            nbytes = (np_ * (12 + 4 + 4 + 1 + 4 + 8 * S + 12)
                      + args[9].lj.numel() * 4 + 12)
            out["bound_ms"], out["bound_by"] = roof(
                nall * OPS_CHARMM_PAIR + ncoul * OPS_CHARMM_COUL
                + nlj * OPS_CHARMM_LJ + nsw * OPS_CHARMM_SWITCH, nbytes)
            cand = np_ * 27 * cfg.cap
            phase("kernel", f"charmm_cellgrid at the 32k shape: kernel "
                            f"with the virial only (the per-step launch "
                            f"under NPT) {out['v_ms']:.4f} ms; bound: "
                            f"{nall} unordered pairs in range "
                            f"({2 * nall / cand:.4%} of {cand} candidates "
                            f"(i, j)), {ncoul} in Coulomb range, {nlj} in "
                            f"LJ range, {nsw} in the switching shell; "
                            f"{nbytes} bytes -> {out['bound_ms']:.6f} ms "
                            f"({out['bound_by']})")
    return out


def small_rhodo_card_vs_cpu():
    """The peptide with the rhodo_class settings to step 40 on the card
    and on the CPU, f64: thermo agrees to 1e-10 relative, and the printed
    rows and rebuild counts are equal."""
    rows = {}
    for dev in ("cuda", "cpu"):
        script = rhodo_setup("1 1 1", dev, torch.float64, thermo=10)
        script.run_string("run 40")
        rows[dev] = (script.sim.last_thermo, [
            ln for ln in script.sim.log_lines
            if not ln.startswith(("Loop time", "Performance"))],
            int(script.sim._carry[1].nbuilds))
    for k in ("temp", "epair", "emol", "etotal", "press", "lz"):
        a, b = rows["cuda"][0][k], rows["cpu"][0][k]
        if not abs(a - b) <= 1e-10 * abs(b):
            raise AssertionError(f"peptide deck step 40 {k}: card {a} cpu "
                                 f"{b}")
    if rows["cuda"][1:] != rows["cpu"][1:]:
        raise AssertionError(f"peptide deck rows differ: {rows['cuda'][1]} "
                             f"vs {rows['cpu'][1]}")
    phase("main", f"2,004-atom peptide, rhodo_class settings, f64 step 40 "
                  f"card = cpu to 1e-10, equal rows, {rows['cuda'][2] - 1} "
                  f"rebuilds: etotal {rows['cuda'][0]['etotal']!r}")


def rhodo_main_path(smi: str) -> dict:
    from tpumd_torch.bench_targets import RHODO_STEP0, RHODO_STEP100, \
        STEP0_RTOL, gate_failures
    from tpumd_torch.ops import charmm_cellgrid, eam_cellgrid, \
        lj_cellgrid, lj_fene_cellgrid

    others = (lj_cellgrid.counts, lj_fene_cellgrid.counts,
              eam_cellgrid.rho_counts, eam_cellgrid.force_counts)
    b5 = charmm_cellgrid.counts
    for c in (b5,) + others:
        c.reset()
    t0 = time.perf_counter()
    script = rhodo_setup("2 2 4", "cuda", torch.float32)
    sim = script.sim
    script.run_string("run 0")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    row0 = dict(sim.last_thermo)
    bad = gate_failures(row0, {k: (v, STEP0_RTOL)
                               for k, v in RHODO_STEP0.items()})
    if bad:
        raise AssertionError(f"rhodo_class step-0 gate: {bad}")
    script.run_string("run 100")
    row100 = dict(sim.last_thermo)
    bad = gate_failures(row100, RHODO_STEP100)
    if bad:
        raise AssertionError(f"rhodo_class step-100 gate: {bad}")
    script.run_string("run 500")
    lt0, nb0 = sim.loop_time, int(sim._carry[1].nbuilds)
    script.run_string("run 500")
    dt = sim.loop_time - lt0
    rebuilds = int(sim._carry[1].nbuilds) - nb0
    launches, plain = b5.kernel_launches, b5.plain_calls
    other = sum(c.kernel_launches for c in others)
    plain += sum(c.plain_calls for c in others)
    # setup evaluates once; a run of n > 0 steps without thermo output is
    # one segment: n in-step evaluations plus one energy evaluation
    force_evals = 1 + (100 + 1) + 2 * (500 + 1)
    if launches != force_evals or plain or other:
        raise AssertionError(f"charmm launches {launches} != force "
                             f"evaluations {force_evals}, or plain calls "
                             f"{plain}, or other kernels' launches {other}")
    s = sim.state
    n = sim.natoms
    if (n != 32064 or tuple(s.x.shape) != (sim._neigh_cfg.capacity, 3)
            or not torch.isfinite(s.x).all()
            or sorted(s.tag[s.tag > 0].tolist()) != list(range(1, n + 1))):
        raise AssertionError("rhodo_class final state malformed")
    sps = 500 / dt
    cfg, ks = sim._neigh_cfg, sim.kspace
    phase("main", f"32k rhodo_class f32: set-up {setup_s:.3f} s (data file, "
                  f"replicate, SHAKE clusters, PPPM mesh {ks.nx}x{ks.ny}x"
                  f"{ks.nz} g_ewald {float(ks.g_ewald)!r}, grid {cfg.nx}x{cfg.ny}x"
                  f"{cfg.nz} cap {cfg.cap}, first forces); step 0 "
                  f"{ {k: row0[k] for k in RHODO_STEP0} } and step 100 "
                  f"{ {k: row100[k] for k in RHODO_STEP100} } pass the "
                  f"reference binary's gates; step 1200 etotal "
                  f"{sim.last_thermo['etotal']!r}, lz "
                  f"{sim.last_thermo['lz']!r}")
    phase("main", f"rhodo_class timed 500 steps: {sps:.2f} timesteps/s, "
                  f"{sps * n / 1e6:.3f} Matom-step/s on {smi}; {rebuilds} "
                  f"rebuilds; charmm_cellgrid launches {launches} = force "
                  f"evaluations {force_evals}, plain calls {plain}, other "
                  f"kernels' launches {other}")
    phase("main", "rhodo_class " + profile_steps(script, 100, 1e3 / sps))
    phase("main", "rhodo_class step parts, host clock to a synchronize, "
                  "ms per call on the final state: " + rhodo_breakdown(sim))
    return {"launches": launches}


def rhodo_breakdown(sim, reps: int = 20) -> str:
    """Host-clock time of each part of a rhodo_class step, each run alone
    on the final state and followed by a synchronize: the pair kernel with
    the virial, the bonded styles, PPPM, SHAKE's solve, fix npt's two
    halves and the rebuild check."""
    from tpumd_torch.md import verlet
    from tpumd_torch.models.bonded import compute_tuples
    s, neigh, fstates = sim._carry
    ctx = sim._ctx
    shake = [(fx, fs) for fx, fs in zip(ctx.fixes, fstates)
             if fx.name == "shake"][0]
    nh = [(fx, fs) for fx, fs in zip(ctx.fixes, fstates)
          if fx.name == "nh"][0]
    only_pair = dataclasses.replace(ctx, bonded=(), kspace=None)

    def bonded():
        r2s = neigh.row2slot
        view = (s.x[r2s], s.type[r2s], s.q[r2s])
        for style, tuples in ctx.bonded:
            compute_tuples(style, view, tuples, s.box, ctx, False, True)
    parts = {
        "pair (B5, virial)": lambda: verlet.compute_forces(
            s, neigh, only_pair, False, True),
        "bonded": bonded,
        "pppm": lambda: ctx.kspace.compute(s.x, s.q, s.box, False, True),
        "shake": lambda: shake[0].post_force(s, shake[1], ctx),
        "npt initial": lambda: nh[0].initial_integrate(s, nh[1], ctx),
        "npt final": lambda: nh[0].final_integrate(s, nh[1], ctx),
        "rebuild check": lambda: verlet.decide_rebuild(
            s, neigh.replace(ago=ctx.neigh_cfg.delay), ctx),
    }
    out = []
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out.append(f"{name} {1e3 * (time.perf_counter() - t0) / reps:.3f}")
    return "; ".join(out)


def chute_setup(data: Path, device, dtype, thermo: int = 0):
    """LammpsScript of the chute deck on a chute_data file, verbose off,
    before its first run."""
    from tpumd_torch.bench_targets import IN_CHUTE
    from tpumd_torch.script.parser import LammpsScript
    script = LammpsScript(device=device, dtype=dtype)
    deck = IN_CHUTE.format(data=data)
    if thermo:
        deck = deck.replace("thermo          100",
                            f"thermo          {thermo}")
    script.run_string(deck)
    script.sim.verbose = False
    return script


def gran_args(script, dtype, scale=1.0):
    """(arguments before the coefficients, planes, coefficients) of
    gran_cellgrid for a set-up script's state, the history scaled."""
    from tpumd_torch.core.state import Box
    sim = script.sim
    s, neigh, _ = sim._carry
    f = (lambda a: a.to(dtype))
    box = Box(lo=f(s.box.lo), hi=f(s.box.hi), periodic=s.box.periodic)
    planes = (f(s.v), f(s.omega), f(s.radius),
              f(torch.where(s.rmass > 0, s.rmass, 1.0)), s.gmask)
    return ((f(s.x), s.tag, neigh.valid, neigh.shear_tags,
             f(neigh.shear * scale), box, sim._neigh_cfg), planes,
            sim.pair.kernel_coeffs())


def check_gran(what, out, plain, tol) -> float:
    """Raise unless the kernel's forces, torques and history agree with
    the plain version's (tags equal); returns the largest error of forces
    and torques relative to their largest value."""
    torch.cuda.synchronize()
    if not torch.equal(out[2], plain[2]):
        raise AssertionError(f"{what}: history tags differ in "
                             f"{int((out[2] != plain[2]).sum())} entries")
    worst = 0.0
    for name, k, p in zip(("force", "torque", "shear"), out[:2] + out[3:],
                          plain[:2] + plain[3:]):
        if not torch.isfinite(k).all():
            raise AssertionError(f"{what}: kernel {name} not finite")
        top = float(p.abs().max())
        err = float((k - p).abs().max())
        if err > tol * top:
            raise AssertionError(f"{what} {name}: {err} > {tol} * {top}")
        if name != "shear":
            worst = max(worst, err / top)
    return worst


def gran_kernel_vs_plain(tmp: Path, ptxas_log: str) -> dict:
    """B6 against its plain version on the 32k chute grid after set-up
    and 10 steps, on a 5x2x3 grid (y periodic with 2 cells) and on a 5x5x2
    grid (z non-periodic with 2 cells, the aliased offsets dropped) after
    30 steps, f32 and f64, both shearupdate values, the history as it is
    and scaled by 40; timed and bounded at the 32k shape."""
    from tpumd_torch.bench_targets import chute_data
    from tpumd_torch.ops.gran_cellgrid import gran_cellgrid, \
        gran_compact_sums
    regs = re.findall(r"gran_cellgrid_kernelI([fd])Lb(\d)ELb(\d)ELb(\d)E"
                      r"Lb(\d)E.*?\n.*?(\d+) bytes spill stores.*?\n.*?"
                      r"Used (\d+) registers", ptxas_log)
    phase("kernel", "gran_cellgrid ptxas (type, shearupdate, freeze, "
                    "exclude, limit_damping: registers, spill store bytes): "
                    + "; ".join(f"{t}{a}{b}{c}{d}: {r}, {sp}"
                                for t, a, b, c, d, sp, r in regs))
    out = {}
    for dims, nsteps, grid in (((40, 20, 40), 10, None),
                               ((6, 3, 6), 30, (5, 2, 3)),
                               ((6, 6, 4), 30, (5, 5, 2))):
        data = tmp / f"data.chute.{'x'.join(map(str, dims))}"
        chute_data(data, *dims)
        script = chute_setup(data, "cuda", torch.float64)
        script.run_string(f"run {nsteps}")
        cfg = script.sim._neigh_cfg
        if grid is not None and (cfg.nx, cfg.ny, cfg.nz) != grid:
            raise AssertionError(f"chute {dims}: grid {cfg} is not {grid}")
        for dtype in (torch.float32, torch.float64):
            tol = TOL[dtype]
            worst = 0.0
            for scale in (1.0, 40.0):
                args, planes, c = gran_args(script, dtype, scale)
                for coeffs in (c, c._replace(gammat=0.5 * c.gamman,
                                             limit_damping=True)):
                    for su in (True, False):
                        what = (f"gran {dims} {dtype} scale {scale} "
                                f"gammat {coeffs.gammat} shearupdate {su}")
                        worst = max(worst, check_gran(
                            what, gran_cellgrid(*args, coeffs, planes, 1e-4,
                                                su),
                            gran_compact_sums(*args, coeffs, planes, 1e-4,
                                              su), tol))
            cfg = args[6]
            phase("kernel", f"gran_cellgrid grid {cfg.nx}x{cfg.ny}x{cfg.nz} "
                            f"cap {cfg.cap} {str(dtype)[6:]}: max|kernel - "
                            f"plain| = {worst:.3g} of max|f| and max|torque|,"
                            f" history tags equal (tol {tol:g})")
            if dims[0] != 40 or dtype != torch.float32:
                continue
            args, planes, c = gran_args(script, dtype)
            kern = (lambda: gran_cellgrid(*args, c, planes, 1e-4, True))
            plain = (lambda: gran_compact_sums(*args, c, planes, 1e-4,
                                               True))
            fk, fp = kern()[0], plain()[0]
            out["max_abs_err"] = float((fk - fp).abs().max())
            p1 = cuda_ms(plain, 10)
            k1 = cuda_ms(kern, 200)
            k2 = cuda_ms(kern, 200)
            p2 = cuda_ms(plain, 10)
            k_ro = cuda_ms(lambda: gran_cellgrid(*args, c, planes, 1e-4,
                                                 False), 200)
            out.update(ms=min(k1, k2), plain_ms=min(p1, p2))
            # contacts: each appears in both of its atoms' new tables (none
            # is dropped below KH = 12 contacts per sphere)
            stags = plain()[2]
            ncontact = int((stags != 0).sum()) // 2
            np_ = cfg.capacity
            # per slot, read: x, v, omega, radius, rmass (11 floats), gmask,
            # tag, valid (9 bytes), the old tags and shear (12 + 36 words);
            # written: f, torque (6 floats), the new tags and shear
            nbytes = np_ * (4 * (11 + 6) + 9 + 2 * 4 * (12 + 36)) + 12
            out["bound_ms"], out["bound_by"] = roof(
                ncontact * OPS_GRAN_PAIR, nbytes)
            cand = np_ * 27 * cfg.cap
            phase("kernel", f"gran_cellgrid at the 32k shape, f32, "
                            f"shearupdate: kernel {k1:.4f} / {k2:.4f} ms, "
                            f"plain {p1:.4f} / {p2:.4f} ms; read-only "
                            f"(thermo) kernel {k_ro:.4f} ms; bound: "
                            f"{ncontact} contacts ({2 * ncontact / cand:.4%}"
                            f" of {cand} candidates (i, j)); {nbytes} bytes "
                            f"-> {out['bound_ms']:.6f} ms "
                            f"({out['bound_by']})")
    return out


def small_chute_card_vs_cpu(tmp: Path):
    """A 480-sphere chute deck to step 40 on the card and on the CPU, f64:
    thermo agrees to 1e-10 relative, and the rows, rebuild counts and
    history tags are equal."""
    from tpumd_torch.bench_targets import chute_data
    data = tmp / "data.chute.small"
    chute_data(data, 10, 6, 8)
    rows = {}
    for dev in ("cuda", "cpu"):
        script = chute_setup(data, dev, torch.float64, thermo=10)
        script.run_string("run 40")
        sim = script.sim
        rows[dev] = (sim.last_thermo, [
            ln for ln in sim.log_lines
            if not ln.startswith(("Loop time", "Performance"))],
            int(sim._carry[1].nbuilds), sim._carry[1].shear_tags.tolist())
    for k in ("ke", "c_1", "vol"):
        a, b = rows["cuda"][0][k], rows["cpu"][0][k]
        if not abs(a - b) <= 1e-10 * abs(b):
            raise AssertionError(f"chute deck step 40 {k}: card {a} cpu {b}")
    if rows["cuda"][1:] != rows["cpu"][1:]:
        raise AssertionError(f"chute deck rows, rebuilds or history differ: "
                             f"{rows['cuda'][1]} vs {rows['cpu'][1]}")
    phase("main", f"480-sphere chute deck f64 step 40 card = cpu to 1e-10, "
                  f"equal rows and history tags, {rows['cuda'][2] - 1} "
                  f"rebuilds: ke {rows['cuda'][0]['ke']!r} c_1 "
                  f"{rows['cuda'][0]['c_1']!r}")


def chute_main_path(tmp: Path, smi: str) -> dict:
    from tpumd_torch.bench_targets import CHUTE_STEP0, CHUTE_STEP100, \
        STEP0_RTOL, chute_data, gate_failures
    from tpumd_torch.ops import charmm_cellgrid, eam_cellgrid, \
        gran_cellgrid, lj_cellgrid, lj_fene_cellgrid

    others = (lj_cellgrid.counts, lj_fene_cellgrid.counts,
              eam_cellgrid.rho_counts, eam_cellgrid.force_counts,
              charmm_cellgrid.counts)
    b6 = gran_cellgrid.counts
    for c in (b6,) + others:
        c.reset()
    data = tmp / "data.chute.32000"
    t0 = time.perf_counter()
    chute_data(data)
    script = chute_setup(data, "cuda", torch.float32)
    sim = script.sim
    script.run_string("run 0")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    row0 = dict(sim.last_thermo)
    bad = gate_failures(row0, {k: (v, STEP0_RTOL)
                               for k, v in CHUTE_STEP0.items()})
    if bad:
        raise AssertionError(f"chute step-0 gate: {bad}")
    script.run_string("run 100")
    row100 = dict(sim.last_thermo)
    bad = gate_failures(row100, CHUTE_STEP100)
    if bad:
        raise AssertionError(f"chute step-100 gate: {bad}")
    script.run_string("run 500")
    lt0, nb0 = sim.loop_time, int(sim._carry[1].nbuilds)
    script.run_string("run 500")
    dt = sim.loop_time - lt0
    rebuilds = int(sim._carry[1].nbuilds) - nb0
    launches, plain = b6.kernel_launches, b6.plain_calls
    other = sum(c.kernel_launches for c in others)
    plain += sum(c.plain_calls for c in others)
    # setup evaluates once; a run of n steps at thermo 100 is n in-step
    # evaluations plus one read-only evaluation per 100 steps
    force_evals = 1 + (100 + 1) + 2 * (500 + 5)
    if launches != force_evals or plain or other:
        raise AssertionError(f"gran launches {launches} != force "
                             f"evaluations {force_evals}, or plain calls "
                             f"{plain}, or other kernels' launches {other}")
    s, neigh, _ = sim._carry
    if (tuple(s.x.shape) != (sim._neigh_cfg.capacity, 3)
            or not torch.isfinite(s.x).all()
            or not torch.isfinite(neigh.shear).all()
            or sorted(s.tag[s.tag > 0].tolist()) != list(range(1, 32001))):
        raise AssertionError("chute final state malformed")
    sps = 500 / dt
    cfg = sim._neigh_cfg
    live = (neigh.shear_tags != 0).sum(1)
    phase("main", f"32k chute f32: set-up {setup_s:.3f} s (data file, deck, "
                  f"grid {cfg.nx}x{cfg.ny}x{cfg.nz} cap {cfg.cap}, first "
                  f"forces); step 0 {row0!r} and step 100 {row100!r} pass "
                  f"the gates; step 1200 ke {sim.last_thermo['ke']!r} c_1 "
                  f"{sim.last_thermo['c_1']!r} vol "
                  f"{sim.last_thermo['vol']!r}; contacts per sphere "
                  f"{float(live[neigh.valid].double().mean()):.3f}, at most "
                  f"{int(live.max())}")
    phase("main", f"chute timed 500 steps: {sps:.2f} timesteps/s, "
                  f"{sps * 32000 / 1e6:.3f} Matom-step/s on {smi}; "
                  f"{rebuilds} rebuilds; gran_cellgrid launches {launches} "
                  f"= force evaluations {force_evals}, plain calls {plain}, "
                  f"other kernels' launches {other}")
    phase("main", "chute " + profile_steps(script, 100, 1e3 / sps))
    return {"launches": launches, "sps": sps}


# the probe's shapes (tools/probes/gather_probe.py:8-10): a 32,768-row
# table, 32,768 atoms x K = 16 gathered rows
P1_ROWS, P1_GATHERED = 32768, 32768 * 16
# the tables and indices that the 32k matrix decks hand to P1: (dtype,
# table rows, width, index shape), from their configs on the card (in.lj:
# 11^3 cells of cap 44, K 88, blocks of 4096; chute: 37 x 18 x 24 cells of
# cap 8, K 16, blocks of 16384).  in.lj: the cell table at a block's
# stencil, the candidates' coordinates (27 x 44 a row; the table has a
# far-away row past the atoms), the packed j rows and the lj/cut
# coefficient rows; chute: the cell table, the candidates' coordinates
# with the group bits, and the packed (N, 12) j rows.  matrix_main_path
# also compares the inputs those runs really gave it.
P1_MAIN_SHAPES = (
    (torch.int32, 1331, 44, (4096, 27)),
    (torch.float32, 32001, 3, (4096, 1188)),
    (torch.float32, 32000, 4, (32000, 88)),
    (torch.float32, 4, 6, (32000, 88)),
    (torch.int32, 15984, 8, (16384, 27)),
    (torch.float32, 32001, 4, (16384, 216)),
    (torch.float32, 32000, 12, (32000, 16)))
# the modules that call gather_rows by name (matrix_main_path records
# their inputs)
P1_CALLERS = ("tpumd_torch.ops.neighbor", "tpumd_torch.ops.pairwise",
              "tpumd_torch.models.pair_gran", "tpumd_torch.models.pair_lj_cut")


def p1_case(gen, dtype, rows: int, width: int, shape: tuple):
    """A random (rows, width) table and a shape of indices into it, the
    last one the last row."""
    if dtype == torch.int32:
        table = torch.randint(-2**31, 2**31 - 1, (rows, width),
                              generator=gen, device="cuda",
                              dtype=torch.int32)
    else:
        table = torch.randn((rows, width), generator=gen, device="cuda",
                            dtype=dtype)
    idx = torch.randint(0, rows, shape, generator=gen, device="cuda",
                        dtype=torch.int32)
    idx.view(-1)[-1] = rows - 1
    return table, idx


def p1_equal_plain(cases, what: str) -> int:
    """Raise unless P1 equals its plain version bit for bit on every
    (table, idx) of cases; returns their number."""
    from tpumd_torch.ops.gather import gather_rows, gather_rows_plain
    n = 0
    for table, idx in cases:
        out = gather_rows(table, idx)
        torch.cuda.synchronize()
        if not torch.equal(out, gather_rows_plain(table, idx)):
            raise AssertionError(f"row_gather {what}: {table.dtype} table "
                                 f"{tuple(table.shape)} idx "
                                 f"{tuple(idx.shape)} differs from plain")
        n += 1
    return n


@contextlib.contextmanager
def recording_p1(seen: dict):
    """Within the block, every call of gather_rows from the engine first
    keeps a copy of its table and indices, the first of each (dtype, table
    shape, index shape) in seen, then goes to the wrapper unchanged."""
    from tpumd_torch.ops import gather
    mods = [importlib.import_module(m) for m in P1_CALLERS]

    def record(table, idx):
        key = (table.dtype, tuple(table.shape), tuple(idx.shape))
        if key not in seen:
            seen[key] = (table.clone(), idx.clone())
        return gather.gather_rows(table, idx)
    for m in mods:
        m.gather_rows = record
    try:
        yield
    finally:
        for m in mods:
            m.gather_rows = gather.gather_rows


def gather_kernel_vs_plain() -> dict:
    """P1 against its plain version on the card, bit for bit, for f32, f64
    and int32 tables of widths 1, 5, 12, 16 and 128 with (M,) and (M, K)
    indices that include the last row, and at the 32k matrix decks' widths
    and index shapes (P1_MAIN_SHAPES); then timed at the probe's shapes,
    f32, L = 128 and 16, in the order plain, kernel, kernel, plain, beside
    its bound and torch.index_select on the same tensors."""
    from tpumd_torch.ops.gather import gather_rows, gather_rows_plain
    gen = torch.Generator(device="cuda").manual_seed(2026)
    checked = p1_equal_plain(
        (p1_case(gen, dtype, 5000, width, shape)
         for dtype in (torch.float32, torch.float64, torch.int32)
         for width in (1, 5, 12, 16, 128)
         for shape in ((5000 * 4 + 3,), (5000, 17))), "small")
    phase("kernel", f"row_gather = plain bit for bit in {checked} cases "
                    "(f32, f64, int32; widths 1, 5, 12, 16, 128; (M,) and "
                    "(M, K) indices up to the last row)")
    checked = p1_equal_plain(
        (p1_case(gen, *c) for c in P1_MAIN_SHAPES), "main-path shape")
    phase("kernel", f"row_gather = plain bit for bit in {checked} cases at "
                    "the 32k matrix decks' shapes: " + "; ".join(
                        f"{str(d)[6:]} {r} x {w} at {sh}"
                        for d, r, w, sh in P1_MAIN_SHAPES))
    out = {}
    for width in (128, 16):
        table = torch.randn((P1_ROWS, width), generator=gen, device="cuda")
        idx = torch.randint(0, P1_ROWS, (P1_GATHERED,), generator=gen,
                            device="cuda", dtype=torch.int32)
        kern = (lambda: gather_rows(table, idx))
        plain = (lambda: gather_rows_plain(table, idx))
        lib = (lambda: torch.index_select(table, 0, idx))
        ref = plain()
        err = float((kern() - ref).abs().max())
        if not torch.equal(kern(), ref) or not torch.equal(lib(), ref):
            raise AssertionError(f"row_gather L={width}: differs")
        p1 = cuda_ms(plain, 50)
        k1 = cuda_ms(kern, 200)
        k2 = cuda_ms(kern, 200)
        p2 = cuda_ms(plain, 50)
        lib_ms = cuda_ms(lib, 200)
        # the table and the indices read once, the rows written once
        nbytes = 4 * (P1_ROWS * width + P1_GATHERED + P1_GATHERED * width)
        bound_ms, bound_by = roof(0, nbytes)
        phase("kernel", f"row_gather at the probe's shape L={width} f32 "
                        f"({P1_ROWS} x {width} table, {P1_GATHERED} rows): "
                        f"kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / "
                        f"{p2:.4f} ms, torch.index_select {lib_ms:.4f} ms; "
                        f"bound {nbytes} B -> {bound_ms:.6f} ms "
                        f"({bound_by}; the table fits in L2, so reads may "
                        f"beat it); max|kernel - plain| = {err}")
        if width == 128:
            out = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                   "library_ms": lib_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "max_abs_err": err}
    return out


def check_p1(what: str, nsteps: int) -> str:
    """Raise unless this card run of the matrix engine launched P1 at
    least once per force evaluation (set-up and nsteps) and never ran its
    plain version; returns the counts."""
    from tpumd_torch.ops.gather import counts
    if counts.kernel_launches < nsteps + 1 or counts.plain_calls:
        raise AssertionError(f"{what}: row_gather launches "
                             f"{counts.kernel_launches} < {nsteps + 1} "
                             f"force evaluations, or plain calls "
                             f"{counts.plain_calls}")
    return (f"row_gather launches {counts.kernel_launches}, plain calls "
            f"{counts.plain_calls}")


def small_matrix_card_vs_cpu(tmp: Path):
    """The 6^3 in.lj deck and the 480-sphere chute pack on the matrix
    engine to step 40, card against CPU, f64: thermo to 1e-10 relative,
    equal rows."""
    from tpumd_torch.bench_targets import IN_LJ, chute_data
    from tpumd_torch.ops.gather import counts
    from tpumd_torch.script.parser import LammpsScript
    data = tmp / "data.chute.small"
    chute_data(data, 10, 6, 8)
    for name, deck, keys in (
            ("6^3 in.lj", IN_LJ.format(n=6), ("temp", "epair", "etotal",
                                              "press")),
            ("480-sphere chute", chute_setup_deck(data, 10),
             ("ke", "c_1", "vol"))):
        rows = {}
        for dev in ("cuda", "cpu"):
            script = LammpsScript(device=dev, dtype=torch.float64)
            script.run_string(deck)
            sim = script.sim
            sim.verbose = False
            sim.neighbor_mode = "matrix"
            counts.reset()
            script.run_string("run 40")
            if sim._ctx.is_cellgrid:
                raise AssertionError(f"{name}: not on the matrix engine")
            if dev == "cuda":
                launched = check_p1(name, 40)
            rows[dev] = (sim.last_thermo, [
                ln for ln in sim.log_lines
                if not ln.startswith(("Loop time", "Performance"))])
        for k in keys:
            a, b = rows["cuda"][0][k], rows["cpu"][0][k]
            if not abs(a - b) <= 1e-10 * abs(b):
                raise AssertionError(f"{name} matrix step 40 {k}: card {a} "
                                     f"cpu {b}")
        if rows["cuda"][1] != rows["cpu"][1]:
            raise AssertionError(f"{name} matrix rows differ: "
                                 f"{rows['cuda'][1]} vs {rows['cpu'][1]}")
        phase("main", f"{name} on the matrix engine, f64 step 40: card = "
                      f"cpu to 1e-10, equal rows: {rows['cuda'][1][-2]}; on "
                      f"the card {launched}")


def chute_setup_deck(data: Path, thermo: int) -> str:
    from tpumd_torch.bench_targets import IN_CHUTE
    return IN_CHUTE.format(data=data).replace("thermo          100",
                                              f"thermo          {thermo}")


def log_rows(path: Path) -> list[list[str]]:
    """The thermo rows of a reference-binary log."""
    rows, active = [], False
    for ln in path.read_text().splitlines():
        if ln.strip().startswith("Step"):
            active = True
            continue
        if active:
            p = ln.split()
            if not p or not p[0].lstrip("-").isdigit():
                active = False
                continue
            rows.append(p)
    return rows


def golden_matrix_decks():
    """small_box (every pair through several images) and tri_lj (a
    triclinic box) on the card, f64, against the reference binary's logs:
    small_box every row at rel 1e-7, tri_lj every row at the tolerances of
    tests/test_triclinic.py:23-28."""
    from tpumd_torch.ops.gather import counts
    from tpumd_torch.script.parser import LammpsScript
    golden = GOLDEN.parent
    for name in ("small_box", "tri_lj"):
        script = LammpsScript(device="cuda", dtype=torch.float64)
        script.data_dir = str(golden / name)
        pre, run = (golden / name / "in.test").read_text().rsplit("\nrun", 1)
        script.run_string(pre)
        sim = script.sim
        sim.verbose = False
        counts.reset()
        script.run_string("run" + run)
        if sim._ctx.is_cellgrid:
            raise AssertionError(f"{name}: \"auto\" chose the cell grid")
        launched = check_p1(name, int(run.split()[0]))
        got = np.array([ln.split() for ln in sim.log_lines
                        if ln.split() and ln.split()[0].isdigit()],
                       np.float64)
        if name == "small_box":
            ref = np.array(log_rows(golden / name / "log.ref"), np.float64)
            tols = [(c, 1e-7, 0.0) for c in (1, 2, 3, 4)]
            if len(sim._neigh_cfg.image_shifts) != 27:
                raise AssertionError("small_box: not in the image mode")
        else:
            ref = np.loadtxt(golden / name / "thermo.csv")
            tols = [(1, 1e-7, 0.0), (2, 1e-7, 0.0), (4, 1e-7, 0.0),
                    (5, 1e-6, 1e-9), (6, 1e-12, 0.0)]
            if not sim.state.box.istriclinic:
                raise AssertionError("tri_lj: box not triclinic")
        if got.shape != ref.shape or (got[:, 0] != ref[:, 0]).any():
            raise AssertionError(f"{name}: rows {got[:, 0]} vs {ref[:, 0]}")
        for c, rtol, atol in tols:
            if not np.allclose(got[:, c], ref[:, c], rtol=rtol, atol=atol):
                raise AssertionError(f"{name} column {c}: {got[:, c]} vs "
                                     f"{ref[:, c]}")
        phase("main", f"{name} on the card (matrix engine, f64) = the "
                      f"reference binary's log, {len(got)} rows; last "
                      f"{got[-1].tolist()}; {launched}")


def matrix_main_path(tmp: Path, smi: str, grid_sps: dict) -> dict:
    """The 32k in.lj and chute decks through LammpsScript on the matrix
    engine, f32: each deck's step-0 and step-100 gates, 500 warm-up and
    500 timed steps beside the cell grid's figure of this call, the
    launch counts of P1 (at least one per force evaluation; plain calls
    0; no cell-grid kernel) and a profile of 100 steps."""
    from tpumd_torch.bench_targets import CHUTE_STEP0, CHUTE_STEP100, \
        IN_LJ, SANITY, STEP0, STEP0_RTOL, chute_data, gate_failures
    from tpumd_torch.ops import charmm_cellgrid, eam_cellgrid, gather, \
        gran_cellgrid, lj_cellgrid, lj_fene_cellgrid
    from tpumd_torch.script.parser import LammpsScript
    grid = (lj_cellgrid.counts, lj_fene_cellgrid.counts,
            eam_cellgrid.rho_counts, eam_cellgrid.force_counts,
            charmm_cellgrid.counts, gran_cellgrid.counts)
    data = tmp / "data.chute.32000"
    if not data.exists():
        chute_data(data)
    total = 0
    for name, deck, gates0, gates100, natoms in (
            ("in.lj", IN_LJ.format(n=20), STEP0["lj"], SANITY["lj"], 32000),
            ("chute", chute_setup_deck(data, 100), CHUTE_STEP0,
             CHUTE_STEP100, 32000)):
        for c in (gather.counts,) + grid:
            c.reset()
        t0 = time.perf_counter()
        script = LammpsScript(device="cuda", dtype=torch.float32)
        script.run_string(deck)
        sim = script.sim
        sim.verbose = False
        sim.neighbor_mode = "matrix"
        seen = {}
        with recording_p1(seen):
            script.run_string("run 0")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        row0 = dict(sim.last_thermo)
        bad = gate_failures(row0, {k: (v, STEP0_RTOL)
                                   for k, v in gates0.items()})
        if bad:
            raise AssertionError(f"matrix {name} step-0 gate: {bad}")
        script.run_string("run 100")
        row100 = dict(sim.last_thermo)
        bad = gate_failures(row100, gates100)
        if bad:
            raise AssertionError(f"matrix {name} step-100 gate: {bad}")
        script.run_string("run 500")
        lt0, nb0 = sim.loop_time, int(sim._carry[1].nbuilds)
        script.run_string("run 500")
        dt = sim.loop_time - lt0
        rebuilds = int(sim._carry[1].nbuilds) - nb0
        launches = gather.counts.kernel_launches
        plain = gather.counts.plain_calls + sum(c.plain_calls for c in grid)
        other = sum(c.kernel_launches for c in grid)
        # at least set-up, the in-step evaluations and one per thermo
        # output (thermo 50 or 100 on these decks)
        force_evals = 1 + 100 + 2 * 500 + 3
        if launches < force_evals or plain or other:
            raise AssertionError(f"matrix {name}: row_gather launches "
                                 f"{launches} < force evaluations "
                                 f"{force_evals}, or plain calls {plain}, "
                                 f"or cell-grid kernel launches {other}")
        s, neigh = sim._carry[0], sim._carry[1]
        if (sim._ctx.is_cellgrid or tuple(s.x.shape) != (natoms, 3)
                or not torch.isfinite(s.x).all()
                or sorted(s.tag.tolist()) != list(range(1, natoms + 1))):
            raise AssertionError(f"matrix {name}: final state malformed")
        total += launches
        # P1 against its plain version on the inputs that the set-up's
        # neighbor build and force evaluation gave it (after the counts
        # are read: these launches are not the run's)
        p1_equal_plain(seen.values(), f"matrix {name} input")
        phase("kernel", f"row_gather = plain bit for bit on the {len(seen)}"
                        f" kinds of input that 32k {name}'s matrix set-up "
                        "gave it: " + "; ".join(
                            f"{str(d)[6:]} {t[0]} x {t[1]} at {i}"
                            for d, t, i in seen))
        sps = 500 / dt
        cfg = sim._neigh_cfg
        keys = tuple(gates100)
        phase("main", f"32k {name} f32 on the matrix engine: set-up "
                      f"{setup_s:.3f} s (cells {cfg.nx}x{cfg.ny}x{cfg.nz} "
                      f"cap {cfg.cell_cap}, K {cfg.kmax}, max count "
                      f"{int(neigh.max_count)}, block {cfg.block}); step 0 "
                      f"{ {k: row0[k] for k in gates0} } and step 100 "
                      f"{ {k: row100[k] for k in keys} } pass the gates")
        phase("main", f"matrix {name} timed 500 steps: {sps:.2f} "
                      f"timesteps/s, {sps * natoms / 1e6:.3f} Matom-step/s "
                      f"on {smi}, against the cell grid's {grid_sps[name]:.2f}"
                      f" timesteps/s in this call (matrix / grid "
                      f"{sps / grid_sps[name]:.3f}); {rebuilds} rebuilds; "
                      f"row_gather launches {launches} >= force evaluations "
                      f"{force_evals}, plain calls {plain}, cell-grid "
                      f"kernel launches {other}")
        phase("main", f"matrix {name} " + profile_steps(script, 100,
                                                        1e3 / sps))
    return {"launches": total}


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
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        k_lj = lj_kernel_vs_plain()
        k_fene = fene_kernel_vs_plain(tmp)
        small_deck_card_vs_cpu()
        m_lj = main_path(smi)
        small_chain_card_vs_cpu(tmp)
        m_fene = chain_main_path(tmp, smi)
        k_rho, k_force = eam_kernels_vs_plain(tmp)
        small_eam_card_vs_cpu(tmp)
        m_rho, m_force = eam_main_path(tmp, smi)
    k_charmm = charmm_kernel_vs_plain(log)
    small_rhodo_card_vs_cpu()
    m_charmm = rhodo_main_path(smi)
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        k_gran = gran_kernel_vs_plain(tmp, log)
        small_chute_card_vs_cpu(tmp)
        m_gran = chute_main_path(tmp, smi)
        k_gather = gather_kernel_vs_plain()
        small_matrix_card_vs_cpu(tmp)
        golden_matrix_decks()
        m_gather = matrix_main_path(tmp, smi, {"in.lj": m_lj["sps"],
                                               "chute": m_gran["sps"]})
    kernels = []
    eam_src = "tpumd_torch/csrc/eam_cellgrid.cu"
    for name, src, replaces, k, m in (
            ("lj_cellgrid", "tpumd_torch/csrc/lj_cellgrid.cu",
             "tpumd/ops/pallas_lj.py:25", k_lj, m_lj),
            ("lj_fene_cellgrid", "tpumd_torch/csrc/lj_fene_cellgrid.cu",
             "tpumd/ops/pallas_lj.py:146", k_fene, m_fene),
            ("eam_rho_cellgrid", eam_src, "tpumd/ops/pallas_eam.py:99",
             k_rho, m_rho),
            ("eam_force_cellgrid", eam_src, "tpumd/ops/pallas_eam.py:128",
             k_force, m_force),
            ("charmm_cellgrid", "tpumd_torch/csrc/charmm_cellgrid.cu",
             "tpumd/ops/pallas_charmm.py:43", k_charmm, m_charmm),
            ("gran_cellgrid", "tpumd_torch/csrc/gran_cellgrid.cu",
             "tpumd/ops/pallas_gran.py:42", k_gran, m_gran),
            ("row_gather", "tpumd_torch/csrc/row_gather.cu",
             "tools/probes/gather_probe.py:37", k_gather, m_gather)):
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": m["launches"],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            "library_ms": k.get("library_ms")})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

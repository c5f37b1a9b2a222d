#!/usr/bin/env python3
"""Chip check of the tpumd_torch port on one CUDA card.

Run from the repository root: ``python3 chip_smoke.py``.  Phases, one
line each (any failure raises and exits non-zero):

1. environment: card name and power limit (nvidia-smi), torch, CUDA, nvcc;
2. build: one nvcc per source of tpumd_torch/csrc, all at once, into
   build/ (or the cached library);
3. kernels against their plain versions on the card, f32 and f64, every
   energy/virial flag combination:
   - LJ (B1) over the pair list (built by the list kernel) on perturbed
     fcc lattices at the 32k in.lj grid (11^3 cells, cap 40) and the
     864-atom grid (3^3, cap 52), against the plain list sweep and the
     stencil oracle;
   - LJ+FENE (B2) over the set-up's pair list on the generated chain
     decks' grids after setup: the 32k chain grid (11^3, cap 40), a 2^3
     grid where bonds count at the minimum image, and that grid with one
     bond stretched to 2 sigma, past cutneigh; against the plain list
     sweep and the stencil oracle; and the chain's list build against its
     plain build as arrays;
   each timed at its 32k shape in the order plain, kernel, kernel, plain,
   beside its bound (the larger of this input's in-range pair arithmetic
   over the f32 peak and its bytes over the memory rate; a list sweep's
   the work's, with the list's bytes printed beside it as a floor of the
   design);
4. main path, in.lj: the 6^3 deck on the card against the CPU (f64, step
   40), then the 32k deck through LammpsScript in f32: step-0 and step-100
   gates, 500 warm-up and 500 timed steps, the launch counts of that run
   (B1 once per force evaluation, the list build once per grid set-up and
   rebuild, the refresh once per step without a re-bin, and the
   refreshes it took) and a profile of 100 steps; then 19 steps more, to
   the end of a re-bin window, where B1 over the carried list equals the
   stencil oracle (both in f64 on that state); and the list's upkeep at
   that state: the build against the plain build, the refresh's gate with
   no atom past skin/2 (the list untouched) and a rebuilding refresh (=
   the plain build), each timed beside its bound, with the host time a
   wrapper call takes to enqueue;
   then the script layer: LAMMPS's bench/in.lj (``IN_LJ_BENCH``) through
   LammpsScript with x, y and z 3, the path of ``python -m tpumd_torch -var
   x 3 -var y 3 -var z 3``: 864,000 atoms in f32, the lj864 step-0 and
   step-100 gates, a timed 500-step window, the launch counts of that run
   (as for in.lj) and a profile of 100 steps, then B1 against its plain
   list sweep and the list build against its plain build as arrays at that
   shape, each timed beside its bound; ``python -m tpumd_torch -in in.lj
   -var x 1 -var y 1 -var z 1 -log`` in a process of its own, its logged
   rows behind in.lj's gates; and the drift protocol on the 32k drift deck
   (shift yes, dt 0.001) in f64 (gate 1e-6) and f32 (gate 2e-4), in.lj's
   own drift printed; the analysis layer, right after in.lj's main path:
   the six analysis goldens (tests/golden/computes, temp_variants,
   struct_computes, store_histo, chunk_family, dipole) verbatim in f64,
   every file and thermo column against the reference binary's
   (``tpumd_torch.analysis_goldens.failures``), each with its force kernel
   launched (P1, B1 or B5) and no plain call; ``IN_LJ_ANALYSIS32K`` at 6^3 in
   f64 (the pe/atom and stress/atom identities at 1e-12 on every row) and
   at 32k in f32 (in.lj's step-0 and step-100 gates, the identities at
   1e-5 on every row, B1 once per force evaluation with its per-atom
   variant once per output state, the list kernel once per grid set-up,
   rebuild and occasional list; at step 1000 rdf's counts, coord/atom and
   cna/atom equal to their plain all-pairs versions and centro/atom to
   1e-10, in f64), a timed 500-step window with its outputs beside
   in.lj's timesteps/s, the host ms of an output step by compute and of
   the dump write, the device ms of each distance compute and of the
   occasional list build (profiler), and that build against its plain
   build, timed beside its bound;
5. main path, chain: a 500-atom chain deck on the card against the CPU (f64,
   RanMars langevin on both, step 40), then the 32k chain deck in f32 with
   the device RNG: step-0 and step-100 gates, 500 warm-up and 500 timed
   steps, the launch counts of that run (B2 once per force evaluation,
   the list build once per grid set-up and rebuild), the cost of the
   per-step rebuild check and a profile of 100 steps;
6. main path, eam: the EAM density (B3) and force (B4) kernels, both
   over the pair list, against their plain list sweeps and their stencil
   oracles on perturbed fcc lattices of the generated Cu-like potential
   at the 32k in.eam grid (12^3, cap 32) and a 2^3 grid, f32 and f64,
   every flag combination, each timed at its 32k shape beside its bound;
   a 500-atom eam deck on the card against the CPU (f64, step 40); then
   the 32k in.eam deck through LammpsScript in f32: step-0 and step-100
   gates, 500 warm-up and 500 timed steps, the launch counts of that run
   (B3 and B4 once per force evaluation, the list's builds, refresh
   launches and refreshes: delay 5) and a profile of 100 steps; B3 and B4
   over the carried list against their stencil oracles 4 steps later
   (f64); the list's upkeep as for in.lj;
7. main path, rhodo_class: on the 32k rhodo_class grid and the 2^3
   peptide grid after set-up, f32 and f64, the pair list build kernel
   against the plain build (live entries as arrays, counts, longest row,
   overflow flag; with each G of the build forced), and the
   lj/charmm/coul/long kernel (B5) over that list against the plain list
   sweep and the stencil oracle in every flag combination; both timed at
   the 32k shape beside their bounds (B5's with and without the list's
   bytes), with their registers and spills; the 2,004-atom peptide with
   the rhodo_class settings on the card against the CPU (f64, step 40);
   then the 32,064-atom deck through LammpsScript in f32: the reference
   binary's step-0 and step-100 gates, the PPPM mesh, 500 warm-up and 500
   timed steps, the launch counts of that run (B5 once per force
   evaluation, the build once per grid set-up and rebuild, the refresh
   launches and refreshes of delay 5), B5 over the final list against the
   stencil oracle in f64 on the final state, a profile of 20 steps, the
   step's parts and the refresh's gate at the final state; then every
   water golden verbatim (dump lines included) in f64 on the grid:
   water_nve, water_shake and water_npt (fix npt iso) with their dumped
   forces, rattle_water, rigid_water, rigid_nvt_water and rigid_npt_water,
   each last thermo row against the reference binary's files, B5 launched
   once per force evaluation; and tests/golden/tri_npt's two decks (fix
   npt tri; aniso on a tilted box) in f64 on the matrix engine against the
   reference binary's numbers, P1 launched;
   then the 4x4x5 water decks (``water30k_phase``: water_npt30k, 30,000
   atoms under SHAKE and LAMMPS's default fix npt iso line, and
   rigid_npt30k, 10,000 bodies under fix rigid/npt iso): an f64 run to
   step 100, then in f32 from its velocities the step-0 gates, the
   step-100 row against the f64 run's, 500 timed steps after 100, the
   launch counts (B5 once per force evaluation, the list at each grid
   set-up and rebuild, no plain call), the SHAKE or body geometry at the
   end, a profile of 20 steps, the step's parts, and B5 and the list build
   at this shape beside their bounds;
8. main path, chute: the pair list build on each grid's p p fs box with
   the base-base pairs dropped against its plain build as arrays, and the
   gran/hooke/history kernel (B6) over the list against the plain list
   sweep and the stencil oracle on the card, f32 and f64, both
   shearupdate values, on the 32k chute grid after set-up and 10 steps and
   on generated packs' grids with a 2-cell periodic axis (5x2x3) and a
   2-cell non-periodic one (5x5x2), the history as it is and scaled by 40
   (slipping contacts), history tags equal; both timed at the 32k shape
   in the order plain, kernel, kernel, plain beside their bounds, B6 with
   its registers and spills; a 480-sphere chute deck on the card against
   the CPU (f64, step 40); then the 32,000-sphere deck through
   LammpsScript in f32: step-0 and step-100 gates, 500 warm-up and 500
   timed steps, the launch counts of that run (B6 once per force
   evaluation, the list build once per grid set-up and rebuild) and a
   profile of 100 steps;
9. the granular workflow: tests/golden/gran's four decks (granwall,
   granhertz, pour on the grid, granhooke on the matrix engine) verbatim in
   f64 against the reference binary's logs at rel 2e-6, B6 launched once
   per force evaluation (its HERTZ variant on granhertz) or P1 on the
   matrix engine, and tests/golden/wall_lj93 against its thermo.csv at rel
   1e-7; granhertz32k (``IN_GRANHERTZ32K``, 32,474 spheres in a silo) in
   f64 to step 500 behind the analytic step-0 ke and tpumd's f64 rows,
   then B6 HERTZ against its plain list sweep and the stencil oracle at
   that state (f32 and f64, both shearupdate values, the history as it is
   and scaled by 40), timed beside its bound; in f32 the rows of steps 100
   and 500 against the f64 run's, 500 timed steps, the launch counts, the
   largest contact count and a profile of 20 steps, both runs failing
   if any sphere touched more than KH = 12 others in a sweep (B6's
   hist_over: its contacts past the 12th would lose their history); pour20k
   (``IN_POUR20K``: two insertions of fix pour onto a 1,600-sphere floor)
   in f64 and f32, the atom count of every row equal to the stored counts,
   B6 once per force evaluation, the insertions' and re-set-ups' host
   times, the f32 run's last ke against the f64 run's;
10. the matrix neighbor engine: the row gather (P1) against its plain
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
   call, P1's launch counts of those runs and a profile of 20 steps;
11. the pair-style library and kspace on the matrix engine: the eight
   pair goldens (tests/golden/pair_born, pair_ljexpand, pair_couldebye,
   pair_table and wolfdsf's four decks) verbatim in f64, every printed
   row against the reference binary's to its printed digits
   (``tpumd_torch.pair_goldens.failures``), and the 21 reference decks of
   tpumd's pair tests against the reference binary's numbers, P1 launched
   on each and no plain call; then the molten salt (``salt_path``):
   ``IN_SALT32K_DSF`` (32,768 ions, born/coul/dsf) in f64 against
   log.borndsf's step 0 (epair, ecoul, the virial pressure) and
   ``IN_SALT32K`` (born/coul/long under PPPM 1e-4) in f64 against the
   Ewald sum and the 512-ion PPPM rows per ion, then in f32 from the f64
   deck's velocities: step-0 forces and the step-100 row against f64,
   1,000 steps without a NaN, the energy drift, 500 timed steps, P1's
   launches (at least one per force evaluation, no plain call, no grid
   kernel), a profile of 20 steps, PPPM's device ms a step and P1 at
   the deck's packed-row shape beside its bound, the plain version and
   torch.index_select (bit-equal to the plain version on every kind of
   input the set-up gave it); the DSF deck in f32, 500 timed steps;
12. the bonded-style library (``bonded_goldens_phase``, ``hyb32k_path``,
   ``hyb32k_grid_path``): the 14 bonded goldens (``tpumd_torch.bonded_goldens``)
   verbatim in f64 on the card, their rows and dumps against the
   reference binary at tpumd's tests' tolerances and against the same
   decks on the CPU, P1 launched on each (B1's special-weighted variant
   on the seven that "auto" puts on the grid) and no plain call, bond_quartic's
   broken bonds counted; water_shake forced onto the matrix engine against
   its log and dump; then ``IN_HYB32K`` (the in.hyb liquid, 32,000 atoms):
   the cell (``hyb_cell``) in f64 against tpumd's rows at steps 0 and 100,
   the 32k deck in f64 at step 0 against 125 x the cell's energies and the
   cell's virial pressure; each term alone (the pair, each bonded
   sub-style) in f32 on the f64 run's step-100 positions against f64
   there; then in f32 from the f64 deck's velocities: set-up time,
   step-0 forces and the step-100 row against f64, 500 timed
   steps after 100 of warm-up, 1,000 steps without a NaN, a lost atom or
   a neighbour overflow, the energy drift, P1's launches (at least one per
   force evaluation, no plain call, no grid kernel), a profile of 20
   steps, and P1 at the deck's packed-row shape beside its bound, the
   plain version and torch.index_select (bit-equal to the plain version on
   every kind of input the set-up gave it), all of it on the matrix
   engine (forced); then IN_HYB32K on the grid, where "auto" sends it: f64
   step 0 = the matrix engine's row to 1e-10, step 100 to 1e-7, B1's
   special-weighted variant (B1-special) at that state against its plain
   list sweep (f32 2e-6, f64 1e-13 of max|f|) and the stencil oracle,
   timed beside its bound and beside B1 without the weights; in f32 the
   step-0 and step-100 gates against the f64 grid run, 500 timed steps
   beside the matrix engine's, B1-special once per force evaluation, the
   list's launches, a profile and the build at the final state;
13. the host fixes and the minimizer (``host_goldens_phase``,
   ``min_path``, ``pressber_path``, ``deform_path``): tests/golden/
   fix_forces, press_ber, deform and fix_move verbatim in f64 on the grid,
   every thermo.csv row at 2e-6, and min_cg (1,000 cg iterations) to
   efinal.txt at 1e-8, B1 launched and no plain call; ``IN_LJ_MIN32K``
   (in.lj's box displaced, cg, displaced again, fire) in f64 and f32: each
   minimum's pe/atom at the lattice's (f64 1e-9; in f32 the deck's final
   pe within 3x the CPU's gap of the lattice of its f32 box, each
   minimum's gap split into that box's lattice, the positions' distance
   from it in f64 and the f32 rounding), B1 launches = force evaluations,
   iterations, host reads and ms an iteration; ``IN_PRESSBER32K`` and
   ``IN_DEFORM32K`` (the goldens replicated 4x4x4, 32,000 atoms) in f64
   (every golden row at 2e-6) and f32 (each column within 3x the CPU's
   gap), B1 launches = force evaluations (one more at each segment's end,
   before the box moves), the deform deck 500 steps more, its box 1.1 and
   0.95 times the start; timesteps/s and a profile of 20 steps; B1 over
   each final list against its stencil oracle in f64; B1 in f32, the
   list build (and where the deck refreshes, the refresh) at each final
   state against their plain versions, timed;
14. the many-body styles and EAM on the matrix engine (``manybody_phase``,
   ``sw32k_path``, ``tersoff32k_path``, ``eamalloy32k_path``): sw's and
   tersoff's forces, energy and virial with the neighbour rows gathered
   by P1 against the plain gather (f64, 512 atoms); the two MEAM goldens
   (tests/golden/meam) and the atm golden (6^3 cells under
   hybrid/overlay) in f64 against the reference binary's rows; a small
   deck of tersoff/mod, tersoff/zbl, vashishta, edip, eam/fs, eam/he,
   adp, eim and a hybrid/scaled of lj/cut with sw, each on the card
   against the CPU at step 10 (f64, 1e-10), P1 launched and no plain
   call; then ``IN_SW32K`` and ``IN_TERSOFF32K`` (LAMMPS's
   bench/POTENTIALS/in.sw at 32,000 Si atoms) and ``IN_EAMALLOY32K`` (the
   two-element Cu/Al cell replicated 5^3): in f64 the step-0 gates (the
   lattice's pe/atom and virial pressure from tpumd; for the alloy 125x
   the cell's energies and its forces replicated), the step-100 row and
   forces; in f32 from the f64 deck's velocities and types the step-100
   row against f64 (3x the CPU's gap), 500 (alloy: 200) timed steps after
   100, 1,000 steps without a NaN, a lost atom or a neighbour overflow,
   the energy drift, P1's launches (no plain call, no grid kernel), peak
   memory, a profile of 20 steps, f32 forces on the f64 run's step-100
   positions against f64 there, and P1 at the deck's neighbour-row
   shape beside its bound, the plain version and torch.index_select;
15. DPD, TIP4P and the kspace layer on the matrix engine
   (``kspace_goldens_phase``, ``tip4p30k_path``, ``dpd32k_path``): the six
   goldens of ``tpumd_torch.kspace_goldens`` (dpd, tip4p, msm, pppm_disp's
   two decks, pppm_stagger, ewald_disp) and the pppm/ad and pppm/cg water
   decks in f64 on the card, the goldens against the reference binary's
   files at tpumd's tests' tolerances and every deck's rows against the
   same deck on the CPU; then ``IN_TIP4P30K`` (tests/golden/tip4p's water
   replicated 4x4x5, 30,000 atoms under pppm/tip4p) and ``IN_DPD32K``
   (bench/POTENTIALS/in.dpd, 32,000 particles): in f64 the step-0 row
   against the port's CPU f64 row, f32 on the f64 step-100 state against
   f64 at 3x the CPU's gaps; in f32 from the f64 velocities 1,000 steps
   without a NaN, a lost atom or an overflow (DPD32K's mean temperature
   within 5 % of the 10^3-cell CPU run's), 200 (TIP4P) or 500 (DPD)
   timed steps, P1's launches a force evaluation (no plain call, no grid
   kernel), peak memory, a profile of 20 steps, and P1 at the deck's
   packed j rows beside its bound and torch.index_select;
16. the output and input remainders and the NEMD and reactive fixes
   (PR 21): the ten goldens of tpumd_torch.remainder_goldens verbatim in
   f64 (the reference binary's files, the CPU's rows, B1 or P1 launched);
   IN_KAPPA32K on the grid (f64 steps 0 and 100 = the CPU's rows to 1e-9,
   the momentum, the drift; f32 to step 1000: B1 = force evaluations,
   ave/grid's hot slab hotter than its cold one, the swap with no host
   sync, the dumps' host ms), IN_BONDCREATE32K (f64 step 0 and the
   step-5 bonds = the CPU's, every event's caps, lengths and dump local
   rows; f32 on the matrix engine, an event's ms) and IN_CHAIN_RESPA32K
   (f64 step 0, respa 2 1 = verlet over 100 steps; f32 respa 2 2 within
   its energy bound), each with 500 timed steps, host reads per 1,000
   steps, a profile and peak memory, and B1 or P1 at its state;
17. the one-card parallel layer and atom_style ellipsoid:
   ``balance32k_phase`` (balance 1.1 rcb and fix balance 50 1.0 rcb with 8
   parts on the 32k in.lj deck on the matrix engine in f64, against the
   run without them: rows to 1e-12 and 1e-9, the printed and logged
   lines, P1 bit-equal on its inputs and timed at its packed rows),
   ``rk_split_phase`` (rhodo_class in f64: the split, k-space on a side
   stream, = the fused evaluation to 1e-11; both, the r-space part and
   PPPM timed by CUDA events and the host clock, each stream's kernels and
   their overlap under the profiler, the first host read in each half) and
   ``ellipsoid_card_vs_cpu`` (512 ellipsoids, 50 steps in f64, card = CPU,
   the fields by tag);
18. the multi-device decomposition, ``decomp_path``: lj864's and
   eam32k's global grids cut into the local grids of 4 z-slabs and of
   2 x 2 pencils on the one card, assembled by index with the halos'
   seam shift, the list kernel and B1 (eam: B3, F' of the halo slots by
   index, B4) on each against the global launch, owned row by row (f32
   1e-6 of max|f|, f64 1e-13; bit-equal or not, printed), B1, B3, B4 and
   the build timed at rank 0's 4-slab grid and P1 at rank 0's rows of
   the 32k matrix deck in 4 blocks; then min(4, the card count) NCCL
   workers (``parallel/launch.py``) run lj864 in f32 (step 0 = the
   one-card row, step 100 behind lj864's gates, 100 timed steps), eam32k
   in f64 (rows = a one-card run's to 1e-10) and in.lj 32k on the matrix
   engine's row blocks, each rank's launches = its force evaluations, its
   collectives a step by kind (none an all-gather on the grid), exchange
   ms and bytes a step and timesteps/s beside the one-card run's; a
   failed worker fails the phase;
19. the molecular stack decomposed, ``decomp_molecular_path``:
   IN_WATER_SHAKE30K (30,000 atoms, lj/charmm/coul/long, pppm, fix shake)
   on one card with ``bonded_grid`` on and off (f64 rows equal to 1e-10,
   f32 timesteps/s of each); at the f64 state 100 steps on, the local
   grids of 4 z-slabs and 2 x 2 pencils assembled by index: B5's
   owned-rows variant (B5-rows) bit-equal to the global B5-rows launch
   and within TOL_LIST of its plain version, f32 and f64, the tag-matched
   bonded forces and SHAKE deltas = the tag-order view's and the slot-map
   path's per owned atom to 1e-12; B5-rows, the local list build and
   ``match_members`` timed; then the deck over min(4, cards) NCCL ranks:
   f64 rows at steps 0 and 20 = one card's to 1e-10, f32 step 0 to 1e-4,
   SHAKE's residuals at step 100 under 1e-4, B5-rows launches = force
   evaluations, the collectives a step by kind (no all-gather), pppm's
   mesh bytes and the exchange's ms;
20. a JSON line of the kernels (the list build of each deck, the refresh
   calls of in.lj, eam, rhodo_class, min32k, deform32k, kappa32k and
   hyb32k's grid run, B1 on min32k, pressber32k, deform32k, kappa32k and
   the replica decks, B1-special at hyb32k's grid, B5 at each 30k water
   deck's shape, B6's HERTZ variant at granhertz32k's and P1 at the
   salt's, hyb32k's, sw32k's, tersoff32k's, eamalloy32k's, tip4p30k's,
   dpd32k's, bondcreate32k's, respa32k's and balance32k's, and B1, B3,
   B4, the build and P1 of the decomposed runs, B5-rows and the build
   of the decomposed water deck, each an entry of its own),
   the card's name and power limit as nvidia-smi prints them, then the
   result line.

Every time in the kernels line (``cuda_ms``) is CUDA events around many
calls, queued 16 at a time behind a spin kernel, so that the card runs
them back to back whatever the host's dispatch costs.  A deck's build
entry takes its times and bound at that deck's shape; a deck's refresh
entry those of a gate that passes and, where the deck took refreshes, of
a rebuilding refresh, averaged over the main path's calls
(``upkeep_entries``).

Imports nothing of JAX or tpumd.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.metadata
import io
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
# B6's and B2's forces (and torques) against their plain list sweeps, the
# same pairs in the same order: f32 differs by the lanes' summation order
# only; energies and virial, sums over all atoms, keep TOL
TOL_LIST = {torch.float64: 1e-13, torch.float32: 2e-6}
# B1's and B4's forces against their stencil oracles: the same pairs in
# another order (f32), rounded alike but summed otherwise (f64)
TOL_ORACLE = {torch.float64: 1e-12, torch.float32: 2e-6}

# published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
# cores, and the HBM3 memory rate
PEAK_F32_FLOPS = 67e12
# f64 outside the tensor cores (the same data sheet)
PEAK_F64_FLOPS = 34e12
PEAK_BYTES_PER_S = 3.35e12
# cycles of torch.cuda._sleep a millisecond: at most the H100's 1.98 GHz
# top SM clock, so a spin lasts at least as long as asked
SPIN_CYCLES_PER_MS = 2_000_000
# calls timed behind one spin: their launches stay well inside the card's
# queue of pending launches, past which the host would wait for the spin
SPIN_CHUNK = 16
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
    """Slot-ordered positions, validity, box, grid and pair list (pairs,
    npairs, rows; built by the list kernel as a re-bin builds it) of an
    fcc lattice of nlat^3 cells: in.lj's, each atom moved by up to +-0.05
    sigma per axis, or with eam in.eam's (3.615 A, cutneigh 5.95 A), moved
    by up to +-0.15 A."""
    from tpumd_torch.core.create import create_atoms_lattice
    from tpumd_torch.core.lattice import Lattice
    from tpumd_torch.core.state import Box, make_state, wrap_pbc
    from tpumd_torch.ops import cellgrid as cg
    from tpumd_torch.ops.cellgrid_pairlist import cellgrid_pairlist
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
    s = cg.apply_permutation(s, perm, valid)
    pairs, npairs, _, over = cellgrid_pairlist(
        s.x, valid, s.tag, None, None, box, cfg,
        cg.pairlist_kmax(box, cutneigh, len(x)))
    if bool(over):
        raise AssertionError("pair list overflow in the test lattice")
    return s.x, valid, box, cfg, (pairs, npairs,
                                  cg.row2slot_from_tags(s.tag, len(x)))


def cuda_ms(fn, reps: int, ahead: bool = True) -> float:
    """Time per call of fn on the card: CUDA events around reps calls, in
    chunks of at most SPIN_CHUNK calls each queued behind a spin kernel
    (torch.cuda._sleep) that outlasts the host's enqueueing of the chunk,
    so that the events time the card's work back to back and not the
    host's dispatch of each call (a kernel of a few microseconds takes
    less than its wrapper's dispatch); a chunk keeps the launches in
    flight well inside the card's queue.  Every time in the kernels line
    comes from here.  Where the host cannot get ahead (fn waits on the
    card, as a plain version reading a flag does) the time includes the
    dispatch; with ahead that raises after a longer spin has been tried
    twice."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    c, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    total = 0.0
    for start in range(0, reps, SPIN_CHUNK):
        n = min(SPIN_CHUNK, reps - start)
        for _ in range(3 if ahead else 1):
            spin_ms = min(1.5e3 * host * n + 0.5, 4000.0)
            t0 = time.perf_counter()
            c.record()
            torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
            a.record()
            for _ in range(n):
                fn()
            b.record()
            enq_ms = 1e3 * (time.perf_counter() - t0)
            torch.cuda.synchronize()
            covered = enq_ms < c.elapsed_time(a)
            if covered:
                break
            host = 2e-3 * enq_ms / n
        if ahead and not covered:
            raise AssertionError(
                f"cuda_ms: the host took {enq_ms:.3f} ms to enqueue {n} "
                f"calls, longer than the {c.elapsed_time(a):.3f} ms spin "
                f"before them")
        total += a.elapsed_time(b)
    return total / reps


def host_us(fn, n: int = 100) -> float:
    """Host microseconds a call of fn takes to enqueue, the calls queued
    behind a 200 ms spin kernel so that none waits on the card: what a
    wrapper adds to a host-bound step."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200 * SPIN_CYCLES_PER_MS)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    return us


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


def box_f64(box):
    from tpumd_torch.core.state import Box
    return Box(lo=box.lo.double(), hi=box.hi.double())


def roof(ops: int, nbytes: int,
         peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    """Least time (ms) the card could take: ops over the peak (f32's
    unless given), or the bytes read and written once over the memory
    rate, whichever is larger."""
    t_ops = ops / peak
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def bound(nlj: int, nbond: int, nbytes: int,
          peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    """roof() of nlj non-bonded and nbond bonded unordered pairs."""
    return roof(nlj * (OPS_LJ_PAIR + OPS_ACCUM)
                + nbond * (OPS_BOND_PAIR + OPS_ACCUM), nbytes, peak)


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


def time_kernel(name, kernel, plain, kernel_ev, reps=200,
                shape="32k", dtype="f32") -> dict:
    """plain, kernel, kernel, plain; then the kernel with energy+virial."""
    p1 = cuda_ms(plain, 10, ahead=False)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, 10, ahead=False)
    ke = cuda_ms(kernel_ev, reps)
    phase("kernel", f"{name} at the {shape} shape, {dtype} forces: kernel "
                    f"{k1:.4f} "
                    f"/ {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms; kernel "
                    f"with energy+virial {ke:.4f} ms; the wrapper's host "
                    f"enqueue {host_us(kernel):.1f} us a call")
    return {"ms": min(k1, k2), "plain_ms": min(p1, p2), "ev_ms": ke}


def check_list_sweep(what, kernel, list_plain, oracle, dtype, eflag,
                     vflag) -> tuple[float, float]:
    """A list sweep's outputs (f, energy, virial) against its plain list
    sweep (forces to TOL_LIST) and its stencil oracle (to TOL_ORACLE),
    energies and virial to TOL; (its force errors relative to max|f|)."""
    errs = []
    for ref, out, tol in (("list", list_plain, TOL_LIST),
                          ("stencil", oracle, TOL_ORACLE)):
        err = check_close(f"{what} vs {ref}", kernel[0], out[0],
                          (kernel[1],), (out[1],), kernel[2], out[2],
                          TOL[dtype], eflag, vflag)
        if err > tol[dtype]:
            raise AssertionError(f"{what}: forces {err} of max|f| from the "
                                 f"{ref} sweep > {tol[dtype]}")
        errs.append(err)
    return tuple(errs)


def lj_kernel_vs_plain() -> dict:
    """B1 over the list against its plain list sweep and the stencil
    oracle on perturbed in.lj lattices (the 32k grid, 11^3 cells of cap 40,
    and the 864-atom 3^3 grid), f32 and f64, every flag; timed and bounded
    at the 32k shape."""
    from tpumd_torch.ops.lj_cellgrid import LJCoeffs, lj_cellgrid, \
        lj_cellgrid_plain, lj_pairlist_plain
    c = LJCoeffs(48.0, 24.0, 4.0, 4.0, 0.0, 6.25)
    out = {}
    for nlat in (20, 6):
        for dtype in (torch.float32, torch.float64):
            x, valid, box, cfg, plist = perturbed_grid(nlat, 7 + nlat, "cuda",
                                                       dtype)
            worst = (0.0, 0.0)
            for eflag, vflag in ((0, 0), (1, 1), (1, 0), (0, 1)):
                errs = check_list_sweep(
                    f"lj {nlat}^3 {dtype} e{eflag}v{vflag}",
                    lj_cellgrid(x, valid, box, cfg, c, eflag, vflag, plist),
                    lj_pairlist_plain(x, box, c, eflag, vflag, *plist[:2]),
                    lj_cellgrid_plain(x, valid, box, cfg, c, eflag, vflag),
                    dtype, eflag, vflag)
                worst = tuple(map(max, worst, errs))
            phase("kernel", f"lj_cellgrid grid {cfg.nx}x{cfg.ny}x{cfg.nz} "
                            f"cap {cfg.cap} K {plist[0].shape[1]} "
                            f"{str(dtype)[6:]}: max|f_kernel - f_plain| = "
                            f"{worst[0]:.3g} max|f| against the plain list "
                            f"sweep (tol {TOL_LIST[dtype]:g}), {worst[1]:.3g}"
                            f" against the stencil oracle (tol "
                            f"{TOL_ORACLE[dtype]:g}); energy and virial "
                            f"within {TOL[dtype]:g} of both")
            if nlat == 20 and dtype == torch.float32:
                fk, _, _ = lj_cellgrid(x, valid, box, cfg, c, 0, 0, plist)
                fp, _, _ = lj_pairlist_plain(x, box, c, 0, 0, *plist[:2])
                out["max_abs_err"] = float((fk - fp).abs().max())
                out.update(time_kernel(
                    "lj_cellgrid",
                    lambda: lj_cellgrid(x, valid, box, cfg, c, 0, 0, plist),
                    lambda: lj_pairlist_plain(x, box, c, 0, 0, *plist[:2]),
                    lambda: lj_cellgrid(x, valid, box, cfg, c, 1, 1, plist)))
                stencil_ms = cuda_ms(lambda: lj_cellgrid_plain(
                    x, valid, box, cfg, c, 0, 0), 10, ahead=False)
                nlj, _ = pair_counts(x, valid, box, cfg, c.cutsq)
                np_ = cfg.capacity
                natoms = int(valid.sum())
                # the work: x and validity read, f written
                nbytes = np_ * (12 + 1 + 12) + 12
                out["bound_ms"], out["bound_by"] = bound(nlj, 0, nbytes)
                floor = (4 * int(plist[1].sum()) + 4 * np_ + 8 * natoms)
                floor_ms, floor_by = bound(nlj, 0, nbytes + floor)
                entries = int(plist[1].sum())
                phase("kernel", f"lj_cellgrid bound: {nlj} unordered "
                                f"in-cutoff pairs ({2 * nlj / entries:.2%} "
                                f"of {entries} list entries, "
                                f"{entries / natoms:.2f} a row), {nbytes} "
                                f"bytes -> {out['bound_ms']:.6f} ms "
                                f"({out['bound_by']}); the list's floor: "
                                f"{floor} bytes more -> {floor_ms:.6f} ms "
                                f"({floor_by}); the stencil oracle "
                                f"{stencil_ms:.4f} ms")
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


def stretched_chain(sim, tag_a: int = 2, tag_b: int = 1, r: float = 2.0):
    """The grid-ordered state and grid state of a set-up chain deck with
    atom tag_b moved to distance r of its partner tag_a (past cutneigh),
    in the direction of 256 seeded tries farthest from every other atom,
    re-binned by the set-up's own grid code (a fresh list and bond
    slots)."""
    from tpumd_torch.ops import cellgrid as cg
    s, neigh, _ = sim._carry
    c = cg.compact_state(s, neigh.valid, sim.natoms)
    x = c.x.double().cpu().numpy()
    tag = c.tag.cpu().numpy()
    L = c.box.lengths.double().cpu().numpy()
    a, b = (int(np.nonzero(tag == t)[0][0]) for t in (tag_a, tag_b))
    u = np.random.default_rng(4).normal(size=(256, 3))
    cand = x[a] + r * u / np.linalg.norm(u, axis=1, keepdims=True)
    others = np.delete(x, [a, b], axis=0)
    best, far = None, -1.0
    for k in range(len(cand)):
        d = cand[k] - others
        d -= L * np.round(d / L)
        near = float(np.sqrt((d * d).sum(1)).min())
        if near > far:
            best, far = cand[k], near
    x[b] = best % L
    return sim._grid_setup(c.replace(x=torch.as_tensor(
        x, dtype=c.x.dtype, device=c.x.device)))


def gran_bytes(natoms: int, npairs) -> int:
    """The bytes B6 must move in f32 for natoms spheres: per sphere, read
    x, v, omega, radius, rmass (11 floats), gmask, tag, valid (9 bytes),
    its list row's count and index (12 bytes) and its old tags and shear
    (12 + 36 words), written f, torque (6 floats) and the new tags and
    shear; the list's live entries (npairs: 4 bytes each) and the box.
    The kernel also zeroes the empty slots' outputs, which the function
    does not need."""
    return (natoms * (4 * (11 + 6) + 9 + 12 + 2 * 4 * (12 + 36))
            + 4 * int(npairs.sum()) + 12)


def list_floor_bytes(neigh, natoms: int, extra_per_slot: int = 0) -> int:
    """The bytes a sweep reads of its list: the live entries, the row
    counts, the valid slots' rows (int64) and extra_per_slot bytes a
    slot (bond slots)."""
    np_ = neigh.npairs.shape[0]
    return (4 * int(neigh.npairs.sum()) + 4 * np_ + 8 * natoms
            + extra_per_slot * np_)


def build_bound(valid, cfg, npairs, S: int, gmask: bool,
                isz: int = 4) -> tuple:
    """(bound ms, bound_by, bytes, candidates) of a list build: x (isz
    bytes a coordinate), valid, tag, the special lists and group bits read
    once, the list's live entries (4 bytes each: npairs), its counts and
    the status words written once, and d, r2 and the cutoff test (9
    operations in x's dtype) per candidate of the stencil's 27 cells up to
    each cell's extent."""
    np_ = cfg.capacity
    nbytes = (np_ * (3 * isz + 1 + 4 + 8 * S + (4 if gmask else 0))
              + 3 * isz + 4 * int(npairs.sum()) + 4 * np_ + 16)
    occupied = valid.view(cfg.ncells, cfg.cap).sum(1).double()
    cand = int(valid.sum()) * 27 * float(occupied.mean())
    peak = PEAK_F64_FLOPS if isz == 8 else PEAK_F32_FLOPS
    return roof(int(9 * cand), nbytes, peak) + (nbytes, cand)


def time_build(name: str, bargs, plain_reps: int = 3) -> dict:
    """The list build kernel against its plain build (live entries as
    arrays), with each G of the build forced and by the launch rule, then
    timed by the rule in the order plain, kernel, kernel, plain, beside
    the build's bound (build_bound; the bound with the (Np, K) list
    written whole, that of the design before live entries, beside it)."""
    from tpumd_torch.ops.cellgrid_pairlist import LANES, cellgrid_pairlist, \
        cellgrid_pairlist_plain, new_stat, pairlist_hold
    x, valid, tag, stags, scodes, box, cfg, K = bargs[:8]
    built, plain = check_lanes(f"{name} pair list", bargs)
    if bool(built[3]):
        raise AssertionError(f"{name} pair list: overflow at K {K}")
    # the kernel alone: its hold (each cell's extent, the special
    # partners' slots) and status words made once, as a re-bin makes them
    # once for the build
    hold = pairlist_hold(*bargs[:5], cfg, *bargs[8:10], keep=False)
    stat = new_stat(x.device)
    p1 = cuda_ms(lambda: cellgrid_pairlist_plain(*bargs), plain_reps,
                 ahead=False)
    k1 = cuda_ms(lambda: cellgrid_pairlist(*bargs, stat=stat, hold=hold), 50)
    k2 = cuda_ms(lambda: cellgrid_pairlist(*bargs, stat=stat, hold=hold), 50)
    p2 = cuda_ms(lambda: cellgrid_pairlist_plain(*bargs), plain_reps,
                 ahead=False)
    whole_call = cuda_ms(lambda: cellgrid_pairlist(*bargs), 50)
    S = 0 if stags is None else stags.shape[1]
    excl = len(bargs) > 9 and bool(bargs[9])
    isz = x.element_size()
    bound_ms, bound_by, nbytes, cand = build_bound(valid, cfg, built[1], S,
                                                   excl, isz)
    whole = torch.full_like(built[1], K)
    old_ms, old_by, old_bytes, _ = build_bound(valid, cfg, whole, S, excl,
                                               isz)
    phase("kernel", f"{name} pair list grid {cfg.nx}x{cfg.ny}x{cfg.nz} cap "
                    f"{cfg.cap} K {K} periodic {box.periodic}: the kernel's "
                    f"live entries = the plain build's as arrays for lanes "
                    f"{LANES} and the rule, longest {int(built[2])}, "
                    f"{int(built[1].sum())} entries "
                    f"({float(built[1][valid].double().mean()):.3f} a row); "
                    f"{'f64' if isz == 8 else 'f32'} kernel {k1:.4f} / "
                    f"{k2:.4f} ms (the whole call, "
                    f"its hold made anew: {whole_call:.4f} ms), plain "
                    f"{p1:.4f} / {p2:.4f} ms; bound {nbytes} bytes, {cand:.4g} "
                    f"candidates -> {bound_ms:.6f} ms ({bound_by}); with the "
                    f"(Np, K) list written whole {old_bytes} bytes -> "
                    f"{old_ms:.6f} ms ({old_by})")
    return {"ms": min(k1, k2), "plain_ms": min(p1, p2), "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": live_err(built, plain),
            "call_ms": whole_call}


def time_upkeep(name: str, sim, build: bool = True,
                refresh: bool = True) -> dict:
    """The pair list's upkeep at a main path's final state, each against
    its plain version and timed in the order plain, kernel, kernel, plain
    beside its bound: with build, the build (time_build); the refresh's
    gate with no atom past skin/2, which leaves the list, its positions
    and its status words as they were; and with refresh, a refresh that
    rebuilds (one atom moved 0.6 skin, and back, in turn), whose list
    equals the plain build's as arrays.  The gate's bound: x and the
    list's positions read once, ~18 operations an atom; the rebuilding
    refresh's: the gate's and the build's."""
    from tpumd_torch.ops.cellgrid_pairlist import cellgrid_pairlist, \
        cellgrid_pairlist_plain, new_stat, pairlist_hold, \
        refresh_pairlist, refresh_pairlist_plain
    s, neigh, _ = sim._carry
    h, cfg, K = neigh.list_hold, sim._neigh_cfg, sim._ctx.pairlist_k
    valid = neigh.valid
    bargs = (s.x, valid, h.tag, h.stags, h.scodes, s.box, cfg, K, h.gmask,
             h.exclude_bits)
    out = {}
    if build:
        out["build"] = time_build(name, bargs)

    def fresh(x):
        stat = new_stat(x.device)
        hold = pairlist_hold(x, valid, h.tag, h.stags, h.scodes, cfg,
                             h.gmask, h.exclude_bits,
                             box_term=h.box is not None)
        pairs, npairs, _, _ = cellgrid_pairlist(x, *bargs[1:], stat=stat,
                                                hold=hold)
        return [x, valid, s.box, cfg, pairs, npairs, stat, hold]

    natoms = int(valid.sum())
    np_ = cfg.capacity
    gbytes = np_ * (12 + 12 + 1) + 16 + (48 if h.box is not None else 0)
    gate_bound = roof(18 * natoms, gbytes)
    gate = fresh(s.x)
    before = [t.clone() for t in (gate[4], gate[5], gate[7].x, gate[6][:3])]
    refresh_pairlist(*gate)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(
            (gate[4], gate[5], gate[7].x, gate[6][:3]), before)):
        raise AssertionError(f"{name} refresh gate: a clear gate changed "
                             f"the list")
    times = [cuda_ms(lambda: refresh_pairlist_plain(*gate, 0), 10,
                     ahead=False),
             cuda_ms(lambda: refresh_pairlist(*gate), 200),
             cuda_ms(lambda: refresh_pairlist(*gate), 200),
             cuda_ms(lambda: refresh_pairlist_plain(*gate, 0), 10,
                     ahead=False)]
    out["gate"] = {"ms": min(times[1:3]), "plain_ms": min(times[::3]),
                   "bound_ms": gate_bound[0], "bound_by": gate_bound[1],
                   "max_abs_err": 0.0}
    other = s.x.add(1.0)
    line = (f"{name} refresh gate, no atom past skin/2: list, positions "
            f"and counts unchanged; f32 kernel {times[1]:.4f} / "
            f"{times[2]:.4f} ms, plain {times[0]:.4f} / {times[3]:.4f} ms; "
            f"bound {gbytes} bytes -> {gate_bound[0]:.6f} ms "
            f"({gate_bound[1]}); host enqueue {host_us(
                lambda: refresh_pairlist(*gate)):.1f} us a call (a torch "
            f"elementwise op: {host_us(lambda: other.add_(0.0)):.1f})")
    if refresh:
        k = int(torch.nonzero(valid)[0])
        x1 = s.x.clone()
        x1[k, 0] += 0.6 * cfg.skin
        args = fresh(s.x)
        n0 = int(args[6][2])
        xs = [x1, s.x]

        def toggled(fn, *extra):
            args[0] = xs[0]
            fn(*args, *extra)
            xs.reverse()
        toggled(refresh_pairlist)
        plain = cellgrid_pairlist_plain(x1, *bargs[1:])
        check_pairlist(f"{name} refresh", (args[4], args[5], args[6][0],
                                           args[6][1] != 0), plain)
        if not (torch.equal(args[7].x, x1) and int(args[6][2]) == n0 + 1):
            raise AssertionError(f"{name} refresh: the rebuilt list's "
                                 f"positions or count differ")
        rt = [cuda_ms(lambda: toggled(refresh_pairlist_plain, 0), 3,
                      ahead=False),
              cuda_ms(lambda: toggled(refresh_pairlist), 50),
              cuda_ms(lambda: toggled(refresh_pairlist), 50),
              cuda_ms(lambda: toggled(refresh_pairlist_plain, 0), 3,
                      ahead=False)]
        S = 0 if h.stags is None else h.stags.shape[1]
        b_ms, b_by, b_bytes, cand = build_bound(valid, cfg, plain[1], S,
                                                bool(h.exclude_bits))
        r_bound = roof(int(9 * cand) + 18 * natoms, b_bytes + gbytes)
        out["refresh"] = {"ms": min(rt[1:3]), "plain_ms": min(rt[::3]),
                          "bound_ms": r_bound[0], "bound_by": r_bound[1],
                          "max_abs_err": 0.0}
        line += (f"; a rebuilding refresh = the plain build as arrays, f32 "
                 f"kernel {rt[1]:.4f} / {rt[2]:.4f} ms, plain {rt[0]:.4f} / "
                 f"{rt[3]:.4f} ms, bound {r_bound[0]:.6f} ms "
                 f"({r_bound[1]})")
    phase("kernel", line)
    return out


def list_counts() -> tuple:
    """(build launches, refresh launches, plain calls) of the pair list's
    wrappers since their reset."""
    from tpumd_torch.ops import cellgrid_pairlist as bpl
    return (bpl.counts.kernel_launches, bpl.refresh_counts.kernel_launches,
            bpl.counts.plain_calls + bpl.refresh_counts.plain_calls)


def reset_list_counts():
    from tpumd_torch.ops import cellgrid_pairlist as bpl
    bpl.counts.reset()
    bpl.refresh_counts.reset()


def build_entry(shapes, what: str) -> dict:
    """The list kernels' figures over what from ((name, its phase's
    figures at a deck's shape, that deck's main-path launches of it),
    ...): the times and the bound are means over the main paths'
    launches, so that launches x (ms - bound) is the sum over the shapes;
    bound_by is the word of the shape whose launches take the most of the
    bound."""
    n = sum(nb for _, _, nb in shapes)
    out = {key: sum(k[key] * nb for _, k, nb in shapes) / n
           for key in ("ms", "plain_ms", "bound_ms")}
    out["bound_by"] = max(shapes, key=lambda s: s[1]["bound_ms"] * s[2])[
        1]["bound_by"]
    out["max_abs_err"] = max(k["max_abs_err"] for _, k, _ in shapes)
    phase("kernel", f"cellgrid_pairlist over {what}: " + "; "
          .join(f"{name} {nb} x ({k['ms']:.4f} - {k['bound_ms']:.6f}) ms"
                for name, k, nb in shapes)
          + f"; per launch {out['ms']:.4f} ms, bound {out['bound_ms']:.6f} "
            f"ms ({out['bound_by']}), launches x (ms - bound) "
            f"{n * (out['ms'] - out['bound_ms']):.1f} ms")
    return out


def fene_kernel_vs_plain(tmp: Path) -> dict:
    """B2 over the set-up's pair list against the plain list sweep (to
    TOL_LIST) and the stencil oracle (to TOL) on the 32k chain grid, the
    60-atom 2^3 grid and that grid with one bond stretched to 2 sigma
    (past cutneigh), f32 and f64, every flag; the chain list build
    against its plain build; both timed and bounded at the 32k shape."""
    from tpumd_torch.core.state import Box
    from tpumd_torch.ops.lj_fene_cellgrid import lj_fene_cellgrid, \
        lj_fene_cellgrid_plain, lj_fene_pairlist_plain
    out = {}
    for natoms, chain_len, stretch in ((32000, 100, False),
                                       (60, 10, False), (60, 10, True)):
        script = chain_setup(tmp, natoms, chain_len, "cuda", torch.float64)
        script.run_string("run 0")
        sim = script.sim
        s, neigh, _ = sim._carry
        if stretch:
            s, neigh = stretched_chain(sim)
        cfg, valid, tag, btags = sim._neigh_cfg, neigh.valid, s.tag, \
            s.bond_tags
        plist = (neigh.pairs, neigh.npairs, neigh.bond_slots, neigh.row2slot)
        lj, fene = sim.pair.kernel_coeffs(), sim._ctx.kernel_bond \
            .kernel_coeffs()
        what = f"{natoms}{' stretched' if stretch else ''}"
        for dtype in (torch.float32, torch.float64):
            x = s.x.to(dtype)
            box = Box(lo=s.box.lo.to(dtype), hi=s.box.hi.to(dtype))
            worst = {"list": 0.0, "stencil": 0.0}
            for eflag, vflag in ((0, 0), (1, 1), (1, 0), (0, 1)):
                fk, ek, wk, bk = lj_fene_cellgrid(x, valid, box, cfg, lj,
                                                  fene, eflag, vflag, plist)
                for ref, fp, ep, wp, bp in (
                        ("list", *lj_fene_pairlist_plain(
                            x, box, lj, fene, eflag, vflag, *plist[:3])),
                        ("stencil", *lj_fene_cellgrid_plain(
                            x, valid, tag, btags, box, cfg, lj, fene, eflag,
                            vflag))):
                    worst[ref] = max(worst[ref], check_close(
                        f"lj_fene {what} {dtype} e{eflag}v{vflag} vs {ref}",
                        fk, fp, (ek, bk), (ep, bp), wk, wp, TOL[dtype],
                        eflag, vflag))
                if worst["list"] > TOL_LIST[dtype]:
                    raise AssertionError(
                        f"lj_fene {what} {dtype} e{eflag}v{vflag}: forces "
                        f"{worst['list']} of max|f| from the plain list "
                        f"sweep > {TOL_LIST[dtype]}")
            phase("kernel", f"lj_fene_cellgrid {what} grid {cfg.nx}x{cfg.ny}"
                            f"x{cfg.nz} cap {cfg.cap} K {neigh.pairs.shape[1]}"
                            f" {str(dtype)[6:]}: max|f_kernel - f_plain| = "
                            f"{worst['list']:.3g} max|f| against the plain "
                            f"list sweep (tol {TOL_LIST[dtype]:g}), "
                            f"{worst['stencil']:.3g} against the stencil "
                            f"oracle; lj and bond energies and virial "
                            f"within {TOL[dtype]:g} of both")
            if natoms != 32000 or dtype != torch.float32:
                continue
            args = (x, valid, box, cfg, lj, fene)
            fk, _, _, _ = lj_fene_cellgrid(*args, 0, 0, plist)
            fp, _, _, _ = lj_fene_pairlist_plain(x, box, lj, fene, 0, 0,
                                                 *plist[:3])
            out["max_abs_err"] = float((fk - fp).abs().max())
            out.update(time_kernel(
                "lj_fene_cellgrid",
                lambda: lj_fene_cellgrid(*args, 0, 0, plist),
                lambda: lj_fene_pairlist_plain(x, box, lj, fene, 0, 0,
                                               *plist[:3]),
                lambda: lj_fene_cellgrid(*args, 1, 1, plist)))
            nlj, nbond = pair_counts(x, valid, box, cfg, lj.cutsq, tag,
                                     btags)
            np_ = cfg.capacity
            # the work: x, validity, tags and bond partners read, f written
            nbytes = np_ * (12 + 1 + 4 + 4 * btags.shape[1] + 12) + 12
            out["bound_ms"], out["bound_by"] = bound(nlj, nbond, nbytes)
            floor = list_floor_bytes(neigh, sim.natoms, 4 * btags.shape[1])
            floor_ms, floor_by = bound(nlj, nbond, nbytes + floor)
            entries = int(neigh.npairs.sum())
            phase("kernel", f"lj_fene_cellgrid bound: {nlj} unordered "
                            f"in-cutoff lj pairs and {nbond} bonds "
                            f"({2 * nlj / entries:.2%} of {entries} list "
                            f"entries in the cutoff), {nbytes} bytes -> "
                            f"{out['bound_ms']:.6f} ms ({out['bound_by']});"
                            f" the list's floor: {floor} bytes more -> "
                            f"{floor_ms:.6f} ms ({floor_by})")
            xb = s.x.float()
            out["list"] = time_build(
                "chain", (xb, valid, tag, btags, torch.ones_like(btags),
                          Box(lo=s.box.lo.float(), hi=s.box.hi.float()), cfg,
                          sim._ctx.pairlist_k))
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


def upkeep_phrase(sim, builds: int, gates: int) -> str:
    """The list's launches of a main path: builds (set-ups + rebuilds),
    refresh launches and the refreshes they took."""
    nb = int(sim._carry[1].nbuilds) - 1
    return (f"cellgrid_pairlist builds {builds} = {sim.grid_setups} grid "
            f"set-ups + {nb} rebuilds, refresh launches {gates}, refreshes "
            f"taken {sim.list_refreshes}")


def window_end_check(name: str, script, steps: int):
    """Run steps more steps, to the end of a re-bin window where the list
    is stalest, and hold B1, or B3 and B4, over the carried list against
    their stencil oracles there, all in f64 on the run's f32 state, so that
    rounding leaves them at summation order (TOL_ORACLE) and a pair the
    list missed would show far above it."""
    from tpumd_torch.core.state import Box
    from tpumd_torch.ops.eam_cellgrid import eam_force_cellgrid, \
        eam_force_cellgrid_plain, eam_rho_cellgrid, eam_rho_cellgrid_plain
    from tpumd_torch.ops.lj_cellgrid import lj_cellgrid, lj_cellgrid_plain
    sim = script.sim
    script.run_string(f"run {steps}")
    s, neigh, _ = sim._carry
    cfg = sim._neigh_cfg
    x, box = s.x.double(), Box(lo=s.box.lo.double(), hi=s.box.hi.double())
    plist = (neigh.pairs, neigh.npairs, neigh.row2slot)
    if name == "in.lj":
        c = sim.pair.kernel_coeffs()
        fk = lj_cellgrid(x, neigh.valid, box, cfg, c, 0, 0, plist)[0]
        fo = lj_cellgrid_plain(x, neigh.valid, box, cfg, c, 0, 0)[0]
    tol = TOL_ORACLE[torch.float64]
    rho_note = ""
    if name != "in.lj":
        tab = sim.pair.kernel_tables(x)
        rho_o = eam_rho_cellgrid_plain(x, neigh.valid, box, cfg, tab, 0)
        rho_err = check_rho(f"{name} step {sim.step}, B3 over the list "
                            f"against the stencil", eam_rho_cellgrid(
                                x, neigh.valid, box, cfg, tab, 0, plist),
                            rho_o, tol)
        rho_note = f"; B3's rho and F' to {rho_err:.3g} of their largest"
        fp = rho_o[1]
        fk = eam_force_cellgrid(x, neigh.valid, fp, box, cfg, tab, 0, 0,
                                plist)[0]
        fo = eam_force_cellgrid_plain(x, neigh.valid, fp, box, cfg, tab, 0,
                                      0)[0]
    err = check_close(f"{name} step {sim.step}, list against stencil", fk,
                      fo, (), (), None, None, tol, False, False)
    phase("main", f"{name} step {sim.step} ({neigh.ago} steps after its "
                  f"re-bin), in f64: the sweep over the carried list = the "
                  f"stencil oracle to {err:.3g} max|f|{rho_note} (tol "
                  f"{tol:g}); {sim.list_refreshes} refreshes since set-up")


def main_path(smi: str) -> dict:
    from tpumd_torch.bench_targets import IN_LJ, SANITY, STEP0, STEP0_RTOL, \
        gate_failures
    from tpumd_torch.ops import lj_fene_cellgrid
    from tpumd_torch.ops.lj_cellgrid import counts
    from tpumd_torch.script.parser import LammpsScript

    counts.reset()
    lj_fene_cellgrid.counts.reset()
    reset_list_counts()
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
    builds, gates, list_plain = list_counts()
    plain += list_plain + lj_fene_cellgrid.counts.plain_calls
    refreshes = sim.list_refreshes
    # setup evaluates once; each run of n > 0 steps with thermo 0 is one
    # segment: n in-step evaluations plus one energy evaluation
    force_evals = 1 + (100 + 1) + 2 * (500 + 1)
    list_builds = sim.grid_setups + int(sim._carry[1].nbuilds) - 1
    # every step that does not re-bin gates a refresh (check no)
    unbinned = 1100 - (int(sim._carry[1].nbuilds) - 1)
    if (launches != force_evals or plain != 0 or builds != list_builds
            or gates != unbinned or lj_fene_cellgrid.counts.kernel_launches):
        raise AssertionError(f"kernel launches {launches} != force "
                             f"evaluations {force_evals}, or plain calls "
                             f"{plain} != 0, or list builds {builds} != "
                             f"{list_builds}, or refresh launches {gates} != "
                             f"steps without a re-bin {unbinned}")
    s = sim.state
    if (tuple(s.x.shape) != (sim._neigh_cfg.capacity, 3)
            or not torch.isfinite(s.x).all()
            or sorted(s.tag[s.tag > 0].tolist()) != list(range(1, 32001))):
        raise AssertionError("final state malformed")
    sps = 500 / dt
    neigh = sim._carry[1]
    phase("main", f"32k in.lj f32: set-up {setup_s:.3f} s (deck, grid, "
                  f"list K {sim._ctx.pairlist_k}, first forces; library "
                  f"already loaded), step 0 and step 100 gates pass (step "
                  f"100 temp {row100['temp']!r} epair {row100['epair']!r} "
                  f"etotal {row100['etotal']!r}); step 1200 etotal "
                  f"{sim.last_thermo['etotal']!r}")
    phase("main", f"timed 500 steps: {sps:.2f} timesteps/s, "
                  f"{sps * 32000 / 1e6:.3f} Matom-step/s on {smi}; kernel "
                  f"launches {launches} = force evaluations {force_evals}, "
                  f"plain calls {plain}; " + upkeep_phrase(sim, builds, gates)
                  + f"; longest row {int(neigh.max_pairs)}")
    phase("main", "in.lj " + profile_steps(script, 100, 1e3 / sps))
    # the counts are read: these launches are not the run's
    window_end_check("in.lj", script, 19)
    upkeep = time_upkeep("in.lj", sim)
    return {"launches": launches, "sps": sps, "build_launches": builds,
            "gates": gates, "refreshes": refreshes, "upkeep": upkeep}


def profiled_device_ms(fn) -> float:
    """Device milliseconds of one call of fn: the self time of its device
    events (kernels, copies, fills) under torch.profiler, after a warm
    call.  A call that waits on the card (these computes read counts from
    it) is timed by its device work, not by the host's waits."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA) / 1e3


def analysis_goldens_phase():
    """The six analysis goldens verbatim in f64 on the card, every file
    and thermo column against the reference binary's
    (tpumd_torch.analysis_goldens.failures, the CPU tests' comparison),
    with the force kernel of each launched and no plain call: P1 on the
    two-type computes deck (the matrix engine), B1 on the lj decks, B5 on
    the water decks."""
    from tpumd_torch import analysis_goldens as ag
    from tpumd_torch.ops import charmm_cellgrid, gather, lj_cellgrid
    gold = str(GOLDEN.parent)
    wrappers = {"B1": lj_cellgrid.counts, "B5": charmm_cellgrid.counts,
                "P1": gather.counts}
    notes = []
    for name in sorted(ag.DECKS):
        for c in wrappers.values():
            c.reset()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d, \
                contextlib.redirect_stdout(sys.stderr):
            script = ag.run(gold, name, d, "cuda", torch.float64)
            bad = ag.failures(gold, name, script)
        if bad:
            raise AssertionError(f"analysis golden {name}: {bad[:6]}")
        used = {k: c.kernel_launches for k, c in wrappers.items()
                if c.kernel_launches}
        plain = sum(c.plain_calls for c in wrappers.values())
        if not used or plain:
            raise AssertionError(f"analysis golden {name}: kernels {used}, "
                                 f"plain calls {plain}")
        notes.append(f"{name} ({time.perf_counter() - t0:.1f} s, "
                     + ", ".join(f"{k} x{n}" for k, n in used.items()) + ")")
    phase("analysis", "six goldens verbatim in f64 on the card agree with "
                      "the reference binary's logs, ave files and dumps: "
                      + "; ".join(notes))


ANALYSIS_COMPUTES = ("pea", "kea", "str", "pesum", "ssum", "msd", "vacf",
                     "rdf", "crd", "cna", "cen")


def analysis_identity_rows(script, rows, natoms, tol, what):
    from tpumd_torch.bench_targets import analysis_identities
    worst = {"pe": 0.0, "press": 0.0}
    for r in rows:
        gaps = analysis_identities(r, natoms)
        for k, g in gaps.items():
            if not g <= tol:
                raise AssertionError(f"{what} step {r['step']}: {k} "
                                     f"identity off by {g:.3g} (> {tol})")
            worst[k] = max(worst[k], g)
    return worst


def analysis_path(smi: str, lj_sps: float) -> dict:
    """IN_LJ_ANALYSIS32K on the card: the 6^3 deck in f64 behind the two
    identities at 1e-12; the 32k deck in f32 (1,000 steps: run 0, 100,
    400, then 500 timed, outputs included) behind in.lj's step-0 and
    step-100 gates and the identities at 1e-5 on every thermo row, its
    launch counts (B1 once per force evaluation, the per-atom variant once
    per output state that reads pe/atom or stress/atom, the list kernel
    once per grid set-up, rebuild and occasional list), then at step 1000
    rdf's counts, coord/atom and cna/atom exactly and centro/atom to
    1e-10 against their plain all-pairs versions in f64 on the card, the
    host ms of an output step by compute and of the dump write, and the
    device ms of each distance compute and of the list build."""
    from tpumd_torch.bench_targets import IN_LJ_ANALYSIS32K, SANITY, STEP0, \
        STEP0_RTOL, gate_failures
    from tpumd_torch.md import compute_list
    from tpumd_torch.ops import cellgrid_pairlist as bpl
    from tpumd_torch.ops import gather
    from tpumd_torch.ops.lj_cellgrid import counts
    from tpumd_torch.script.parser import LammpsScript

    def rows_of(sim):
        rows, orig = [], sim._thermo_line

        def line():
            orig()
            rows.append(dict(sim.last_thermo))
        sim._thermo_line = line
        return rows

    with tempfile.TemporaryDirectory() as d, \
            contextlib.redirect_stdout(sys.stderr):
        small = LammpsScript(device="cuda", dtype=torch.float64)
        small.data_dir = d
        deck6, run6 = IN_LJ_ANALYSIS32K.format(n=6, steps=300).rsplit(
            "run", 1)
        small.run_string(deck6)
        rows6 = rows_of(small.sim)
        small.run_string("run" + run6)
    worst6 = analysis_identity_rows(small, rows6, small.sim.natoms, 1e-12,
                                    "6^3 f64")
    tmp = tempfile.TemporaryDirectory()
    script = LammpsScript(device="cuda", dtype=torch.float32)
    script.data_dir = tmp.name
    # the deck without its run line: run in parts (0, 100, 400, 500)
    script.run_string(IN_LJ_ANALYSIS32K.format(n=20, steps=1000).rsplit(
        "run", 1)[0])
    sim = script.sim
    sim.verbose = False
    rows = rows_of(sim)
    counts.reset()
    reset_list_counts()
    gather.counts.reset()
    script.run_string("run 0")
    bad = gate_failures(rows[-1], {k: (v, STEP0_RTOL)
                                   for k, v in STEP0["lj"].items()})
    script.run_string("run 100")
    bad += gate_failures(rows[-1], SANITY["lj"])
    if bad:
        raise AssertionError(f"analysis deck gates: {bad}")
    script.run_string("run 400")
    lt0 = sim.loop_time
    script.run_string("run 500")
    sps = 500 / (sim.loop_time - lt0)
    worst = analysis_identity_rows(script, rows, sim.natoms, 1e-5,
                                   "32k f32")
    launches, peratom = counts.kernel_launches, counts.peratom_launches
    builds, gates, list_plain = list_counts()
    occasional, lists = sim.analysis_grid_lists, sim.analysis_lists
    plain = counts.plain_calls + list_plain + gather.counts.plain_calls
    thermo_steps = sorted({r["step"] for r in rows})
    out_states = len(set(thermo_steps) | set(range(0, 1001, 250)))
    force_evals = 1000 + 1 + (len(thermo_steps) - 1) + out_states
    grid_builds = sim.grid_setups + int(sim._carry[1].nbuilds) - 1
    if (launches != force_evals or peratom != out_states or plain
            or builds != grid_builds + occasional):
        raise AssertionError(
            f"analysis deck: B1 launches {launches} != force evaluations "
            f"{force_evals}, or per-atom launches {peratom} != output "
            f"states {out_states}, or plain calls {plain}, or list builds "
            f"{builds} != {grid_builds} + {occasional}")
    # step 1000: the list computes against their plain versions, in f64
    errs = []
    for cid in ("rdf", "crd", "cna", "cen"):
        c = sim.computes[cid]
        got = c.counts(sim) if cid == "rdf" else c(sim)
        c.plain = True
        try:
            plain_v = c.counts(sim) if cid == "rdf" else c.evaluate(sim)
        finally:
            c.plain = False
        if cid == "cen":
            err = float((got - plain_v).abs().max()
                        / plain_v.abs().max().clamp(min=1e-300))
            if not err <= 1e-10:
                raise AssertionError(f"centro/atom: {err:.3g} from plain")
            errs.append(f"centro/atom rel {err:.3g}")
        elif not torch.equal(got, plain_v):
            diff = torch.nonzero(got != plain_v).flatten()[:8].tolist()
            raise AssertionError(f"{cid}: differs from plain at {diff}")
        else:
            errs.append(f"{cid} equal")
    cna = sim.computes["cna"](sim)
    fcc = float((cna == 1).double().mean())
    cen = float(sim.computes["cen"](sim).mean())
    # host ms of one output step, by compute (each alone, its inputs
    # cached) and of the dump write (the computes cached)
    host = {}
    for cid in ANALYSIS_COMPUTES:
        c = sim.computes[cid]
        c(sim)
        sim._acache.pop(("compute", cid, id(c)), None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c(sim)
        torch.cuda.synchronize()
        host[cid] = 1e3 * (time.perf_counter() - t0)
    sim._acache = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for cid in ANALYSIS_COMPUTES:
        sim.computes[cid](sim)
    torch.cuda.synchronize()
    all_ms = 1e3 * (time.perf_counter() - t0)
    dump = sim.dumps[0]
    t0 = time.perf_counter()
    dump.write(sim)
    dump_ms = 1e3 * (time.perf_counter() - t0)
    rc = compute_list.list_cutoff(sim)
    dev = {"list build": profiled_device_ms(
        lambda: compute_list._build(sim, rc))}
    for cid in ("rdf", "crd", "cna", "cen"):
        c = sim.computes[cid]
        c(sim)
        dev[cid] = profiled_device_ms(lambda: c.evaluate(sim))
    s, neigh = sim._carry[0], sim._carry[1]
    lcfg = dataclasses.replace(sim._neigh_cfg,
                               cutneigh=rc * (1 + compute_list.MARGIN),
                               skin=0.0)
    from tpumd_torch.ops.cellgrid import pairlist_kmax
    k_build = time_build("analysis32k occasional", (
        s.x, neigh.valid, s.tag, None, None, s.box, lcfg,
        pairlist_kmax(s.box, rc, sim.natoms)))
    tmp.cleanup()
    phase("analysis", f"6^3 f64: identities hold at every row (worst pe "
                      f"{worst6['pe']:.3g}, press {worst6['press']:.3g}); "
                      f"32k f32: step-0 and step-100 gates pass, pe and "
                      f"press identities at every row (worst "
                      f"{worst['pe']:.3g}, {worst['press']:.3g}); step "
                      f"1000: {', '.join(errs)} against the plain versions "
                      f"in f64; fcc share of cna {fcc:.4f}, mean centro "
                      f"{cen:.4f}")
    phase("analysis", f"timed 500 steps with outputs: {sps:.2f} "
                      f"timesteps/s = {sps / lj_sps:.3f} x in.lj's "
                      f"{lj_sps:.2f} on {smi}; B1 launches {launches} = "
                      f"force evaluations {force_evals} (per-atom variant "
                      f"{peratom} = output states), list builds {builds} = "
                      f"{grid_builds} grid + {occasional} occasional (of "
                      f"{lists} occasional lists), plain calls {plain}")
    phase("analysis", "host ms of an output step: " + ", ".join(
        f"{k} {v:.3f}" for k, v in host.items())
        + f"; all computes from cold {all_ms:.3f}; dump write of "
          f"{sim.natoms} rows {dump_ms:.3f}")
    phase("analysis", "device ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in dev.items()))
    return {"launches": launches, "peratom": peratom, "sps": sps,
            "build_launches": builds, "k_build": k_build,
            "occasional": occasional}


def list_lj_pairs(x, box, pairs, npairs, cutsq) -> int:
    """Unordered in-cutoff pairs among a list's live code-0 entries,
    counted in f64 over blocks of rows (the 864k list's entries do not fit
    one gather)."""
    from tpumd_torch.ops.cellgrid_pairlist import unpack
    x, ell, n = x.double(), box.lengths.double(), 0
    kk = max(int(npairs.max()), 1)
    step = 1 << 17
    for r0 in range(0, x.shape[0], step):
        j, code = unpack(pairs[r0:r0 + step, :kk])
        live = ((torch.arange(kk, device=x.device)[None, :]
                 < npairs[r0:r0 + step, None].long()) & (code == 0))
        i, col = torch.nonzero(live, as_tuple=True)
        d = x[i + r0] - x[j[i, col].long()]
        d = d - ell * torch.round(d / ell)
        n += int(((d * d).sum(1) < cutsq).sum())
    return n // 2


def script_lj864_path(smi: str) -> dict:
    """LAMMPS's bench/in.lj through LammpsScript with x, y and z 3 (the
    path of python -m tpumd_torch -var x 3 -var y 3 -var z 3), 864,000
    atoms in f32: the deck's own lines and its run 100, after a run 0 that
    times the set-up; step-0 and step-100 gates; a timed 500-step window;
    the launch counts of that run (B1 once per force evaluation, the list
    build once per grid set-up and rebuild, the refresh once per step
    without a re-bin); a profile of 100 steps; then B1 against its plain
    list sweep and the list build against its plain build as arrays, at
    this shape, each timed beside its bound."""
    from tpumd_torch.bench_targets import IN_LJ_BENCH, SANITY, STEP0, \
        STEP0_RTOL, gate_failures
    from tpumd_torch.ops import lj_fene_cellgrid
    from tpumd_torch.ops.lj_cellgrid import counts, lj_cellgrid, \
        lj_pairlist_plain
    from tpumd_torch.script.parser import LammpsScript
    counts.reset()
    lj_fene_cellgrid.counts.reset()
    reset_list_counts()
    pre, run = IN_LJ_BENCH.rsplit("\nrun", 1)
    t0 = time.perf_counter()
    script = LammpsScript(device="cuda", dtype=torch.float32,
                          var_overrides={"x": 3, "y": 3, "z": 3})
    script.run_string(pre)
    sim = script.sim
    sim.verbose = False
    script.run_string("run 0")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    row0 = dict(sim.last_thermo)
    script.run_string("run" + run)     # the deck's own run 100
    row100 = dict(sim.last_thermo)
    bad = gate_failures(row0, {k: (v, STEP0_RTOL)
                               for k, v in STEP0["lj864"].items()}) \
        + gate_failures(row100, SANITY["lj864"])
    if sim.natoms != 864000 or row100["step"] != 100 or bad:
        raise AssertionError(f"lj864: {sim.natoms} atoms, step "
                             f"{row100['step']}, gates {bad}")
    lt0 = sim.loop_time
    script.run_string("run 500")
    dt = sim.loop_time - lt0
    launches, plain = counts.kernel_launches, counts.plain_calls
    builds, gates, list_plain = list_counts()
    plain += list_plain + lj_fene_cellgrid.counts.plain_calls
    nbuilds = int(sim._carry[1].nbuilds)
    force_evals = 1 + (100 + 1) + (500 + 1)
    list_builds = sim.grid_setups + nbuilds - 1
    unbinned = 600 - (nbuilds - 1)
    if (launches != force_evals or plain or builds != list_builds
            or gates != unbinned or lj_fene_cellgrid.counts.kernel_launches):
        raise AssertionError(f"lj864: kernel launches {launches} != force "
                             f"evaluations {force_evals}, or plain calls "
                             f"{plain}, or list builds {builds} != "
                             f"{list_builds}, or refresh launches {gates} != "
                             f"{unbinned}")
    s, neigh, _ = sim._carry
    if (not torch.isfinite(s.x).all()
            or int((s.tag > 0).sum()) != 864000
            or int(s.tag.max()) != 864000):
        raise AssertionError("lj864: final state malformed")
    sps = 500 / dt
    cfg = sim._neigh_cfg
    phase("main", f"script lj864 (bench/in.lj, -var x 3 -var y 3 -var z 3) "
                  f"f32: 864000 atoms, box {float(s.box.lengths[0]):.4f}, "
                  f"grid {cfg.nx}x{cfg.ny}x{cfg.nz} cap {cfg.cap} "
                  f"({cfg.capacity} slots), list K {sim._ctx.pairlist_k}; "
                  f"set-up {setup_s:.3f} s; step 0 {row0['temp']!r} "
                  f"{row0['epair']!r} {row0['etotal']!r} and step 100 "
                  f"{row100['temp']!r} {row100['epair']!r} "
                  f"{row100['etotal']!r} pass the lj864 gates")
    phase("main", f"script lj864 timed 500 steps: {sps:.2f} timesteps/s, "
                  f"{sps * 864000 / 1e6:.3f} Matom-step/s on {smi}; kernel "
                  f"launches {launches} = force evaluations {force_evals}, "
                  f"plain calls {plain}; " + upkeep_phrase(sim, builds, gates)
                  + f"; longest row {int(neigh.max_pairs)}")
    phase("main", "script lj864 " + profile_steps(script, 100, 1e3 / sps))
    # B1 and the build at this shape (after the counts are read)
    s, neigh, _ = sim._carry
    c = sim.pair.kernel_coeffs()
    plist = (neigh.pairs, neigh.npairs, neigh.row2slot)
    fk = lj_cellgrid(s.x, neigh.valid, s.box, cfg, c, 0, 0, plist)[0]
    fp = lj_pairlist_plain(s.x, s.box, c, 0, 0, neigh.pairs, neigh.npairs)[0]
    err = check_close("lj864 B1 vs its plain list sweep", fk, fp, (), (),
                      None, None, TOL_LIST[torch.float32], False, False)
    del fp
    plain_ms = cuda_ms(lambda: lj_pairlist_plain(
        s.x, s.box, c, 0, 0, neigh.pairs, neigh.npairs), 2, ahead=False)
    ms = min(cuda_ms(lambda: lj_cellgrid(s.x, neigh.valid, s.box, cfg, c, 0,
                                         0, plist), 100) for _ in range(2))
    nlj = list_lj_pairs(s.x, s.box, neigh.pairs, neigh.npairs, c.cutsq)
    np_ = cfg.capacity
    nbytes = np_ * (12 + 1 + 12) + 12
    b_ms, b_by = bound(nlj, 0, nbytes)
    floor_ms, _ = bound(nlj, 0, nbytes + list_floor_bytes(neigh, 864000))
    phase("kernel", f"lj_cellgrid at the 864k shape, f32 forces, over the "
                    f"run's list: = the plain list sweep to {err:.3g} max|f| "
                    f"(tol {TOL_LIST[torch.float32]:g}); kernel {ms:.4f} ms, "
                    f"plain list sweep {plain_ms:.4f} ms, "
                    f"bound {b_ms:.6f} ms ({b_by}: {nlj} unordered in-cutoff "
                    f"pairs, {nbytes} bytes), the list's floor "
                    f"{floor_ms:.6f} ms")
    h = neigh.list_hold
    bargs = (s.x, neigh.valid, h.tag, h.stags, h.scodes, s.box, cfg,
             sim._ctx.pairlist_k, h.gmask, h.exclude_bits)
    build = time_build("lj864", bargs, plain_reps=1)
    return {"sps": sps, "setup_s": setup_s, "b1_ms": ms, "b1_bound": b_ms,
            "build": build, "row0": row0}


def script_cli_phase(tmp: Path):
    """python -m tpumd_torch -in <bench/in.lj> -var x 1 -var y 1 -var z 1
    -log <file> in a process of its own on the default device: its logged
    step-0 and step-100 rows pass in.lj's gates (tools/bench_all.py:72,
    85-86)."""
    from tpumd_torch.bench_targets import IN_LJ_BENCH, SANITY, STEP0, \
        STEP0_RTOL, gate_failures
    deck, log = tmp / "in.lj", tmp / "log.cli"
    deck.write_text(IN_LJ_BENCH)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "tpumd_torch", "-in", str(deck),
                    "-var", "x", "1", "-var", "y", "1", "-var", "z", "1",
                    "-log", str(log)], check=True, capture_output=True,
                   timeout=300, cwd=Path(__file__).resolve().parent)
    wall = time.perf_counter() - t0
    lines = log.read_text().splitlines()
    head = next(i for i, ln in enumerate(lines) if ln.startswith("Step"))
    keys = {"Temp": "temp", "E_pair": "epair", "TotEng": "etotal"}
    cols = lines[head].split()
    rows = {}
    for ln in lines[head + 1:head + 3]:
        p = ln.split()
        rows[int(p[0])] = {keys[c]: float(v) for c, v in zip(cols, p)
                           if c in keys}
    if sorted(rows) != [0, 100]:
        raise AssertionError(f"script cli: logged rows {rows}")
    bad = gate_failures(rows[0], {k: (v, STEP0_RTOL)
                                  for k, v in STEP0["lj"].items()}) \
        + gate_failures(rows[100], SANITY["lj"])
    if bad:
        raise AssertionError(f"script cli: gates {bad}")
    perf = next(ln for ln in lines if ln.startswith("Performance"))
    phase("main", f"script cli: python -m tpumd_torch -in in.lj -var x 1 "
                  f"-var y 1 -var z 1 -log (CUDA by default) in {wall:.1f} s; "
                  f"logged step 0 {rows[0]} and step 100 {rows[100]} pass "
                  f"in.lj's gates; {perf}")


# the last thermo row of each water golden against its thermo.csv:
# {key: (column, rtol, atol)}; the dumped decks at
# tests/test_golden_water.py:85-92's tolerances, the rigid and RATTLE decks
# at tests/test_rigid.py's
_DUMPED = {"temp": (1, 2e-5, 1e-7), "epair": (2, 2e-5, 0.0),
           "emol": (3, 2e-5, 2e-5), "etotal": (4, 2e-5, 0.0),
           "press": (5, 2e-4, 0.5), "vol": (6, 1e-6, 0.0)}
_RIGID = {"temp": (1, 1e-5, 0.0), "epair": (2, 1e-5, 0.0),
          "etotal": (4, 1e-5, 0.0), "press": (5, 5e-4, 0.0)}
WATER_GOLDENS = {
    "water_nve": _DUMPED, "water_shake": _DUMPED, "water_npt": _DUMPED,
    "rattle_water": _RIGID, "rigid_water": {**_RIGID, "vol": (6, 1e-9, 0.0)},
    "rigid_nvt_water": _RIGID,
    "rigid_npt_water": {"temp": (1, 2e-5, 0.0), "epair": (2, 2e-5, 0.0),
                        "etotal": (4, 2e-5, 0.0), "press": (5, 5e-4, 0.0),
                        "vol": (6, 1e-7, 0.0)}}


def water_phase():
    """Every water golden verbatim (velocity, dump and dump_modify lines
    included) on the card in f64 in a temporary directory, on the grid:
    water_nve, water_shake and water_npt (fix npt iso) with their dumped
    per-atom forces held to the reference binary's dump.water at atol
    2e-4 max(1, |f|max), and rattle_water, rigid_water, rigid_nvt_water and
    rigid_npt_water; the last thermo row of each to its thermo.csv at
    WATER_GOLDENS' tolerances; B5 launched once per force evaluation and
    the list built at the set-up."""
    import shutil
    from tpumd_torch.ops import charmm_cellgrid
    from tpumd_torch.script.parser import LammpsScript
    golden = GOLDEN.parent
    for name, tols in WATER_GOLDENS.items():
        src = golden / name
        dumped = (src / "dump.water").exists()
        with tempfile.TemporaryDirectory() as tmpdir:
            shutil.copy(src / "data.water", tmpdir)
            script = LammpsScript(device="cuda", dtype=torch.float64)
            script.data_dir = tmpdir
            pre, run = (src / "in.test").read_text().rsplit("\nrun", 1)
            script.run_string(pre)
            sim = script.sim
            sim.verbose = False
            charmm_cellgrid.counts.reset()
            reset_list_counts()
            script.run_string("run" + run)
            launches = charmm_cellgrid.counts.kernel_launches
            plain = charmm_cellgrid.counts.plain_calls
            builds, _, list_plain = list_counts()
            ours = dump_rows(Path(tmpdir) / "dump.water") if dumped else {}
        theirs = dump_rows(src / "dump.water") if dumped else {}
        nsteps = int(run.split()[0])
        # set-up, each step, and the energies of each thermo row after it
        evals = 1 + nsteps + nsteps // sim.thermo_every
        if (not sim._ctx.is_cellgrid or launches != evals or plain
                or list_plain or builds < 1):
            raise AssertionError(f"{name}: grid {sim._ctx.is_cellgrid}, B5 "
                                 f"launches {launches} != {evals}, plain "
                                 f"calls {plain + list_plain}, list builds "
                                 f"{builds}")
        if sorted(ours) != sorted(theirs):
            raise AssertionError(f"{name}: dump steps {sorted(ours)} vs "
                                 f"{sorted(theirs)}")
        worst = 0.0
        for step, ref in theirs.items():
            scale = max(1.0, float(np.abs(ref[:, 1:]).max()))
            err = float(np.abs(ours[step][:, 1:] - ref[:, 1:]).max())
            if not (ours[step][:, 0] == ref[:, 0]).all() \
                    or err > 2e-4 * scale:
                raise AssertionError(f"{name} step {step}: forces {err} > "
                                     f"2e-4 * {scale}")
            worst = max(worst, err / scale)
        v = sim.last_thermo
        last = np.loadtxt(src / "thermo.csv")[-1]
        if v["step"] != last[0]:
            raise AssertionError(f"{name}: step {v['step']} vs {last[0]}")
        for k, (col, rtol, atol) in tols.items():
            if not abs(v[k] - last[col]) <= max(rtol * abs(last[col]), atol):
                raise AssertionError(f"{name} step {v['step']} {k}: {v[k]} "
                                     f"vs {last[col]}")
        forces = (f"dumped forces at steps {sorted(ours)} = dump.water to "
                  f"{worst:.3g} of max(1, |f|max) (tol 2e-4), "
                  if dumped else "")
        phase("main", f"{name} verbatim on the card, f64: {forces}step "
                      f"{v['step']} thermo = thermo.csv (temp {v['temp']!r}, "
                      f"epair {v['epair']!r}, etotal {v['etotal']!r}, vol "
                      f"{v['vol']!r}); fixes "
                      f"{[fx.name for fx in sim.fixes]}; B5 launches "
                      f"{launches} = force evaluations, list builds "
                      f"{builds}, on the grid")


# tests/test_triclinic.py:66 and :90: the reference binary's step-20 rows
# of tests/golden/tri_npt's decks, {key: (value, rtol)}
TRI_NPT = {
    "in.test": {"temp": (1.2507388, 1e-6), "epair": (-0.66905984, 1e-6),
                "etotal": (1.1920395, 1e-6), "press": (0.0073729042, 1e-4),
                "vol": (613.39659, 1e-7), "xy": (2.5488944, 1e-7),
                "xz": (1.2743966, 1e-7), "yz": (1.6993669, 1e-7),
                "lx": (8.496483, 1e-7)},
    "in.aniso": {"temp": (1.2507388, 1e-6), "etotal": (1.1920409, 1e-6),
                 "vol": (613.39674, 1e-7), "xy": (2.5490005, 1e-7)}}


def tri_npt_phase():
    """tests/golden/tri_npt's decks (fix npt tri: the six-component
    barostat; fix npt aniso on a tilted box: the tilts scaled with the
    cell) on the card in f64 on the matrix engine, against the reference
    binary's numbers, with P1 launched at every force evaluation."""
    from tpumd_torch.ops.gather import counts
    from tpumd_torch.script.parser import LammpsScript
    golden = GOLDEN.parent
    for deck, want in TRI_NPT.items():
        script = LammpsScript(device="cuda", dtype=torch.float64)
        script.data_dir = str(golden / "tri_lj")
        pre, run = (golden / "tri_npt" / deck).read_text().rsplit("\nrun",
                                                                   1)
        script.run_string(pre)
        sim = script.sim
        sim.verbose = False
        counts.reset()
        script.run_string("run" + run)
        if sim._ctx.is_cellgrid or not sim.state.box.istriclinic:
            raise AssertionError(f"tri_npt {deck}: not a triclinic box on "
                                 "the matrix engine")
        launched = check_p1(f"tri_npt {deck}", int(run.split()[0]))
        v = sim.last_thermo
        bad = [k for k, (ref, rel) in want.items()
               if not abs(v[k] - ref) <= rel * abs(ref)]
        if v["step"] != 20 or bad:
            raise AssertionError(f"tri_npt {deck} step {v['step']}: "
                                 + ", ".join(f"{k} {v[k]!r} vs {want[k]}"
                                             for k in bad))
        phase("main", f"tri_npt {deck} on the card (matrix engine, f64) = "
                      f"the reference binary's step 20: "
                      + ", ".join(f"{k} {v[k]!r}" for k in want)
                      + f"; {launched}")


def dump_rows(path: Path) -> dict:
    """{step: rows sorted by ID} of a text dump."""
    out, lines, i = {}, path.read_text().splitlines(), 0
    while i < len(lines):
        step, n = int(lines[i + 1]), int(lines[i + 3])
        rows = np.array([ln.split() for ln in lines[i + 9:i + 9 + n]],
                        np.float64)
        out[step] = rows[np.argsort(rows[:, 0])]
        i += 9 + n
    return out


def drift_phase():
    """The drift protocol (bench_targets.measure_drift: 500 warm-up steps,
    then max|E(t) - E0|/|E0| over 1,000 steps sampled every 100) on the
    32k drift deck (in.lj with shift yes, dt 0.001) in f64, gated at
    BASELINE.md's 1e-6, and in f32, gated at tools/bench_all.py:200's
    2e-4; then in.lj's own drift in f32 and f64, printed, not gated."""
    from tpumd_torch.bench_targets import DRIFT_TOL, IN_LJ, IN_LJ_DRIFT, \
        measure_drift
    from tpumd_torch.script.parser import LammpsScript
    out = {}
    for deck, name in ((IN_LJ_DRIFT, "drift"), (IN_LJ, "in.lj")):
        for dtype, prec in ((torch.float64, "f64"), (torch.float32, "f32")):
            script = LammpsScript(device="cuda", dtype=dtype)
            script.run_string(deck.format(n=20))
            script.sim.verbose = False
            out[name, prec] = measure_drift(script)
    bad = {p: out["drift", p] for p in ("f64", "f32")
           if not out["drift", p] <= DRIFT_TOL[p]}
    phase("main", f"drift, 32,000 atoms, 1,000 steps after 500: the drift "
                  f"deck f64 {out['drift', 'f64']:.4e} (gate "
                  f"{DRIFT_TOL['f64']:g}), f32 {out['drift', 'f32']:.4e} "
                  f"(gate {DRIFT_TOL['f32']:g}); in.lj as published, not "
                  f"gated: f64 {out['in.lj', 'f64']:.4e}, f32 "
                  f"{out['in.lj', 'f32']:.4e}")
    if bad:
        raise AssertionError(f"drift over its gate: {bad}")


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
    operations per step and the largest kernels, over a short window.  The
    profiler's host cost grows with the events it records (~1 ms each), so
    the decks of hundreds of operations a step take a 20-step window."""
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
    for c in (lj_cellgrid.counts, lj_fene_cellgrid.counts):
        c.reset()
    reset_list_counts()
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
    builds, gates, list_plain = list_counts()
    plain = (lj_fene_cellgrid.counts.plain_calls
             + lj_cellgrid.counts.plain_calls + list_plain)
    lj_launches = lj_cellgrid.counts.kernel_launches
    # setup evaluates once; a run of n steps at thermo 100 is n in-step
    # evaluations plus one energy evaluation per 100 steps
    force_evals = 1 + (100 + 1) + 2 * (500 + 5)
    # a list for each fresh grid (set-up, re-bins) and each rebuild; no
    # refresh: the schedule checks every step
    list_builds = sim.grid_setups + int(sim._carry[1].nbuilds) - 1
    if (launches != force_evals or plain != 0 or lj_launches != 0
            or builds != list_builds or gates):
        raise AssertionError(f"lj_fene launches {launches} != force "
                             f"evaluations {force_evals}, or plain calls "
                             f"{plain} != 0, or lj launches {lj_launches}, "
                             f"or list builds {builds} != set-ups and "
                             f"rebuilds {list_builds}, or refresh launches "
                             f"{gates}")
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
                  f"{rebuilds} rebuilds; lj_fene launches {launches} = "
                  f"force evaluations {force_evals}, cellgrid_pairlist "
                  f"launches {builds} = {sim.grid_setups} grid set-ups + "
                  f"{list_builds - sim.grid_setups} rebuilds, refresh "
                  f"launches {gates} (the schedule checks every step), "
                  f"plain calls {plain}; list K {sim._ctx.pairlist_k}, "
                  f"longest row {int(sim._carry[1].max_pairs)}")
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
    return {"launches": launches, "build_launches": builds}


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


def check_rho(what, out, plain, tol) -> float:
    """Raise unless B3's rho, F' and (with eflag) F(rho) agree with a
    plain version's to tol of their largest; the largest of those
    relative differences."""
    torch.cuda.synchronize()
    worst = 0.0
    for name, a, b in zip(("rho", "F'", "F(rho)"), out, plain):
        if b is None:
            continue
        if not torch.isfinite(a).all():
            raise AssertionError(f"{what} {name}: not finite")
        err = float((a - b).abs().max()) / float(b.abs().max())
        if not err <= tol:
            raise AssertionError(f"{what} {name}: {err} of max > {tol}")
        worst = max(worst, err)
    return worst


def eam_kernels_vs_plain(tmp: Path) -> tuple[dict, dict]:
    """B3 and B4 over the list against their plain list sweeps and their
    stencil oracles on perturbed in.eam lattices (rho, F' and F(rho) to
    TOL_LIST of their largest); both force passes take the plain density
    pass's F'."""
    from tpumd_torch.models.pair_eam import PairEAM
    from tpumd_torch.ops.eam_cellgrid import eam_force_cellgrid, \
        eam_force_cellgrid_plain, eam_force_pairlist_plain, \
        eam_rho_cellgrid, eam_rho_cellgrid_plain, eam_rho_pairlist_plain
    pair = PairEAM(1)
    pair.coeff(1, 1, 1, 1, str(eam_potential(tmp)))
    pair.init()
    k_rho, k_force = {}, {}
    for nlat in (20, 4):
        for dtype in (torch.float32, torch.float64):
            x, valid, box, cfg, plist = perturbed_grid(nlat, 17 + nlat,
                                                       "cuda", dtype,
                                                       eam=True)
            tab = pair.kernel_tables(x)
            tol = TOL[dtype]
            worst = (0.0, 0.0)
            worst_rho = {"list": 0.0, "stencil": 0.0}
            for eflag, vflag in ((0, 0), (1, 1), (1, 0), (0, 1)):
                what = f"eam {nlat}^3 {dtype} e{eflag}v{vflag}"
                rho = eam_rho_cellgrid(x, valid, box, cfg, tab, eflag, plist)
                fpp = None
                for ref, plain in (
                        ("list", eam_rho_pairlist_plain(
                            x, valid, box, tab, eflag, *plist[:2])),
                        ("stencil", eam_rho_cellgrid_plain(
                            x, valid, box, cfg, tab, eflag))):
                    worst_rho[ref] = max(worst_rho[ref], check_rho(
                        f"{what} B3 vs {ref}", rho, plain, TOL_LIST[dtype]))
                    fpp = plain[1]
                errs = check_list_sweep(
                    what, eam_force_cellgrid(x, valid, fpp, box, cfg, tab,
                                             eflag, vflag, plist),
                    eam_force_pairlist_plain(x, fpp, box, tab, eflag, vflag,
                                             *plist[:2]),
                    eam_force_cellgrid_plain(x, valid, fpp, box, cfg, tab,
                                             eflag, vflag),
                    dtype, eflag, vflag)
                worst = tuple(map(max, worst, errs))
            phase("kernel", f"eam_rho_cellgrid + eam_force_cellgrid grid "
                            f"{cfg.nx}x{cfg.ny}x{cfg.nz} cap {cfg.cap} K "
                            f"{plist[0].shape[1]} {str(dtype)[6:]}: rho, F', "
                            f"F(rho) of B3 within {worst_rho['list']:.3g} of "
                            f"their largest of the plain list sweep and "
                            f"{worst_rho['stencil']:.3g} of the stencil "
                            f"oracle (tol {TOL_LIST[dtype]:g}); "
                            f"max|f_kernel - f_plain| = "
                            f"{worst[0]:.3g} max|f| against the plain list "
                            f"sweep (tol {TOL_LIST[dtype]:g}), {worst[1]:.3g}"
                            f" against the stencil oracle (tol "
                            f"{TOL_ORACLE[dtype]:g}), pair energy and "
                            f"virial within {tol:g}")
            if nlat != 20 or dtype != torch.float32:
                continue
            _, fpp, _ = eam_rho_cellgrid_plain(x, valid, box, cfg, tab, 0)
            rk, _, _ = eam_rho_cellgrid(x, valid, box, cfg, tab, 0, plist)
            rp, _, _ = eam_rho_pairlist_plain(x, valid, box, tab, 0,
                                              *plist[:2])
            k_rho["max_abs_err"] = float((rk - rp).abs().max())
            fk, _, _ = eam_force_cellgrid(x, valid, fpp, box, cfg, tab, 0, 0,
                                          plist)
            fp, _, _ = eam_force_pairlist_plain(x, fpp, box, tab, 0, 0,
                                                *plist[:2])
            k_force["max_abs_err"] = float((fk - fp).abs().max())
            k_rho.update(time_kernel(
                "eam_rho_cellgrid",
                lambda: eam_rho_cellgrid(x, valid, box, cfg, tab, 0, plist),
                lambda: eam_rho_pairlist_plain(x, valid, box, tab, 0,
                                               *plist[:2]),
                lambda: eam_rho_cellgrid(x, valid, box, cfg, tab, 1, plist)))
            k_force.update(time_kernel(
                "eam_force_cellgrid",
                lambda: eam_force_cellgrid(x, valid, fpp, box, cfg, tab, 0,
                                           0, plist),
                lambda: eam_force_pairlist_plain(x, fpp, box, tab, 0, 0,
                                                 *plist[:2]),
                lambda: eam_force_cellgrid(x, valid, fpp, box, cfg, tab, 1,
                                           1, plist)))
            stencil_ms = cuda_ms(lambda: eam_force_cellgrid_plain(
                x, valid, fpp, box, cfg, tab, 0, 0), 10, ahead=False)
            rho_stencil_ms = cuda_ms(lambda: eam_rho_cellgrid_plain(
                x, valid, box, cfg, tab, 0), 10, ahead=False)
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
            floor = (4 * int(plist[1].sum()) + 4 * np_ + 8 * natoms)
            floor_ms, floor_by = roof(npair * OPS_EAM_FORCE_PAIR,
                                      nbytes_f + floor)
            rho_floor_ms, rho_floor_by = roof(
                npair * OPS_EAM_RHO_PAIR + natoms * OPS_EAM_EMBED,
                nbytes + floor)
            cand = np_ * 27 * cfg.cap
            entries = int(plist[1].sum())
            phase("kernel", f"eam bounds: {npair} unordered in-cutoff pairs "
                            f"({2 * npair / cand:.4%} of {cand} stencil "
                            f"candidates (i, j), {2 * npair / entries:.2%} "
                            f"of {entries} list entries, "
                            f"{entries / natoms:.2f} a row); {natoms} atoms; "
                            f"density pass {nbytes} bytes -> "
                            f"{k_rho['bound_ms']:.6f} ms "
                            f"({k_rho['bound_by']}), the list's floor "
                            f"{floor} bytes more -> {rho_floor_ms:.6f} ms "
                            f"({rho_floor_by}), its stencil oracle "
                            f"{rho_stencil_ms:.4f} ms; force pass "
                            f"{nbytes_f} bytes -> {k_force['bound_ms']:.6f} "
                            f"ms ({k_force['bound_by']}), the list's floor "
                            f"{floor} bytes more -> {floor_ms:.6f} ms "
                            f"({floor_by}); the force pass's stencil oracle "
                            f"{stencil_ms:.4f} ms")
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


def eam_main_path(tmp: Path, smi: str) -> tuple[dict, dict, dict]:
    from tpumd_torch.bench_targets import EAM_SANITY, EAM_STEP0, \
        STEP0_RTOL, gate_failures
    from tpumd_torch.ops import eam_cellgrid, lj_cellgrid, lj_fene_cellgrid

    others = (lj_cellgrid.counts, lj_fene_cellgrid.counts)
    rho_c, force_c = eam_cellgrid.rho_counts, eam_cellgrid.force_counts
    for c in (rho_c, force_c) + others:
        c.reset()
    reset_list_counts()
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
    builds, gates, list_plain = list_counts()
    plain = list_plain + sum(c.plain_calls for c in (rho_c, force_c)
                             + others)
    other = sum(c.kernel_launches for c in others)
    refreshes = sim.list_refreshes
    # setup evaluates once; a run of n steps at thermo 50 is n in-step
    # evaluations plus one energy evaluation per 50 steps
    force_evals = 1 + (100 + 2) + 2 * (500 + 10)
    list_builds = sim.grid_setups + int(sim._carry[1].nbuilds) - 1
    # the steps before the delay gate a refresh, and after it every step
    # that does not re-bin once a gate ran since the re-bin: at most
    # every step without a re-bin
    unbinned = 1100 - (int(sim._carry[1].nbuilds) - 1)
    if (launches != (force_evals, force_evals) or plain or other
            or builds != list_builds or not 0 < gates <= unbinned):
        raise AssertionError(f"eam launches {launches} != force evaluations "
                             f"{force_evals}, or plain calls {plain}, or "
                             f"other kernels' launches {other}, or list "
                             f"builds {builds} != {list_builds}, or refresh "
                             f"launches {gates} not in 1..{unbinned}")
    s = sim.state
    if (tuple(s.x.shape) != (sim._neigh_cfg.capacity, 3)
            or not torch.isfinite(s.x).all()
            or sorted(s.tag[s.tag > 0].tolist()) != list(range(1, 32001))):
        raise AssertionError("eam final state malformed")
    sps = 500 / dt
    cfg = sim._neigh_cfg
    phase("main", f"32k in.eam f32: set-up {setup_s:.3f} s (potential file, "
                  f"deck, grid {cfg.nx}x{cfg.ny}x{cfg.nz} cap {cfg.cap}, list "
                  f"K {sim._ctx.pairlist_k}, first forces), step 0 and step "
                  f"100 gates pass (step 100 temp {row100['temp']!r} epair "
                  f"{row100['epair']!r} etotal {row100['etotal']!r}); step "
                  f"1100 etotal {sim.last_thermo['etotal']!r}")
    phase("main", f"eam timed 500 steps: {sps:.2f} timesteps/s, "
                  f"{sps * 32000 / 1e6:.3f} Matom-step/s on {smi}; "
                  f"{rebuilds} rebuilds; eam_rho / eam_force launches "
                  f"{launches[0]} / {launches[1]} = force evaluations "
                  f"{force_evals}, plain calls {plain}; "
                  + upkeep_phrase(sim, builds, gates) + f"; longest row "
                  f"{int(sim._carry[1].max_pairs)}")
    phase("main", "eam " + profile_steps(script, 100, 1e3 / sps))
    # the counts are read: these launches are not the run's
    window_end_check("eam", script, 4)
    upkeep = time_upkeep("eam", sim, refresh=True)
    return ({"launches": launches[0]}, {"launches": launches[1]},
            {"build_launches": builds, "gates": gates,
             "refreshes": refreshes, "upkeep": upkeep})


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


def charmm_counts(oracle):
    """(pairs within the Coulomb cutoff, within the LJ cutoff, in the
    LJ switching shell, within either) of the stencil oracle's inputs,
    unordered, counted with the plain sweep in f64."""
    from tpumd_torch.ops.cellgrid import cellgrid_pair_sums
    from tpumd_torch.ops.charmm_cellgrid import special_weights
    x, q, type_, valid, tag, stags, scodes, box, cfg, c = oracle
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
    """(the inputs of cellgrid_pairlist, those of the stencil oracle
    charmm_cellgrid_plain) for a set-up script's state in dtype."""
    from tpumd_torch.core.state import Box
    sim = script.sim
    s, neigh, _ = sim._carry
    x = s.x.to(dtype)
    box = Box(lo=s.box.lo.to(dtype), hi=s.box.hi.to(dtype))
    cfg = sim._neigh_cfg
    c = sim.pair.kernel_coeffs(x, *sim._special_weights())
    return ((x, neigh.valid, s.tag, s.special_tags, s.special_codes, box,
             cfg, sim._ctx.pairlist_k),
            (x, s.q.to(dtype), s.type, neigh.valid, s.tag, s.special_tags,
             s.special_codes, box, cfg, c))


def live_entries(pairs, npairs):
    """The rows' live entries, each row's tail past npairs (unspecified
    in a kernel's list) zeroed."""
    k = torch.arange(pairs.shape[1], device=pairs.device)
    return torch.where(k < npairs[:, None].long(), pairs, 0)


def live_err(out, plain) -> float:
    """The largest difference of two lists' live entries and counts (0
    where they are equal)."""
    return float(max((live_entries(*out[:2]).long()
                      - live_entries(*plain[:2]).long()).abs().max(),
                     (out[1].long() - plain[1].long()).abs().max()))


def check_lanes(what, bargs) -> tuple:
    """The build on bargs with each G forced and by the launch rule
    against the plain build (check_pairlist); (the rule's list, the plain
    build's)."""
    from tpumd_torch.ops.cellgrid_pairlist import LANES, cellgrid_pairlist, \
        cellgrid_pairlist_plain
    plain = cellgrid_pairlist_plain(*bargs)
    for lanes in LANES + (None,):
        built = cellgrid_pairlist(*bargs, lanes=lanes)
        check_pairlist(f"{what}, lanes {lanes}", built, plain)
    return built, plain


def check_pairlist(what, out, plain):
    """Raise unless the build kernel's list equals the plain build's: the
    live entries as arrays (in order), counts, longest row and overflow
    flag."""
    torch.cuda.synchronize()
    if not (torch.equal(out[1], plain[1])
            and torch.equal(live_entries(*out[:2]), live_entries(*plain[:2]))
            and int(out[2]) == int(plain[2])
            and bool(out[3]) == bool(plain[3])):
        raise AssertionError(f"{what}: the build kernel's list differs from "
                             f"the plain build's")


def charmm_kernel_vs_plain(ptxas_log: str) -> tuple[dict, dict]:
    """The pair list build and B5 against their plain versions on the 32k
    rhodo_class grid and the 2^3 peptide grid after set-up, f32 and f64:
    the lists' live entries as arrays, with each G of the build forced
    (check_lanes); B5 over the kernel's list against the plain list sweep
    and the stencil oracle in every flag combination; both timed and
    bounded at the 32k shape.  Returns (B5's figures, the build's)."""
    from tpumd_torch.ops.charmm_cellgrid import charmm_cellgrid, \
        charmm_cellgrid_plain, charmm_pairlist_plain
    for name, pat in (
            ("charmm_cellgrid (type, eflag, vflag", r"charmm_pairlist_kernel"
             r"I([fd])Lb(\d)ELb(\d)E"),
            ("cellgrid_pairlist (type, G, periodic, exclude",
             r"cellgrid_pairlist_kernelI([fd])Li(\d+)ELb(\d)ELb(\d)E")):
        regs = re.findall(pat + r".*?\n.*?(\d+) bytes spill stores.*?\n.*?"
                          r"Used (\d+) registers", ptxas_log)
        phase("kernel", f"{name}: registers, spill store bytes): "
                        + "; ".join(f"{' '.join(m[:-2])}: {m[-1]}, {m[-2]}"
                                    for m in regs))
    out, lst = {}, {}
    for replicate in ("2 2 4", "1 1 1"):
        script = rhodo_setup(replicate, "cuda", torch.float64)
        script.run_string("run 0")
        for dtype in (torch.float32, torch.float64):
            bargs, oracle = charmm_args(script, dtype)
            cfg, kmax = bargs[-2:]
            what = f"pair list {replicate} {dtype}"
            built, plain = check_lanes(what, bargs)
            if bool(built[3]):
                raise AssertionError(f"{what}: overflow at the set-up's K")
            args = oracle[:3] + built[:2] + oracle[7:]
            tol = TOL[dtype]
            worst = 0.0
            for eflag, vflag in ((0, 0), (1, 1), (1, 0), (0, 1)):
                what = f"charmm {replicate} {dtype} e{eflag}v{vflag}"
                fk, evk, eck, wk = charmm_cellgrid(*args, eflag, vflag)
                for ref, fn in (("list", charmm_pairlist_plain),
                                ("stencil", charmm_cellgrid_plain)):
                    fp, evp, ecp, wp = (
                        fn(*args[:6], args[7], eflag, vflag)
                        if ref == "list" else fn(*oracle, eflag, vflag))
                    worst = max(worst, check_close(
                        f"{what} vs {ref}", fk, fp, (evk, eck), (evp, ecp),
                        wk, wp, tol, eflag, vflag))
                if eflag and vflag:
                    eerr = max(abs(float(evk - evp)) / abs(float(evp)),
                               abs(float(eck - ecp)) / abs(float(ecp)))
                    verr = float((wk - wp).abs().max()
                                 / wp.abs().max())
            phase("kernel", f"pair list grid {cfg.nx}x{cfg.ny}x{cfg.nz} cap "
                            f"{cfg.cap} K {kmax} {str(dtype)[6:]}: the "
                            f"kernel's live entries = the plain build's "
                            f"as arrays, longest {int(built[2])}, "
                            f"{int(built[1].sum())} entries; "
                            f"charmm_cellgrid S {oracle[5].shape[1]}: "
                            f"max|f_kernel - f_plain| = {worst:.3g} max|f| "
                            f"against the plain list sweep and the stencil "
                            f"oracle, evdwl/ecoul {eerr:.3g}, virial "
                            f"{verr:.3g} of max (oracle; tol {tol:g})")
            if replicate != "2 2 4" or dtype != torch.float32:
                continue
            fk, _, _, _ = charmm_cellgrid(*args, 0, 0)
            fp, _, _, _ = charmm_pairlist_plain(*args[:6], args[7], 0, 0)
            out["max_abs_err"] = float((fk - fp).abs().max())
            out.update(time_kernel(
                "charmm_cellgrid",
                lambda: charmm_cellgrid(*args, 0, 0),
                lambda: charmm_pairlist_plain(*args[:6], args[7], 0, 0),
                lambda: charmm_cellgrid(*args, 1, 1), reps=50))
            out["v_ms"] = cuda_ms(lambda: charmm_cellgrid(*args, 0, 1), 50)
            ncoul, nlj, nsw, nall = charmm_counts(oracle)
            np_ = cfg.capacity
            entries = int(built[1].sum())
            # x, q, type, f per slot, the lj tables and the box: the work's
            # bytes; the list (each row's entries and its count) is a floor
            # of this design, not of the work, and stays out of the bound
            nbytes = np_ * (12 + 4 + 4 + 12) + args[7].lj.numel() * 4 + 12
            list_bytes = 4 * entries + 4 * np_
            ops = (nall * OPS_CHARMM_PAIR + ncoul * OPS_CHARMM_COUL
                   + nlj * OPS_CHARMM_LJ + nsw * OPS_CHARMM_SWITCH)
            out["bound_ms"], out["bound_by"] = roof(ops, nbytes)
            floor_ms, floor_by = roof(ops, nbytes + list_bytes)
            phase("kernel", f"charmm_cellgrid at the 32k shape: kernel "
                            f"with the virial only (the per-step launch "
                            f"under NPT) {out['v_ms']:.4f} ms; bound: "
                            f"{nall} unordered pairs in range "
                            f"({2 * nall / entries:.2%} of {entries} list "
                            f"entries), {ncoul} in Coulomb range, {nlj} in "
                            f"LJ range, {nsw} in the switching shell; "
                            f"{nbytes} bytes -> {out['bound_ms']:.6f} ms "
                            f"({out['bound_by']}); the list's floor: "
                            f"{list_bytes} bytes more -> {floor_ms:.6f} ms "
                            f"({floor_by})")
            lst = time_build("rhodo_class", bargs)
    return out, lst


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
    from tpumd_torch.core.state import Box
    from tpumd_torch.ops import charmm_cellgrid, eam_cellgrid, lj_cellgrid, \
        lj_fene_cellgrid

    others = (lj_cellgrid.counts, lj_fene_cellgrid.counts,
              eam_cellgrid.rho_counts, eam_cellgrid.force_counts)
    b5 = charmm_cellgrid.counts
    for c in (b5,) + others:
        c.reset()
    reset_list_counts()
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
    builds, gates, list_plain = list_counts()
    refreshes = sim.list_refreshes
    other = sum(c.kernel_launches for c in others)
    plain += list_plain + sum(c.plain_calls for c in others)
    # setup evaluates once; a run of n > 0 steps without thermo output is
    # one segment: n in-step evaluations plus one energy evaluation
    force_evals = 1 + (100 + 1) + 2 * (500 + 1)
    # a list for each fresh grid (set-up, re-bins) and each rebuild
    list_builds = sim.grid_setups + int(sim._carry[1].nbuilds) - 1
    if (launches != force_evals or builds != list_builds or plain
            or other):
        raise AssertionError(f"charmm launches {launches} != force "
                             f"evaluations {force_evals}, or list builds "
                             f"{builds} != set-ups and rebuilds "
                             f"{list_builds}, or plain calls {plain}, or "
                             f"other kernels' launches {other}")
    s = sim.state
    n = sim.natoms
    if (n != 32064 or tuple(s.x.shape) != (sim._neigh_cfg.capacity, 3)
            or not torch.isfinite(s.x).all()
            or sorted(s.tag[s.tag > 0].tolist()) != list(range(1, n + 1))):
        raise AssertionError("rhodo_class final state malformed")
    sps = 500 / dt
    cfg, ks = sim._neigh_cfg, sim.kspace
    # no pair within range is missing from the list at the end of the run:
    # the kernel over it equals the stencil oracle on the final state, both
    # in f64, where they differ by summation order only (in f32 the two
    # sums of ~400 Coulomb terms differ by up to ~8e-5 of max|f|)
    s, neigh, _ = sim._carry
    x, q = s.x.double(), s.q.double()
    box = Box(lo=s.box.lo.double(), hi=s.box.hi.double())
    c = sim.pair.kernel_coeffs(x, *sim._special_weights())
    fk = charmm_cellgrid.charmm_cellgrid(x, q, s.type, neigh.pairs,
                                         neigh.npairs, box, cfg, c, 0, 0)[0]
    fo = charmm_cellgrid.charmm_cellgrid_plain(
        x, q, s.type, neigh.valid, s.tag, s.special_tags, s.special_codes,
        box, cfg, c, 0, 0)[0]
    end_err = check_close("rhodo_class step 1200, list against stencil",
                          fk, fo, (), (), None, None,
                          TOL_ORACLE[torch.float64], False, False)
    phase("main", f"32k rhodo_class f32: set-up {setup_s:.3f} s (data file, "
                  f"replicate, SHAKE clusters, PPPM mesh {ks.nx}x{ks.ny}x"
                  f"{ks.nz} g_ewald {float(ks.g_ewald)!r}, grid {cfg.nx}x{cfg.ny}x"
                  f"{cfg.nz} cap {cfg.cap}, K {sim._ctx.pairlist_k}, first "
                  f"forces); "
                  f"step 0 "
                  f"{ {k: row0[k] for k in RHODO_STEP0} } and step 100 "
                  f"{ {k: row100[k] for k in RHODO_STEP100} } pass the "
                  f"reference binary's gates; step 1200 etotal "
                  f"{sim.last_thermo['etotal']!r}, lz "
                  f"{sim.last_thermo['lz']!r}; there B5 over the list = "
                  f"the stencil oracle in f64 to {end_err:.3g} max|f| (tol "
                  f"{TOL_ORACLE[torch.float64]:g}), longest row "
                  f"{int(neigh.max_pairs)} of K {sim._ctx.pairlist_k}")
    phase("main", f"rhodo_class timed 500 steps: {sps:.2f} timesteps/s, "
                  f"{sps * n / 1e6:.3f} Matom-step/s on {smi}; {rebuilds} "
                  f"rebuilds; charmm_cellgrid launches {launches} = force "
                  f"evaluations {force_evals}, " + upkeep_phrase(
                      sim, builds, gates) + f" (delay 5), plain calls "
                  f"{plain}, other kernels' launches {other}")
    phase("main", "rhodo_class " + profile_steps(script, 20, 1e3 / sps))
    phase("main", "rhodo_class step parts, host clock to a synchronize, "
                  "ms per call on the final state: " + rhodo_breakdown(sim))
    upkeep = time_upkeep("rhodo_class", sim, build=False,
                         refresh=refreshes > 0)
    return {"launches": launches, "build_launches": builds, "gates": gates,
            "refreshes": refreshes, "upkeep": upkeep}


def rhodo_breakdown(sim, reps: int = 20) -> str:
    """Host-clock time of each part of a rhodo_class step, each run alone
    on the final state and followed by a synchronize: the pair kernel with
    the virial, a rebuild (re-bin and pair list), the bonded styles, PPPM,
    SHAKE's solve, fix npt's two halves and the rebuild check."""
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
        "rebuild (re-bin and pair list)": lambda: verlet._rebuild(
            s, neigh, ctx),
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


WATER30K_GOLDEN = {"water_npt30k": "water_npt",
                   "rigid_npt30k": "rigid_npt_water"}


def water30k_setup(name: str, dtype):
    """LammpsScript of a 4x4x5 water deck on the card, verbose off,
    before its first run."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.script.parser import LammpsScript
    deck = {"water_npt30k": bt.IN_WATER_NPT30K,
            "rigid_npt30k": bt.IN_RIGID_NPT30K}[name]
    script = LammpsScript(device="cuda", dtype=dtype)
    script.run_string(deck.format(golden=GOLDEN.parent
                                  / WATER30K_GOLDEN[name]))
    script.sim.verbose = False
    return script


def force_evals(nsteps: int, every: int) -> int:
    """Force evaluations of a run of nsteps from a step that is a multiple
    of every: each step's, and the energies of each thermo row after it."""
    if every <= 0:
        return nsteps + 1
    return nsteps + nsteps // every + (1 if nsteps % every else 0)


def step_parts(sim, reps: int = 10) -> str:
    """Host-clock time of each part of a water deck's step, each run alone
    on the final state and followed by a synchronize: the pair kernel with
    the virial, a rebuild (re-bin and pair list), PPPM, the constraint or
    rigid-body fix's hooks, fix npt's two halves and the rebuild check."""
    from tpumd_torch.md import verlet
    s, neigh, fstates = sim._carry
    ctx = sim._ctx
    only_pair = dataclasses.replace(ctx, bonded=(), kspace=None)
    parts = {
        "pair (B5, virial)": lambda: verlet.compute_forces(
            s, neigh, only_pair, False, True),
        "rebuild (re-bin and pair list)": lambda: verlet._rebuild(
            s, neigh, ctx),
        "pppm": lambda: ctx.kspace.compute(s.x, s.q, s.box, False, True),
        "rebuild check": lambda: verlet.decide_rebuild(
            s, neigh.replace(ago=ctx.neigh_cfg.delay), ctx)}
    for fx, fs in zip(ctx.fixes, fstates):
        label = "npt" if fx.name == "nh" else fx.name
        if fx.name in ("shake", "rattle"):
            parts[fx.name] = (lambda fx=fx, fs=fs: fx.post_force(s, fs, ctx))
            continue
        parts[f"{label} initial"] = (
            lambda fx=fx, fs=fs: fx.initial_integrate(s, fs, ctx))
        parts[f"{label} final"] = (
            lambda fx=fx, fs=fs: fx.final_integrate(s, fs, ctx))
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


def list_charmm_counts(x, box, pairs, npairs, c) -> tuple:
    """(pairs within the Coulomb cutoff, within the LJ cutoff, in the LJ
    switching shell, within either) among a list's live entries, every
    special code included, unordered, counted in f64 (as charmm_counts
    counts the stencil's; the list holds every pair within cutneigh)."""
    from tpumd_torch.ops.cellgrid_pairlist import unpack
    x, ell = x.double(), box.lengths.double()
    kk = max(int(npairs.max()), 1)
    j, _ = unpack(pairs[:, :kk])
    live = (torch.arange(kk, device=x.device)[None, :]
            < npairs[:, None].long())
    i, col = torch.nonzero(live, as_tuple=True)
    d = x[i] - x[j[i, col].long()]
    r2 = ((d - ell * torch.round(d / ell)) ** 2).sum(1)
    ncoul, nlj, ninner, nall = (int((r2 < cut).sum()) // 2 for cut in (
        c.cut_coulsq, c.cut_ljsq, c.cut_lj_innersq,
        max(c.cut_coulsq, c.cut_ljsq)))
    return ncoul, nlj, nlj - ninner, nall


def b5_at_shape(script, name: str) -> dict:
    """B5 over a run's carried list, f32, against its plain list sweep at
    that state; timed (plain, kernel, kernel, plain) beside its bound from
    this state's pairs in range (list_charmm_counts), as at rhodo_class's
    shape."""
    from tpumd_torch.ops.charmm_cellgrid import charmm_cellgrid, \
        charmm_pairlist_plain
    neigh = script.sim._carry[1]
    bargs, oracle = charmm_args(script, torch.float32)
    args = oracle[:3] + (neigh.pairs, neigh.npairs) + oracle[7:]
    fk = charmm_cellgrid(*args, 0, 0)[0]
    fp = charmm_pairlist_plain(*args[:6], args[7], 0, 0)[0]
    err = check_close(f"{name} charmm_cellgrid vs list", fk, fp, (), (),
                      None, None, TOL[torch.float32], False, False)
    out = {"max_abs_err": float((fk - fp).abs().max())}
    out.update(time_kernel(
        f"charmm_cellgrid {name}", lambda: charmm_cellgrid(*args, 0, 0),
        lambda: charmm_pairlist_plain(*args[:6], args[7], 0, 0),
        lambda: charmm_cellgrid(*args, 1, 1), reps=50, shape="30k"))
    out["v_ms"] = cuda_ms(lambda: charmm_cellgrid(*args, 0, 1), 50)
    ncoul, nlj, nsw, nall = list_charmm_counts(args[0], args[5], *args[3:5],
                                               args[7])
    cfg = args[6]
    np_ = cfg.capacity
    entries = int(neigh.npairs.sum())
    nbytes = np_ * (12 + 4 + 4 + 12) + args[7].lj.numel() * 4 + 12
    ops = (nall * OPS_CHARMM_PAIR + ncoul * OPS_CHARMM_COUL
           + nlj * OPS_CHARMM_LJ + nsw * OPS_CHARMM_SWITCH)
    out["bound_ms"], out["bound_by"] = roof(ops, nbytes)
    phase("kernel", f"charmm_cellgrid {name}, grid {cfg.nx}x{cfg.ny}x"
                    f"{cfg.nz} cap {cfg.cap} K {bargs[-1]}: = the plain list "
                    f"sweep to {err:.3g} max|f|; with the virial only (the "
                    f"per-step launch under NPT) {out['v_ms']:.4f} ms; "
                    f"{entries / int(neigh.valid.sum()):.1f} entries a row, "
                    f"{nall} unordered pairs in range, {ncoul} in Coulomb "
                    f"range, {nlj} in LJ range, {nsw} in the switching "
                    f"shell; bound {nbytes} bytes -> {out['bound_ms']:.6f} "
                    f"ms ({out['bound_by']})")
    return out


def water30k_phase(smi: str) -> dict:
    """The 4x4x5 water decks (bench_targets.IN_WATER_NPT30K and
    IN_RIGID_NPT30K, 30,000 atoms) on the card: an f64 run to step 100;
    then in f32, from the f64 deck's velocities, the step-0 gates (80x the golden's volume, the
    temperature, epair within WATER30K_EPAIR_RTOL of 80x the golden's and
    at STEP0_RTOL of the port's f64 CPU row), the step-100 row against the
    f64 run's, 500 timed steps, the launch counts of that run (B5 once per
    force evaluation, the list built at each grid set-up and rebuild, no
    plain call, the grid's cells wider than cutneigh at the end), the
    SHAKE geometry (within 10 x the fix's tolerance) or the bodies'
    (within 1e-4 of the set-up's distances), a profile of 20 steps, the
    step's parts, and B5 and the list build at this shape beside their
    bounds."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.ops import charmm_cellgrid, eam_cellgrid, lj_cellgrid, \
        lj_fene_cellgrid
    b5 = charmm_cellgrid.counts
    others = (lj_cellgrid.counts, lj_fene_cellgrid.counts,
              eam_cellgrid.rho_counts, eam_cellgrid.force_counts)
    out = {}
    for name in WATER30K_GOLDEN:
        # velocity ... loop geom hashes the positions as stored, in the
        # run's dtype (as tpumd does; LAMMPS hashes its doubles): the f32
        # run takes the f64 deck's velocities, so that both start from the
        # microstate of the f64 hash and differ by their precision only
        wall = [time.perf_counter()]
        ref = water30k_setup(name, torch.float64)
        v64 = ref.sim.state.v
        ref.run_string("run 0")
        ref.run_string("run 100")
        row_f64 = dict(ref.sim.last_thermo)
        del ref
        torch.cuda.empty_cache()
        wall.append(time.perf_counter())
        for c in (b5,) + others:
            c.reset()
        reset_list_counts()
        t0 = time.perf_counter()
        script = water30k_setup(name, torch.float32)
        sim = script.sim
        sim.state = sim.state.replace(v=v64.to(torch.float32))
        script.run_string("run 0")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        row0 = dict(sim.last_thermo)
        bad = bt.gate_failures(row0, bt.WATER30K_STEP0[name]) \
            + bt.gate_failures(row0, {k: (v, bt.STEP0_RTOL) for k, v in
                                      bt.WATER30K_STEP0_F64[name].items()})
        if bad:
            raise AssertionError(f"{name} step-0 gates: {bad}")
        script.run_string("run 100")
        row100 = dict(sim.last_thermo)
        bad = bt.gate_failures(row100, {k: (row_f64[k], tol) for k, tol in
                                        bt.WATER30K_F32_F64.items()})
        if bad:
            raise AssertionError(f"{name} step 100, f32 against f64: {bad}")
        lt0, nb0 = sim.loop_time, int(sim._carry[1].nbuilds)
        script.run_string("run 500")
        dt = sim.loop_time - lt0
        sps = 500 / dt
        rebuilds = int(sim._carry[1].nbuilds) - nb0
        launches, plain = b5.kernel_launches, b5.plain_calls
        builds, _, list_plain = list_counts()
        other = sum(c.kernel_launches for c in others)
        plain += list_plain + sum(c.plain_calls for c in others)
        every = sim.thermo_every
        evals = 1 + force_evals(100, every) + force_evals(500, every)
        list_builds = sim.grid_setups + int(sim._carry[1].nbuilds) - 1
        cfg = sim._neigh_cfg
        cutneigh = sim.max_cutoff() + sim.skin
        edge = sim.state.box.lengths_np() / np.array([cfg.nx, cfg.ny,
                                                      cfg.nz])
        if (launches != evals or builds != list_builds or plain or other
                or not sim._ctx.is_cellgrid or (edge < cutneigh).any()):
            raise AssertionError(
                f"{name}: B5 launches {launches} != force evaluations "
                f"{evals}, or list builds {builds} != set-ups and rebuilds "
                f"{list_builds}, or plain calls {plain}, other kernels' "
                f"launches {other}, grid {sim._ctx.is_cellgrid}, cell edges "
                f"{edge} < cutneigh {cutneigh}")
        s = sim.state
        n = sim.natoms
        if (n != 30000 or not torch.isfinite(s.x).all()
                or sorted(s.tag[s.tag > 0].tolist())
                != list(range(1, n + 1))):
            raise AssertionError(f"{name}: final state malformed")
        if name == "water_npt30k":
            tol = 10 * sim.shake_fixes()[0].tol
            bond, angle = bt.shake_geometry(sim)
            if not (bond <= tol and angle <= tol):
                raise AssertionError(f"{name}: SHAKE bonds {bond}, angles "
                                     f"{angle} > {tol} (relative)")
            geom = (f"every SHAKE bond within {bond:.3g} of 0.9572 A and "
                    f"angle within {angle:.3g} of 104.52 deg (relative; "
                    f"gate {tol:g})")
        else:
            dev = bt.rigid_geometry(sim)
            if not dev <= 1e-4:
                raise AssertionError(f"{name}: intra-body distances {dev} "
                                     "> 1e-4 of the set-up's")
            geom = (f"every body's intra-body distances within {dev:.3g} "
                    f"of the set-up's (gate 1e-4)")
        ks = sim.kspace
        keys0 = ("temp", "epair", "vol", "etotal", "press")
        miss = abs(row0["epair"] / bt.WATER30K_STEP0[name]["epair"][0] - 1)
        phase("main", f"{name} f32: set-up {setup_s:.3f} s (data file, "
                      f"replicate 4 4 5, PPPM mesh {ks.nx}x{ks.ny}x{ks.nz} "
                      f"g_ewald {float(ks.g_ewald)!r}, grid {cfg.nx}x{cfg.ny}"
                      f"x{cfg.nz} cap {cfg.cap}, K {sim._ctx.pairlist_k}); "
                      f"step 0 { {k: row0[k] for k in keys0} } passes 80x "
                      f"the golden's (epair within {miss:.4g}, gate "
                      f"{bt.WATER30K_EPAIR_RTOL:g}) and the f64 CPU "
                      f"row's gates; step 100 "
                      f"{ {k: row100[k] for k in bt.WATER30K_F32_F64} } = the"
                      f" card's f64 run "
                      f"{ {k: row_f64[k] for k in bt.WATER30K_F32_F64} } "
                      f"within {bt.WATER30K_F32_F64}; step 600 {geom}")
        phase("main", f"{name} timed 500 steps: {sps:.2f} timesteps/s, "
                      f"{sps * n / 1e6:.3f} Matom-step/s on {smi}; "
                      f"{rebuilds} rebuilds; charmm_cellgrid launches "
                      f"{launches} = force evaluations {evals}, "
                      + upkeep_phrase(sim, builds, 0) + f", plain calls "
                      f"{plain}, other kernels' launches {other}; final cell "
                      f"edges {edge.round(4).tolist()} >= cutneigh "
                      f"{cutneigh}")
        wall.append(time.perf_counter())
        phase("main", f"{name} " + profile_steps(script, 20, 1e3 / sps))
        wall.append(time.perf_counter())
        phase("main", f"{name} step parts, host clock to a synchronize, ms "
                      f"per call on the final state: " + step_parts(sim))
        k = b5_at_shape(script, name)
        lst = time_build(name, charmm_args(script, torch.float32)[0])
        wall.append(time.perf_counter())
        phase("main", f"{name} wall clock: the f64 run "
                      f"{wall[1] - wall[0]:.1f} s, the f32 run and its gates "
                      f"{wall[2] - wall[1]:.1f} s, the profile "
                      f"{wall[3] - wall[2]:.1f} s, the parts and the kernel "
                      f"timing {wall[4] - wall[3]:.1f} s")
        out[name] = {"launches": launches, "build_launches": builds,
                     "b5": k, "build": lst, "sps": sps}
        del script, sim
        torch.cuda.empty_cache()
    return out


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
    """(arguments before the coefficients, planes, coefficients, the pair
    list) of gran_cellgrid for a set-up script's state, the history
    scaled."""
    from tpumd_torch.core.state import Box
    sim = script.sim
    s, neigh, _ = sim._carry
    f = (lambda a: a.to(dtype))
    box = Box(lo=f(s.box.lo), hi=f(s.box.hi), periodic=s.box.periodic)
    planes = (f(s.v), f(s.omega), f(s.radius),
              f(torch.where(s.rmass > 0, s.rmass, 1.0)), s.gmask)
    return ((f(s.x), s.tag, neigh.valid, neigh.shear_tags,
             f(neigh.shear * scale), box, sim._neigh_cfg), planes,
            sim.pair.kernel_coeffs(), (neigh.pairs, neigh.npairs,
                                       neigh.row2slot))


def check_gran(what, out, plain, tol, tol_ft=None) -> float:
    """Raise unless the kernel's forces, torques and history agree with
    the plain version's (tags equal; forces and torques within tol_ft of
    their largest where given, else tol); returns the largest error of
    forces and torques relative to their largest value."""
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
        lim = tol if name == "shear" or tol_ft is None else tol_ft
        if err > lim * top:
            raise AssertionError(f"{what} {name}: {err} > {lim} * {top}")
        if name != "shear":
            worst = max(worst, err / top)
    return worst


def gran_kernel_vs_plain(tmp: Path, ptxas_log: str) -> dict:
    """B6 over the grid's pair list against the plain list sweep (forces
    and torques to TOL_LIST) and the stencil oracle (to TOL) on the 32k
    chute grid after set-up and 10 steps, on a 5x2x3 grid (y periodic with
    2 cells) and on a 5x5x2 grid (z non-periodic with 2 cells, the aliased
    offsets dropped) after 30 steps, f32 and f64, both shearupdate values,
    the history as it is and scaled by 40, history tags equal; the list
    build on each p p fs grid against its plain build as arrays; B6 and
    the build timed and bounded at the 32k shape."""
    from tpumd_torch.bench_targets import chute_data
    from tpumd_torch.core.state import Box
    from tpumd_torch.ops.gran_cellgrid import gran_cellgrid, \
        gran_compact_sums, gran_pairlist_plain
    regs = re.findall(r"gran_pairlist_kernelI([fd])Lb(\d)ELb(\d)ELb(\d)E"
                      r"Lb0E.*?\n.*?(\d+) bytes spill stores.*?\n.*?"
                      r"Used (\d+) registers", ptxas_log)
    phase("kernel", "gran_cellgrid ptxas (type, shearupdate, freeze, "
                    "limit_damping: registers, spill store bytes): "
                    + "; ".join(f"{t}{a}{b}{c}: {r}, {sp}"
                                for t, a, b, c, sp, r in regs))
    out = {}
    for dims, nsteps, grid in (((40, 20, 40), 10, None),
                               ((6, 3, 6), 30, (5, 2, 3)),
                               ((6, 6, 4), 30, (5, 5, 2))):
        data = tmp / f"data.chute.{'x'.join(map(str, dims))}"
        chute_data(data, *dims)
        script = chute_setup(data, "cuda", torch.float64)
        script.run_string(f"run {nsteps}")
        sim = script.sim
        cfg = sim._neigh_cfg
        if grid is not None and (cfg.nx, cfg.ny, cfg.nz) != grid:
            raise AssertionError(f"chute {dims}: grid {cfg} is not {grid}")
        for dtype in (torch.float32, torch.float64):
            s = sim._carry[0]
            bargs = (s.x.to(dtype), sim._carry[1].valid, s.tag, None, None,
                     Box(lo=s.box.lo.to(dtype), hi=s.box.hi.to(dtype),
                         periodic=s.box.periodic), cfg, sim._ctx.pairlist_k,
                     s.gmask, sim._ctx.pairlist_exclude)
            if dims[0] == 40 and dtype == torch.float32:
                out["list"] = time_build("chute", bargs)
            else:
                check_lanes(f"chute {dims} {dtype} pair list", bargs)
            worst = {"list": 0.0, "stencil": 0.0}
            for scale in (1.0, 40.0):
                args, planes, c, plist = gran_args(script, dtype, scale)
                x, tag, valid, stags, shear, box, _ = args
                for coeffs in (c, c._replace(gammat=0.5 * c.gamman,
                                             limit_damping=True)):
                    for su in (True, False):
                        what = (f"gran {dims} {dtype} scale {scale} "
                                f"gammat {coeffs.gammat} shearupdate {su}")
                        k = gran_cellgrid(*args, coeffs, planes, 1e-4, su,
                                          plist)
                        worst["list"] = max(worst["list"], check_gran(
                            what + " vs list", k, gran_pairlist_plain(
                                x, tag, stags, shear, box, coeffs, planes,
                                1e-4, su, *plist[:2]), TOL[dtype],
                            TOL_LIST[dtype]))
                        worst["stencil"] = max(worst["stencil"], check_gran(
                            what + " vs stencil", k, gran_compact_sums(
                                *args, coeffs, planes, 1e-4, su),
                            TOL[dtype]))
            phase("kernel", f"gran_cellgrid grid {cfg.nx}x{cfg.ny}x{cfg.nz} "
                            f"cap {cfg.cap} K {plist[0].shape[1]} "
                            f"{str(dtype)[6:]}: max|kernel - plain| = "
                            f"{worst['list']:.3g} of max|f| and max|torque| "
                            f"against the plain list sweep (tol "
                            f"{TOL_LIST[dtype]:g}), {worst['stencil']:.3g} "
                            f"against the stencil oracle (tol "
                            f"{TOL[dtype]:g}), history tags equal")
            if dims[0] != 40 or dtype != torch.float32:
                continue
            args, planes, c, plist = gran_args(script, dtype)
            x, tag, valid, stags, shear, box, _ = args
            kern = (lambda: gran_cellgrid(*args, c, planes, 1e-4, True,
                                          plist))
            plain = (lambda: gran_pairlist_plain(
                x, tag, stags, shear, box, c, planes, 1e-4, True,
                *plist[:2]))
            fk, fp = kern()[0], plain()[0]
            out["max_abs_err"] = float((fk - fp).abs().max())
            p1 = cuda_ms(plain, 10, ahead=False)
            k1 = cuda_ms(kern, 200)
            k2 = cuda_ms(kern, 200)
            p2 = cuda_ms(plain, 10, ahead=False)
            k_ro = cuda_ms(lambda: gran_cellgrid(*args, c, planes, 1e-4,
                                                 False, plist), 200)
            out.update(ms=min(k1, k2), plain_ms=min(p1, p2))
            # contacts: each appears in both of its atoms' new tables (none
            # is dropped below KH = 12 contacts per sphere)
            stags_new = plain()[2]
            ncontact = int((stags_new != 0).sum()) // 2
            neigh = sim._carry[1]
            nbytes = gran_bytes(sim.natoms, neigh.npairs)
            out["bound_ms"], out["bound_by"] = roof(
                ncontact * OPS_GRAN_PAIR, nbytes)
            entries = int(neigh.npairs.sum())
            phase("kernel", f"gran_cellgrid at the 32k shape, f32, "
                            f"shearupdate: kernel {k1:.4f} / {k2:.4f} ms, "
                            f"plain list sweep {p1:.4f} / {p2:.4f} ms; read-only "
                            f"(thermo) kernel {k_ro:.4f} ms; "
                            f"bound: {ncontact} contacts "
                            f"({2 * ncontact / entries:.2%} of {entries} "
                            f"list entries); {sim.natoms} spheres in "
                            f"{cfg.capacity} slots, {nbytes} bytes -> "
                            f"{out['bound_ms']:.6f} ms ({out['bound_by']})")
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
    reset_list_counts()
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
    builds, gates, list_plain = list_counts()
    plain += list_plain + sum(c.plain_calls for c in others)
    # setup evaluates once; a run of n steps at thermo 100 is n in-step
    # evaluations plus one read-only evaluation per 100 steps
    force_evals = 1 + (100 + 1) + 2 * (500 + 5)
    # a list for each fresh grid (set-up, re-bins) and each rebuild; no
    # refresh: the schedule checks every step
    list_builds = sim.grid_setups + int(sim._carry[1].nbuilds) - 1
    if (launches != force_evals or plain or other
            or builds != list_builds or gates):
        raise AssertionError(f"gran launches {launches} != force "
                             f"evaluations {force_evals}, or plain calls "
                             f"{plain}, or other kernels' launches {other},"
                             f" or list builds {builds} != set-ups and "
                             f"rebuilds {list_builds}")
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
                  f"= force evaluations {force_evals}, cellgrid_pairlist "
                  f"launches {builds} = {sim.grid_setups} grid set-ups + "
                  f"{list_builds - sim.grid_setups} rebuilds, refresh "
                  f"launches {gates} (the schedule checks every step), "
                  f"plain calls {plain}, other kernels' launches {other}; "
                  f"list K {sim._ctx.pairlist_k}, longest row "
                  f"{int(neigh.max_pairs)}")
    phase("main", "chute " + profile_steps(script, 100, 1e3 / sps))
    return {"launches": launches, "sps": sps, "build_launches": builds}


# the probe's shapes (tools/probes/gather_probe.py:8-10): a 32,768-row
# table, 32,768 atoms x K = 16 gathered rows
P1_ROWS, P1_GATHERED = 32768, 32768 * 16
# IN_HYB32K's opls dihedrals (the first dihedral sub-style of its hybrid)
P1_HYB_DIHEDRALS = 4125
# the tables and indices that the 32k matrix decks hand to P1: (dtype,
# table rows, width, index shape), from their configs on the card (in.lj:
# 11^3 cells of cap 44, K 88, blocks of 4096; chute: 37 x 18 x 24 cells of
# cap 8, K 16, blocks of 16384; IN_HYB32K K 136 at its set-up, IN_SALT32K
# K 32).  in.lj: the cell table at a block's stencil, the candidates'
# coordinates (27 x 44 a row; the table has a far-away row past the
# atoms), the packed j rows and the lj/cut coefficient rows; chute: the
# cell table, the candidates' coordinates with the group bits, and the
# packed (N, 12) j rows; the packed j rows (x, type, q) of IN_HYB32K and
# IN_SALT32K, and IN_HYB32K's tag-order positions at the members of its
# opls dihedrals (one gather a style).  matrix_main_path, salt_path and
# hyb32k_path also compare the inputs those runs really gave it.
P1_MAIN_SHAPES = (
    (torch.int32, 1331, 44, (4096, 27)),
    (torch.float32, 32001, 3, (4096, 1188)),
    (torch.float32, 32000, 4, (32000, 88)),
    (torch.float32, 4, 6, (32000, 88)),
    (torch.int32, 15984, 8, (16384, 27)),
    (torch.float32, 32001, 4, (16384, 216)),
    (torch.float32, 32000, 12, (32000, 16)),
    (torch.float32, 32000, 5, (32000, 136)),
    (torch.float32, 32768, 5, (32768, 32)),
    (torch.float32, 32000, 3, (P1_HYB_DIHEDRALS, 4)))
# the modules that call gather_rows by name (matrix_main_path records
# their inputs)
P1_CALLERS = ("tpumd_torch.ops.neighbor", "tpumd_torch.ops.pairwise",
              "tpumd_torch.models.pair_gran", "tpumd_torch.models.pair_lj_cut",
              "tpumd_torch.models.base", "tpumd_torch.models.pair_table",
              "tpumd_torch.models.bonded", "tpumd_torch.models.pair_manybody",
              "tpumd_torch.models.pair_hybrid", "tpumd_torch.models.pair_eam",
              "tpumd_torch.models.pair_adp", "tpumd_torch.models.pair_eim",
              "tpumd_torch.models.pair_meam", "tpumd_torch.models.pair_dpd",
              "tpumd_torch.models.pair_tip4p")


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


def p1_misaligned(gen, dtype, width: int) -> int:
    """P1 bit for bit against its plain version where the table, the
    indices and the output each start one element past a 16-byte aligned
    address (the output through the kernel's entry point called directly:
    the wrapper allocates its own); returns the number of cases."""
    from tpumd_torch.ops import _build, gather
    table, idx = p1_case(gen, dtype, 5001, width, (40003,))
    shifted = table.view(-1)[1:1 + 5000 * width].view(5000, width)
    ibuf = torch.empty(idx.numel() + 1, dtype=torch.int32, device="cuda")
    ibuf[1:] = idx.clamp(max=4999)
    ix = ibuf[1:]
    cases = ((shifted, ix), (shifted, idx.clamp(max=4999)), (table, ix))
    for t, i in cases:
        if not torch.equal(gather.gather_rows(t, i),
                           gather.gather_rows_plain(t, i)):
            raise AssertionError(f"row_gather {dtype} width {width}: a "
                                 "shifted table or index array differs")
    fn = _build.kernel_function("tpumd_row_gather", gather._ARGTYPES)
    obuf = torch.empty(ix.numel() * width + 1, dtype=dtype, device="cuda")
    out = obuf[1:].view(ix.numel(), width)
    for t in (table, shifted):
        rc = fn(t.data_ptr(), ix.data_ptr(), out.data_ptr(), ix.numel(),
                width * t.element_size(),
                torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if rc or not torch.equal(out, gather.gather_rows_plain(t, ix)):
            raise AssertionError(f"row_gather {dtype} width {width}: an "
                                 f"output one element past alignment "
                                 f"differs (rc {rc})")
    return len(cases) + 2


def p1_timed(what: str, table, idx) -> dict:
    """P1 at one shape timed in the order plain, kernel, kernel, plain
    beside torch.index_select, its bound (the table, the indices and the
    rows written, once each) and the wrapper's host microseconds a call;
    bit-equal to plain first."""
    from tpumd_torch.ops.gather import gather_rows, gather_rows_plain
    kern = (lambda: gather_rows(table, idx))
    plain_fn = (lambda: gather_rows_plain(table, idx))
    lib = (lambda: torch.index_select(table, 0, idx.view(-1)))
    ref = plain_fn()
    if not torch.equal(kern(), ref) or not torch.equal(
            lib().view(ref.shape), ref):
        raise AssertionError(f"row_gather at {what}: differs from plain")
    err = float((kern() - ref).abs().max())
    del ref
    p1 = cuda_ms(plain_fn, 50, ahead=False)
    k1 = cuda_ms(kern, 200)
    k2 = cuda_ms(kern, 200)
    p2 = cuda_ms(plain_fn, 50, ahead=False)
    lib_ms = cuda_ms(lib, 200)
    host = host_us(kern)
    n, width = table.shape
    esize = table.element_size()
    nbytes = esize * table.numel() + 4 * idx.numel() \
        + esize * idx.numel() * width
    bound_ms, bound_by = roof(0, nbytes)
    phase("kernel", f"row_gather at {what} ({n} x {width} "
                    f"{str(table.dtype)[6:]} table, idx {tuple(idx.shape)}"
                    f"): kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / "
                    f"{p2:.4f} ms, torch.index_select {lib_ms:.4f} ms; bound "
                    f"{nbytes} B -> {bound_ms:.6f} ms ({bound_by}); host "
                    f"{host:.1f} us a call; max|kernel - plain| = {err}")
    return {"ms": min(k1, k2), "plain_ms": min(p1, p2), "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
            "host_us": host}


def gather_kernel_vs_plain() -> dict:
    """P1 against its plain version on the card, bit for bit: f32, f64 and
    int32 tables of widths 1-16, 24, 32 and 128 elements with one index,
    40,003, (5000, 17) and (5000, 29) indices up to the last row (the
    narrow copy at one, two and four rows a thread, each with a last tile
    cut short); a table, an index array and an output one element past
    alignment; the 32k matrix decks' widths and
    index shapes (P1_MAIN_SHAPES), each then timed in the order plain,
    kernel, kernel, plain beside torch.index_select, its bound and the
    wrapper's host us; and the probe's shapes, f32, L = 128 and 16, timed
    alike (L = 128's numbers are the kernels line's)."""
    gen = torch.Generator(device="cuda").manual_seed(2026)
    widths = tuple(range(1, 17)) + (24, 32, 128)
    dtypes = (torch.float32, torch.float64, torch.int32)
    checked = p1_equal_plain(
        (p1_case(gen, dtype, 5000, width, shape)
         for dtype in dtypes for width in widths
         for shape in ((1,), (5000 * 8 + 3,), (5000, 17), (5000, 29))),
        "small")
    checked += sum(p1_misaligned(gen, dtype, width)
                   for dtype in dtypes for width in widths)
    phase("kernel", f"row_gather = plain bit for bit in {checked} cases "
                    "(f32, f64, int32; widths 1-16, 24, 32, 128; 1, 40,003, "
                    "(5000, 17) and (5000, 29) indices up to the last row; "
                    "a table, indices and an output one element past "
                    "alignment)")
    checked = p1_equal_plain(
        (p1_case(gen, *c) for c in P1_MAIN_SHAPES), "main-path shape")
    phase("kernel", f"row_gather = plain bit for bit in {checked} cases at "
                    "the 32k matrix decks' shapes")
    for d, r, w, sh in P1_MAIN_SHAPES:
        table, idx = p1_case(gen, d, r, w, sh)
        p1_timed(f"the main-path shape {r} x {w} at {sh}", table, idx)
    out = {}
    for width in (128, 16):
        table = torch.randn((P1_ROWS, width), generator=gen, device="cuda")
        idx = torch.randint(0, P1_ROWS, (P1_GATHERED,), generator=gen,
                            device="cuda", dtype=torch.int32)
        k = p1_timed(f"the probe's shape L={width}", table, idx)
        if width == 128:
            out = k
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
    0; no cell-grid kernel) and a profile of 20 steps."""
    from tpumd_torch.bench_targets import CHUTE_STEP0, CHUTE_STEP100, \
        IN_LJ, SANITY, STEP0, STEP0_RTOL, chute_data, gate_failures
    from tpumd_torch.ops import cellgrid_pairlist, charmm_cellgrid, \
        eam_cellgrid, gather, gran_cellgrid, lj_cellgrid, lj_fene_cellgrid
    from tpumd_torch.script.parser import LammpsScript
    grid = (lj_cellgrid.counts, lj_fene_cellgrid.counts,
            eam_cellgrid.rho_counts, eam_cellgrid.force_counts,
            charmm_cellgrid.counts, gran_cellgrid.counts,
            cellgrid_pairlist.counts, cellgrid_pairlist.refresh_counts)
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
        phase("main", f"matrix {name} " + profile_steps(script, 20,
                                                        1e3 / sps))
    return {"launches": total}


GRAN_GOLDEN = GOLDEN.parent / "gran"


@contextlib.contextmanager
def counted_setups(sim, out: list):
    """Record the host seconds of each Simulation.setup of sim."""
    orig = sim.setup

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    sim.setup = timed
    try:
        yield out
    finally:
        del sim.setup


def gran_counts_reset():
    from tpumd_torch.ops import gather, gran_cellgrid
    for c in (gran_cellgrid.counts, gather.counts):
        c.reset()
    reset_list_counts()


def check_b6(what: str, evals: int, hertz: bool) -> str:
    """Raise unless B6 (its HERTZ variant where hertz) launched once per
    force evaluation on the grid and no plain call ran; returns the
    counts."""
    from tpumd_torch.ops import gran_cellgrid
    b6 = gran_cellgrid.counts
    want_h = evals if hertz else 0
    if (b6.kernel_launches != evals or b6.hertz_launches != want_h
            or b6.plain_calls or list_counts()[2]):
        raise AssertionError(
            f"{what}: gran_cellgrid launches {b6.kernel_launches} (HERTZ "
            f"{b6.hertz_launches}) != force evaluations {evals}, or plain "
            f"calls {b6.plain_calls + list_counts()[2]}")
    return (f"gran_cellgrid launches {b6.kernel_launches} (HERTZ "
            f"{b6.hertz_launches}) = force evaluations, list builds "
            f"{list_counts()[0]}, plain calls 0")


def force_evals_of(sim, setups: int, nsteps: int, nruns: int = 1) -> int:
    """Force evaluations of nruns run commands: one a set-up, one a step
    (a step of a segment redone after an overflow twice), and one a thermo
    row, but for the row each run prints at its start (the last
    evaluation's)."""
    rows = sum(1 for ln in sim.log_lines
               if ln.split() and ln.split()[0].isdigit())
    return setups + nsteps + sim.steps_redone + rows - nruns


def granular_goldens():
    """tests/golden/gran's four decks verbatim in f64 on the card, each
    last row against its reference log at rel 2e-6 (ke and c_rot; pour:
    atoms and ke): granwall, granhertz and pour on the grid with B6 once
    per force evaluation (HERTZ on granhertz), granhooke on the matrix
    engine with P1 launched; and tests/golden/wall_lj93 (the matrix
    engine) against its thermo.csv at rel 1e-7."""
    from tpumd_torch.ops import gather, gran_cellgrid
    from tpumd_torch.script.parser import LammpsScript
    for name in ("granwall", "granhertz", "granhooke", "pour"):
        gran_counts_reset()
        text = (GRAN_GOLDEN / f"in.{name}").read_text()
        pre, run = text.rsplit("\nrun", 1)
        script = LammpsScript(device="cuda", dtype=torch.float64)
        script.data_dir = str(GRAN_GOLDEN)
        script.run_string(pre)
        sim = script.sim
        sim.verbose = False
        nsteps = int(run.split()[0])
        with counted_setups(sim, []) as setups:
            script.run_string("run" + run)
        ref = [float(v) for v in log_rows(GRAN_GOLDEN / f"log.{name}")[-1]]
        v = sim.last_thermo
        got = ([sim.natoms, v["ke"]] if name == "pour"
               else [v["ke"], v["c_rot"]])
        for g, r in zip(got, ref[1:]):
            if not abs(g - r) <= 2e-6 * abs(r) + 1e-9:
                raise AssertionError(f"{name}: last row {got} vs the "
                                     f"reference log's {ref}")
        evals = force_evals_of(sim, len(setups), nsteps)
        if name == "granhooke":
            if sim._ctx.is_cellgrid or gran_cellgrid.counts.kernel_launches:
                raise AssertionError("granhooke: not on the matrix engine")
            launched = check_p1(name, nsteps)
        else:
            if not sim._ctx.is_cellgrid:
                raise AssertionError(f"{name}: \"auto\" chose the matrix "
                                     "engine")
            launched = check_b6(name, evals, name == "granhertz")
        phase("main", f"golden {name} on the card (f64, "
                      f"{'grid' if sim._ctx.is_cellgrid else 'matrix'}): last "
                      f"row {got} = the reference log's {ref[1:]} to 2e-6; "
                      f"{len(setups)} set-ups; {launched}")
    d = GOLDEN.parent / "wall_lj93"
    gather.counts.reset()
    script = LammpsScript(device="cuda", dtype=torch.float64)
    pre, run = (d / "in.test").read_text().rsplit("\nrun", 1)
    script.run_string(pre)
    script.sim.verbose = False
    script.run_string("run" + run)
    ref = np.loadtxt(d / "thermo.csv")[-1]
    v = script.sim.last_thermo
    for k, col, rtol, atol in (("temp", 1, 1e-7, 1e-10),
                               ("epair", 2, 1e-7, 0.0),
                               ("emol", 3, 1e-7, 1e-7),
                               ("etotal", 4, 1e-7, 0.0),
                               ("press", 5, 1e-6, 1e-6)):
        if not abs(v[k] - ref[col]) <= rtol * abs(ref[col]) + atol:
            raise AssertionError(f"wall_lj93 {k}: {v[k]!r} vs {ref[col]}")
    phase("main", f"golden wall_lj93 on the card (f64, matrix engine) = "
                  f"thermo.csv's last row to 1e-7: temp {v['temp']!r} "
                  f"epair {v['epair']!r}; "
                  f"{check_p1('wall_lj93', int(run.split()[0]))}")


def contact_counts(s, neigh):
    """(slots,) each sphere's touching partners (r < r_i + r_j) along its
    row of the grid's pair list, which holds every pair within cutneigh:
    the count the history tables cap at KH = 12."""
    from tpumd_torch.ops.cellgrid_pairlist import image_shift, unpack
    kk = max(int(neigh.npairs.max()), 1)
    live = (torch.arange(kk, device=s.x.device)[None, :]
            < neigh.npairs[:, None])
    # a row's tail past npairs is unspecified: slot 0 stands in there
    j = torch.where(live, unpack(neigh.pairs[:, :kk])[0], 0).long()
    d0 = s.x[:, None, :] - s.x[j]
    d = s.x[:, None, :] - (s.x[j] + image_shift(d0, s.box))
    radsum = s.radius[:, None] + s.radius[j]
    return ((d * d).sum(-1) < radsum * radsum).logical_and(live).sum(1)


def granhertz32k_setup(dtype):
    from tpumd_torch.bench_targets import IN_GRANHERTZ32K
    from tpumd_torch.script.parser import LammpsScript
    script = LammpsScript(device="cuda", dtype=dtype)
    script.run_string(IN_GRANHERTZ32K)
    script.sim.verbose = False
    return script


def gran_hertz_vs_plain(script, ptxas_log: str) -> dict:
    """B6 HERTZ over the grid's pair list against its plain list sweep
    (forces and torques to TOL_LIST) and the stencil oracle (TOL) at
    granhertz32k's shape after 500 steps of the f64 run (contacts live),
    f32 and f64, both shearupdate values, the history as it is and scaled
    by 40, history tags equal; timed in f32 with shearupdate in the order
    plain, kernel, kernel, plain, beside its bound."""
    from tpumd_torch.ops.gran_cellgrid import gran_cellgrid, \
        gran_compact_sums, gran_pairlist_plain
    regs = re.findall(r"gran_pairlist_kernelI([fd])Lb(\d)ELb(\d)ELb(\d)E"
                      r"Lb1E.*?\n.*?(\d+) bytes spill stores.*?\n.*?"
                      r"Used (\d+) registers", ptxas_log)
    phase("kernel", "gran_cellgrid HERTZ ptxas (type, shearupdate, freeze, "
                    "limit_damping: registers, spill store bytes): "
                    + "; ".join(f"{t}{a}{b}{c}: {r}, {sp}"
                                for t, a, b, c, sp, r in regs))
    sim = script.sim
    out = {}
    for dtype in (torch.float32, torch.float64):
        worst = {"list": 0.0, "stencil": 0.0}
        for scale in (1.0, 40.0):
            args, planes, c, plist = gran_args(script, dtype, scale)
            if not c.hertz:
                raise AssertionError("granhertz32k: coefficients not HERTZ")
            x, tag, valid, stags, shear, box, _ = args
            for su in (True, False):
                what = f"gran HERTZ 32k {dtype} scale {scale} shearupdate {su}"
                over = torch.zeros(2, dtype=torch.int32, device=x.device)
                k = gran_cellgrid(*args, c, planes, 1e-3, su, plist,
                                  over[:1])
                worst["list"] = max(worst["list"], check_gran(
                    what + " vs list", k, gran_pairlist_plain(
                        x, tag, stags, shear, box, c, planes, 1e-3, su,
                        *plist[:2], over[1:]), TOL[dtype], TOL_LIST[dtype]))
                if over[0] != over[1]:
                    raise AssertionError(f"{what}: spheres past KH "
                                         f"{over.tolist()} (kernel, plain)")
                worst["stencil"] = max(worst["stencil"], check_gran(
                    what + " vs stencil", k, gran_compact_sums(
                        *args, c, planes, 1e-3, su), TOL[dtype]))
        cfg = sim._neigh_cfg
        phase("kernel", f"gran_cellgrid HERTZ grid {cfg.nx}x{cfg.ny}x"
                        f"{cfg.nz} cap {cfg.cap} K {plist[0].shape[1]} "
                        f"{str(dtype)[6:]}: max|kernel - plain| = "
                        f"{worst['list']:.3g} of max|f| and max|torque| "
                        f"against the plain list sweep (tol "
                        f"{TOL_LIST[dtype]:g}), {worst['stencil']:.3g} "
                        f"against the stencil oracle (tol {TOL[dtype]:g}), "
                        f"history tags and the count past KH equal")
    args, planes, c, plist = gran_args(script, torch.float32)
    x, tag, valid, stags, shear, box, _ = args
    kern = (lambda: gran_cellgrid(*args, c, planes, 1e-3, True, plist))
    plain = (lambda: gran_pairlist_plain(x, tag, stags, shear, box, c,
                                         planes, 1e-3, True, *plist[:2]))
    fk, fp = kern()[0], plain()[0]
    out["max_abs_err"] = float((fk - fp).abs().max())
    p1 = cuda_ms(plain, 10, ahead=False)
    k1 = cuda_ms(kern, 200)
    k2 = cuda_ms(kern, 200)
    p2 = cuda_ms(plain, 10, ahead=False)
    # read-only (thermo): no history written, the empty slots' tables not
    # zeroed
    k_ro = cuda_ms(lambda: gran_cellgrid(*args, c, planes, 1e-3, False,
                                         plist), 200)
    out.update(ms=min(k1, k2), plain_ms=min(p1, p2))
    ncontact = int((plain()[2] != 0).sum()) // 2
    np_ = sim._neigh_cfg.capacity
    # the bytes as B6's Hooke entry; a contact's arithmetic as
    # OPS_GRAN_PAIR and polyhertz's sqrt, its argument (4) and the three
    # products it scales (ccel and fs: 4)
    nbytes = gran_bytes(sim.natoms, plist[1])
    out["bound_ms"], out["bound_by"] = roof(
        ncontact * (OPS_GRAN_PAIR + 1 + 4 + 4), nbytes)
    phase("kernel", f"gran_cellgrid HERTZ at granhertz32k's shape, f32, "
                    f"shearupdate: kernel {k1:.4f} / {k2:.4f} ms, plain "
                    f"list sweep {p1:.4f} / {p2:.4f} ms; read-only "
                    f"(thermo) kernel {k_ro:.4f} ms; {ncontact} "
                    f"contacts; {sim.natoms} spheres in {np_} slots, "
                    f"{nbytes} bytes -> bound {out['bound_ms']:.6f} ms "
                    f"({out['bound_by']}); the empty slots' outputs the "
                    f"kernel zeroes: {(np_ - sim.natoms) * 4 * (6 + 48)} "
                    f"bytes more")
    return out


def granhertz32k_path(smi: str, ptxas_log: str) -> tuple[dict, dict]:
    """granhertz32k (bench_targets.IN_GRANHERTZ32K, 32,474 spheres): in
    f64 to step 500 on the card, rows 0, 100 and 500 against the analytic
    step-0 ke and tpumd's f64 rows (granhertz32k_gate), then B6 HERTZ
    against its plain version at that state; in f32: step 0 and the rows
    of steps 100 and 500 against the f64 run's, 500 more timed steps, B6
    HERTZ launched once per force evaluation and no plain call, and a
    profile of 20 steps.  In both runs no sphere may touch more than KH =
    12 others in any sweep (the kernel's hist_over; its contacts past the
    12th would lose their history), and the largest count at the end is
    reported.  Returns (the kernel's entry, the main path's)."""
    from tpumd_torch.bench_targets import GRANHERTZ32K_N, granhertz32k_gate
    from tpumd_torch.ops.cellgrid_gran import KH
    from tpumd_torch.ops.gran_cellgrid import counts as b6_counts

    def no_history_lost(sim, what):
        lost = int(sim.pair.hist_over)
        if lost:
            raise AssertionError(f"granhertz32k {what}: a sphere touched "
                                 f"{lost} others in a sweep; its contacts "
                                 f"past KH = {KH} lost their history")
    rows = None
    for dtype in (torch.float64, torch.float32):
        gran_counts_reset()
        t0 = time.perf_counter()
        script = granhertz32k_setup(dtype)
        sim = script.sim
        with counted_setups(sim, []) as setups:
            script.run_string("run 0")
            setup_s = time.perf_counter() - t0
            if sim.natoms != GRANHERTZ32K_N:
                raise AssertionError(f"granhertz32k: {sim.natoms} spheres")
            got = {0: dict(sim.last_thermo)}
            script.run_string("run 100")
            got[100] = dict(sim.last_thermo)
            script.run_string("run 400")
            got[500] = dict(sim.last_thermo)
        name = str(dtype)[6:]
        for step, row in got.items():
            # f64 against tpumd's rows, f32 against the f64 run's
            bad = granhertz32k_gate(row, step,
                                    None if rows is None else rows[step])
            if bad:
                raise AssertionError(f"granhertz32k {name} step {step}: "
                                     f"{bad}")
        if dtype == torch.float64:
            no_history_lost(sim, "f64 to step 500")
            rows = got
            k = gran_hertz_vs_plain(script, ptxas_log)
            phase("main", f"granhertz32k f64 on the card: set-up "
                          f"{setup_s:.3f} s; rows 0 {got[0]['ke']!r}, 100 "
                          f"{got[100]['ke']!r} / {got[100]['c_rot']!r}, 500 "
                          f"{got[500]['ke']!r} / {got[500]['c_rot']!r} pass "
                          f"the gates (analytic step 0; tpumd's f64 rows at "
                          f"3x the port's CPU gap)")
            continue
        lt0 = sim.loop_time
        script.run_string("run 500")
        dt = sim.loop_time - lt0
        evals = force_evals_of(sim, len(setups), 1000, nruns=4)
        launched = check_b6("granhertz32k f32", evals, True)
        s, neigh, _ = sim._carry
        if not torch.isfinite(s.x).all():
            raise AssertionError("granhertz32k: non-finite positions")
        live = (neigh.shear_tags != 0).sum(1)
        touching = contact_counts(s, neigh)
        most, full = int(touching.max()), int((touching >= KH).sum())
        no_history_lost(sim, "f32 to step 1000")
        sps = 500 / dt
        cfg = sim._neigh_cfg
        phase("main", f"granhertz32k f32: set-up {setup_s:.3f} s (grid "
                      f"{cfg.nx}x{cfg.ny}x{cfg.nz} cap {cfg.cap}); rows 100 "
                      f"and 500 hold to the f64 run's (ke "
                      f"{got[100]['ke']!r}, {got[500]['ke']!r}; c_rot "
                      f"{got[500]['c_rot']!r}); step 1000 ke "
                      f"{sim.last_thermo['ke']!r} c_rot "
                      f"{sim.last_thermo['c_rot']!r}; contacts per sphere "
                      f"{float(live[neigh.valid].double().mean()):.3f}, at "
                      f"most {most} at step 1000, {full} spheres with "
                      f"{KH} (a full history row: tpumd flags it as an "
                      f"overflow, C7); no sphere touched more than {KH} in "
                      f"any sweep of steps 0-1000 (hist_over 0)")
        phase("main", f"granhertz32k timed 500 steps: {sps:.2f} "
                      f"timesteps/s, {sps * sim.natoms / 1e6:.3f} "
                      f"Matom-step/s on {smi}; {launched}")
        launches = b6_counts.hertz_launches
        phase("main", "granhertz32k " + profile_steps(script, 20,
                                                       1e3 / sps))
        no_history_lost(sim, "f32 to step 1100")
        return k, {"launches": launches, "sps": sps}


def pour20k_path(smi: str) -> dict:
    """pour20k (bench_targets.IN_POUR20K: a 1,600-sphere floor, fix pour
    20000 in a cylinder of radius 20): in f64 and f32 to POUR20K_STEPS on
    the card, the atom count of every thermo row equal to the stored
    counts (POUR20K_ATOMS: the port's f64 run on the CPU, whose
    insertions equal tpumd's bit for bit), B6 once per force evaluation,
    the insertions' host milliseconds and the re-set-ups' beside them; the
    f32 run's last ke against the f64 run's at POUR20K_KE_F32."""
    from tpumd_torch.bench_targets import IN_POUR20K, POUR20K_ATOMS, \
        POUR20K_KE_F32, POUR20K_STEPS
    from tpumd_torch.md.fix_pour import FixPour
    from tpumd_torch.script.parser import LammpsScript
    ke = {}
    for dtype in (torch.float64, torch.float32):
        gran_counts_reset()
        script = LammpsScript(device="cuda", dtype=dtype)
        script.run_string(IN_POUR20K)
        sim = script.sim
        sim.verbose = False
        with counted_setups(sim, []) as setups:
            script.run_string(f"run {POUR20K_STEPS}")
        name = str(dtype)[6:]
        counts = {int(p[0]): int(p[1]) for p in
                  (ln.split() for ln in sim.log_lines)
                  if p and p[0].isdigit()}
        if counts != POUR20K_ATOMS:
            raise AssertionError(f"pour20k {name}: atoms by row {counts} vs "
                                 f"the stored {POUR20K_ATOMS}")
        launched = check_b6(f"pour20k {name}",
                            force_evals_of(sim, len(setups), POUR20K_STEPS),
                            False)
        ke[name] = sim.last_thermo["ke"]
        fx = [f for f in sim.fixes if isinstance(f, FixPour)][0]
        cfg = sim._neigh_cfg
        sps = POUR20K_STEPS / sim.loop_time
        # the run's loop holds the second insertion and its set-up (the
        # first insertion and set-up come before it)
        events = fx.insert_ms[-1] / 1e3 + setups[-1]
        flow = POUR20K_STEPS / (sim.loop_time - events)
        phase("main", f"pour20k {name} on the card: atoms by row = the "
                      f"stored counts {sorted(set(counts.values()))}; "
                      f"insertions' host ms "
                      f"{[round(t, 1) for t in fx.insert_ms]}, set-ups' ms "
                      f"{[round(1e3 * t, 1) for t in setups]}; last ke "
                      f"{ke[name]!r}; grid {cfg.nx}x{cfg.ny}x{cfg.nz} cap "
                      f"{cfg.cap}; {sps:.2f} timesteps/s over the run "
                      f"(the second insertion and its set-up included), "
                      f"{flow:.2f} without them, "
                      f"{flow * sim.natoms / 1e6:.3f} Matom-step/s at the "
                      f"final count on {smi}; {launched}")
    if not abs(ke["float32"] - ke["float64"]) <= POUR20K_KE_F32 * ke[
            "float64"]:
        raise AssertionError(f"pour20k: f32 ke {ke['float32']!r} vs f64 "
                             f"{ke['float64']!r} (rtol {POUR20K_KE_F32})")
    return {"sps": sps}


PAIR_GOLDEN = GOLDEN.parent / "wolfdsf"


def pair_goldens_phase():
    """The eight pair-style logs verbatim in f64 on the card, every printed
    row within one unit of the reference binary's last printed digit
    (tpumd_torch.pair_goldens.failures, the CPU tests' comparison), and
    the 21 reference decks of tpumd's pair tests at those tests'
    tolerances, each on the matrix engine with P1 launched and no plain
    call."""
    from tpumd_torch import pair_goldens as pg
    from tpumd_torch.ops.gather import counts
    from tpumd_torch.script.parser import LammpsScript
    gold = str(GOLDEN.parent)
    notes = []
    t0 = time.perf_counter()
    for name in sorted(pg.DECKS):
        counts.reset()
        with contextlib.redirect_stdout(sys.stderr):
            script = pg.run(gold, name, "cuda", torch.float64)
        bad = pg.failures(gold, name, script)
        if bad or script.sim._ctx.is_cellgrid:
            raise AssertionError(f"pair golden {name}: {bad[:6]}")
        if counts.kernel_launches == 0 or counts.plain_calls:
            raise AssertionError(f"pair golden {name}: row_gather launches "
                                 f"{counts.kernel_launches}, plain calls "
                                 f"{counts.plain_calls}")
        notes.append(f"{name} P1 x{counts.kernel_launches}")
    phase("pair", f"eight pair goldens verbatim in f64 on the card "
                  f"({time.perf_counter() - t0:.1f} s), every printed row "
                  "to the reference binary's digits: " + ", ".join(notes))
    notes = []
    t0 = time.perf_counter()
    for name in sorted(pg.REFERENCE):
        counts.reset()
        script = LammpsScript(device="cuda", dtype=torch.float64)
        with contextlib.redirect_stdout(sys.stderr):
            script.run_string(pg.REFERENCE[name][0])
        bad = pg.reference_failures(name, script.sim.last_thermo)
        if bad or script.sim._ctx.is_cellgrid:
            raise AssertionError(f"reference deck {name}: {bad}")
        if counts.kernel_launches == 0 or counts.plain_calls:
            raise AssertionError(f"reference deck {name}: row_gather "
                                 f"launches {counts.kernel_launches}, plain "
                                 f"calls {counts.plain_calls}")
        notes.append(f"{name} x{counts.kernel_launches}")
    phase("pair", f"21 reference decks of tpumd's pair tests in f64 on the "
                  f"card ({time.perf_counter() - t0:.1f} s) meet the "
                  "reference binary's numbers (temp, epair, etotal 1e-6, "
                  "press 1e-5); P1 launches: " + ", ".join(notes))


def salt_setup(deck: str, dtype):
    """LammpsScript of a salt deck on the card, verbose off, before its
    first run."""
    from tpumd_torch.script.parser import LammpsScript
    script = LammpsScript(device="cuda", dtype=dtype)
    script.run_string(deck.format(golden=PAIR_GOLDEN))
    script.sim.verbose = False
    return script


def tag_order(t, tag):
    return t[torch.argsort(tag)]


def thermo_rows(sim) -> dict:
    """{step: {column: value}} of the printed rows of sim's log."""
    names, rows = None, {}
    for ln in sim.log_lines:
        p = ln.split()
        if p and p[0] == "Step":
            names = list(sim.thermo_style)
        elif names and p and p[0].isdigit() and len(p) == len(names):
            rows[int(p[0])] = dict(zip(names, (float(v) for v in p)))
    return rows


def p1_at_shape(what: str, table, idx, kinds: int) -> dict:
    """P1 at a deck's packed j-row gather (pair_sums) timed as p1_timed
    does: the kernels line's numbers."""
    phase("kernel", f"row_gather bit-equal to plain on the {kinds} kinds of "
                    f"input of {what}'s set-up")
    return p1_timed(f"{what}'s pair_sums shape", table, idx)


def salt_path(smi: str) -> tuple[dict, dict]:
    """The molten salt on the matrix engine (bench_targets.IN_SALT32K and
    IN_SALT32K_DSF, 32,768 ions): the gates, the main path's run in f32
    with its launch counts, and the numbers of the salt decks."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.ops import cellgrid_pairlist, charmm_cellgrid, \
        eam_cellgrid, gather, gran_cellgrid, lj_cellgrid, lj_fene_cellgrid
    grid = (lj_cellgrid.counts, lj_fene_cellgrid.counts,
            eam_cellgrid.rho_counts, eam_cellgrid.force_counts,
            charmm_cellgrid.counts, gran_cellgrid.counts,
            cellgrid_pairlist.counts, cellgrid_pairlist.refresh_counts)
    # 1. IN_SALT32K_DSF in f64: log.borndsf's step 0, the self-energy in
    # ecoul (a replicated perfect lattice has its cell's energies per ion)
    dsf = salt_setup(bt.IN_SALT32K_DSF, torch.float64)
    dsf.run_string("run 0")
    n, vol = dsf.sim.natoms, float(dsf.sim.state.box.volume)
    row = dict(dsf.sim.last_thermo)
    bad = bt.salt_step0_failures(row, True, n, vol, 1e-8)
    if bad or dsf.sim._ctx.is_cellgrid or n != bt.SALT32K_N:
        raise AssertionError(f"IN_SALT32K_DSF step 0 against log.borndsf: "
                             f"{bad}")
    phase("salt", f"IN_SALT32K_DSF f64 step 0 ({n} ions, matrix engine) "
                  f"= log.borndsf's 64-ion row to its last digit: epair "
                  f"{row['epair']!r}, ecoul {row['ecoul']!r} (self-energy "
                  "included), press less (N - 1) T / V "
                  f"{row['press'] - (n - 1) * row['temp'] / vol!r}")
    del dsf
    # 2. IN_SALT32K in f64: the Ewald sum and the 512-ion PPPM rows per
    # ion; the step-0 forces and the step-100 row that f32 must meet
    ref = salt_setup(bt.IN_SALT32K, torch.float64)
    v64 = ref.sim.state.v.clone()
    ref.run_string("run 0")
    row0_64 = dict(ref.sim.last_thermo)
    bad = bt.salt_step0_failures(row0_64, False, n, vol, 1e-10)
    if bad or ref.sim._ctx.is_cellgrid:
        raise AssertionError(f"IN_SALT32K f64 step 0: {bad}")
    ks = ref.sim.kspace
    f0_64 = tag_order(ref.sim.state.f, ref.sim.state.tag).clone()
    ref.run_string("run 100")
    row100_64 = dict(ref.sim.last_thermo)
    fmax100 = float(ref.sim.state.f.abs().max())
    phase("salt", f"IN_SALT32K f64 step 0: epair {row0_64['epair']!r}, "
                  f"ecoul + elong {row0_64['ecoul'] + row0_64['elong']!r} "
                  f"per ion within {bt.SALT_PPPM_EWALD_RTOL} of the Ewald "
                  f"sum ({bt.SALT_EWALD_STEP0}) and = the 512-ion PPPM row "
                  f"to 1e-10; PPPM mesh {ks.nx}x{ks.ny}x{ks.nz}, g_ewald "
                  f"{ks.g_ewald:.6f}; max|f| step 0 "
                  f"{float(f0_64.abs().max()):.3e} (the lattice's vanish), "
                  f"step 100 {fmax100:.4f}")
    del ref
    torch.cuda.empty_cache()
    # 3. the main path: IN_SALT32K in f32 from the f64 deck's velocities,
    # 1,000 steps; the counts are set to 0 just before it and read after
    for c in (gather.counts,) + grid:
        c.reset()
    t0 = time.perf_counter()
    script = salt_setup(bt.IN_SALT32K, torch.float32)
    sim = script.sim
    sim.state = sim.state.replace(v=v64.to(torch.float32))
    seen = {}
    with recording_p1(seen):
        script.run_string("run 0")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    f0 = tag_order(sim.state.f, sim.state.tag).double()
    ferr = float((f0 - f0_64).abs().max())
    if not ferr <= bt.SALT_F32_FORCE_TOL * fmax100:
        raise AssertionError(f"IN_SALT32K f32 step-0 forces: {ferr} > "
                             f"{bt.SALT_F32_FORCE_TOL} * {fmax100}")
    script.run_string("run 100")
    row100 = dict(sim.last_thermo)
    keys = ("temp", "epair", "ecoul", "elong", "etotal", "press")
    bad = bt.gate_failures(row100, {k: (row100_64[k], bt.SALT_F32_ROW_RTOL)
                                    for k in keys})
    if bad:
        raise AssertionError(f"IN_SALT32K step 100, f32 against f64: {bad}")
    script.run_string("run 400")
    lt0 = sim.loop_time
    script.run_string("run 500")
    torch.cuda.synchronize()
    sps = 500 / (sim.loop_time - lt0)
    launches = gather.counts.kernel_launches
    plain = gather.counts.plain_calls + sum(c.plain_calls for c in grid)
    other = sum(c.kernel_launches for c in grid)
    # set-up, every step and one evaluation per thermo row
    force_evals = 1 + bt.SALT32K_STEPS + 10
    if launches < force_evals or plain or other or sim._ctx.is_cellgrid:
        raise AssertionError(f"IN_SALT32K: row_gather launches {launches} < "
                             f"force evaluations {force_evals}, or plain "
                             f"calls {plain}, or grid launches {other}")
    rows = thermo_rows(sim)
    e = np.array([rows[k]["etotal"] for k in sorted(rows)])
    finite = (np.isfinite(np.array([list(r.values())
                                    for r in rows.values()])).all()
              and bool(torch.isfinite(sim.state.x).all())
              and bool(torch.isfinite(sim.state.v).all()))
    if sorted(rows) != list(range(0, 1001, 100)) or not finite:
        raise AssertionError(f"IN_SALT32K: rows {sorted(rows)} or a NaN")
    drift = float(np.abs(e - e[0]).max() / abs(e[0]))
    drift_end = float(abs(e[-1] - e[0]) / abs(e[0]))
    if not drift <= bt.SALT_DRIFT_TOL:
        raise AssertionError(f"IN_SALT32K drift {drift} > "
                             f"{bt.SALT_DRIFT_TOL}")
    neigh = sim._carry[1]
    cfg = sim._neigh_cfg
    phase("salt", f"IN_SALT32K f32 (matrix engine): set-up {setup_s:.3f} s "
                  f"(cells {cfg.nx}x{cfg.ny}x{cfg.nz} cap {cfg.cell_cap}, K "
                  f"{cfg.kmax}, max count {int(neigh.max_count)}); step-0 "
                  f"forces = f64 to {ferr:.3e} (<= {bt.SALT_F32_FORCE_TOL} "
                  f"x the f64 step-100 max|f|); step 100 = f64 to "
                  f"{bt.SALT_F32_ROW_RTOL}: "
                  f"{ {k: row100[k] for k in keys} }; no NaN through step "
                  f"1000; drift over 1,000 steps {drift:.4e} (max), "
                  f"{drift_end:.4e} (end; gate {bt.SALT_DRIFT_TOL})")
    phase("salt", f"IN_SALT32K timed 500 steps: {sps:.2f} timesteps/s, "
                  f"{sps * n / 1e6:.3f} Matom-step/s on {smi}; row_gather "
                  f"launches {launches} >= force evaluations {force_evals}, "
                  f"plain calls {plain}, grid kernel launches {other}")
    phase("salt", "IN_SALT32K " + profile_steps(script, 20, 1e3 / sps))
    s = sim._carry[0]

    def pppm():
        return sim.kspace.compute(s.x, s.q, s.box, False, False)
    pppm_ms = cuda_ms(pppm, 20, ahead=False)
    phase("salt", f"PPPM at IN_SALT32K's shape (mesh {sim.kspace.nx}^3, "
                  f"order {sim.kspace.order}), the force call a step: "
                  f"{pppm_ms:.4f} ms (CUDA events), device time "
                  f"{profiled_device_ms(pppm):.4f} ms (profiler)")
    # P1 against its plain version on every kind of input the set-up gave
    # it, then timed at the packed j-row gather of pair_sums
    p1_equal_plain(seen.values(), "salt input")
    table, idx = next(v for (d, t, _), v in seen.items()
                      if d == torch.float32 and t == (n, 5))
    k = p1_at_shape("IN_SALT32K", table, idx, len(seen))
    del script, sim, s
    torch.cuda.empty_cache()
    # 4. the DSF deck in f32, timed
    dsf = salt_setup(bt.IN_SALT32K_DSF, torch.float32)
    dsf.run_string("run 0")
    dsf.run_string("run 100")
    lt0 = dsf.sim.loop_time
    dsf.run_string("run 500")
    dsf_sps = 500 / (dsf.sim.loop_time - lt0)
    phase("salt", f"IN_SALT32K_DSF f32 timed 500 steps: {dsf_sps:.2f} "
                  f"timesteps/s, {dsf_sps * n / 1e6:.3f} Matom-step/s; "
                  + profile_steps(dsf, 20, 1e3 / dsf_sps))
    del dsf
    torch.cuda.empty_cache()
    return k, {"launches": launches, "sps": sps}


def bonded_goldens_phase():
    """The 14 bonded goldens verbatim in f64 on the card, each on the
    engine "auto" picks (bonded_goldens.ON_GRID: the cell grid with
    B1-special launched; the others the matrix engine with P1 launched)
    and no plain call: their rows and dumps against the reference binary
    (tpumd_torch.bonded_goldens.failures, the CPU tests' comparison) and
    their last rows against the same deck on the CPU; then water_shake
    forced onto the matrix engine against its log and dump."""
    from tpumd_torch import bonded_goldens as bg
    from tpumd_torch.ops import lj_cellgrid
    from tpumd_torch.ops.gather import counts
    gold = str(GOLDEN.parent)
    notes = []
    t0 = time.perf_counter()
    for name in bg.DECKS:
        with tempfile.TemporaryDirectory() as cpu_dir, \
                tempfile.TemporaryDirectory() as where:
            cpu = bg.run(gold, name, cpu_dir, "cpu", torch.float64)
            counts.reset()
            lj_cellgrid.counts.reset()
            script = bg.run(gold, name, where, "cuda", torch.float64)
            launches, plain = counts.kernel_launches, counts.plain_calls
            if name in bg.ON_GRID:
                launches = lj_cellgrid.counts.special_launches
                plain += lj_cellgrid.counts.plain_calls
            bad = bg.failures(gold, name, script, where)
        got, want = script.sim.last_thermo, cpu.sim.last_thermo
        for key, w in want.items():
            if not abs(got[key] - w) <= 1e-9 * max(abs(w), 1e-6):
                bad.append(f"{name} {key}: card {got[key]!r} vs CPU {w!r}")
        kernel = "B1-special" if name in bg.ON_GRID else "P1"
        if bad or launches == 0 or plain:
            raise AssertionError(f"bonded golden {name}: {bad[:6]}; "
                                 f"{kernel} launches {launches}, plain "
                                 f"calls {plain}")
        extra = ""
        if name == "bq":
            extra = (f", {int((~script.sim.bonded['bond'].alive).sum())} "
                     "bonds broken")
        notes.append(f"{name} {kernel} x{launches}{extra}")
    phase("bonded", f"14 bonded goldens verbatim in f64 on the card "
                    f"({time.perf_counter() - t0:.1f} s, with their CPU "
                    "runs), rows and dumps to the reference binary at "
                    "tpumd's tests' tolerances, last rows = the CPU's to "
                    "1e-9: " + ", ".join(notes))
    counts.reset()
    with tempfile.TemporaryDirectory() as where:
        script = bg.run_water_shake_matrix(gold, where, "cuda",
                                           torch.float64)
        bad = bg.water_shake_failures(gold, script, where)
    if bad or counts.kernel_launches == 0 or counts.plain_calls:
        raise AssertionError(f"water_shake on the matrix engine: {bad[:6]}"
                             f"; row_gather launches "
                             f"{counts.kernel_launches}, plain calls "
                             f"{counts.plain_calls}")
    phase("bonded", "water_shake (SHAKE, PPPM) forced onto the matrix "
                    "engine in f64: its log's rows and dump.water to the "
                    "reference binary at test_golden_water's tolerances; "
                    f"P1 x{counts.kernel_launches}")


def hyb_setup(data: Path, n: int, dtype, thermo: int = 100,
              mode: str = "matrix"):
    """LammpsScript of IN_HYB32K (n^3 cells) on the card, verbose off,
    before its first run, on the engine mode: the matrix engine by default
    (the hyb32k path's; "auto" takes the grid since B1-special)."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.script.parser import LammpsScript
    script = LammpsScript(device="cuda", dtype=dtype)
    with contextlib.redirect_stdout(sys.stderr):
        script.run_string(bt.IN_HYB32K.format(data=data, n=n,
                                              thermo=thermo))
    script.sim.verbose = False
    script.sim.neighbor_mode = mode
    return script


def hyb32k_path(smi: str) -> tuple[dict, dict]:
    """The hyb32k liquid on the matrix engine (bench_targets.IN_HYB32K,
    32,000 atoms): the cell against tpumd's rows, the 32k gates, the main
    path's run in f32 with its launch counts, and P1 at its shape."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.ops import cellgrid_pairlist, charmm_cellgrid, \
        eam_cellgrid, gather, gran_cellgrid, lj_cellgrid, lj_fene_cellgrid
    grid = (lj_cellgrid.counts, lj_fene_cellgrid.counts,
            eam_cellgrid.rho_counts, eam_cellgrid.force_counts,
            charmm_cellgrid.counts, gran_cellgrid.counts,
            cellgrid_pairlist.counts, cellgrid_pairlist.refresh_counts)
    n3 = bt.HYB32K_REPLICAS ** 3
    with tempfile.TemporaryDirectory() as tmpdir:
        data = Path(tmpdir) / "data.hyb"
        t0 = time.perf_counter()
        bt.hyb_cell(data)
        gen_s = time.perf_counter() - t0
        # 1. the cell in f64 against tpumd's rows at steps 0 and 100
        cell = hyb_setup(data, 1, torch.float64)
        cell.run_string("run 0")
        c0 = dict(cell.sim.last_thermo)
        cell_n = cell.sim.natoms
        cell_vol = float(cell.sim.state.box.volume)
        cell.run_string("run 100")
        c100 = dict(cell.sim.last_thermo)
        bad = bt.gate_failures(c0, {k: (v, 1e-10) for k, v in
                                    bt.HYB_CELL_STEP0.items()
                                    if k != "ebond"})
        bad += bt.gate_failures(c100, {k: (v, 1e-7) for k, v in
                                       bt.HYB_CELL_STEP100.items()})
        if bad or cell.sim._ctx.is_cellgrid:
            raise AssertionError(f"hyb cell f64 against tpumd: {bad}")
        phase("hyb32k", f"cell ({cell_n} atoms, {bt.HYB_DENSITY} g/cm^3, "
                        f"written in {gen_s:.3f} s) in f64 on the card = "
                        "tpumd's rows at step 0 (1e-10) and step 100 (1e-7): "
                        f"etotal {c0['etotal']!r}, {c100['etotal']!r}")
        del cell
        # 2. the 32k deck in f64: step 0 against 125 x the cell, then the
        # step-100 row and forces that f32 must meet
        ref = hyb_setup(data, bt.HYB32K_REPLICAS, torch.float64)
        v64 = ref.sim.state.v.clone()
        ref.run_string("run 0")
        n, vol = ref.sim.natoms, float(ref.sim.state.box.volume)
        row0_64 = dict(ref.sim.last_thermo)
        bad = bt.hyb_step0_failures(row0_64, c0, n3, n, vol, cell_n,
                                    cell_vol, ref.sim.units)
        if bad or ref.sim._ctx.is_cellgrid or n != n3 * cell_n:
            raise AssertionError(f"IN_HYB32K f64 step 0: {bad}")
        f0_64 = tag_order(ref.sim.state.f, ref.sim.state.tag).clone()
        fmax0 = float(f0_64.abs().max())
        ref.run_string("run 100")
        row100_64 = dict(ref.sim.last_thermo)
        terms64 = bt.hyb_term_forces(ref.sim)
        x100 = tag_order(ref.sim.state.x, ref.sim.state.tag)
        phase("hyb32k", f"IN_HYB32K f64 step 0 ({n} atoms, matrix engine): "
                        f"epair, ebond, eangle, edihed, eimp = {n3} x the "
                        f"cell's to {bt.HYB_STEP0_RTOL} and its virial "
                        "pressure to the cell's: "
                        f"{ {k: row0_64[k] for k in bt.HYB_KEYS} }; max|f| "
                        f"{fmax0:.4f}")
        del ref
        # 2b. each term alone (the pair, each bonded sub-style) in f32 on
        # the f64 run's step-100 positions, against f64 there
        probe = hyb_setup(data, bt.HYB32K_REPLICAS, torch.float32)
        st = probe.sim.state
        probe.sim.state = st.replace(x=x100[st.tag - 1].to(torch.float32))
        probe.run_string("run 0")
        gaps = bt.hyb_term_gaps(bt.hyb_term_forces(probe.sim), terms64)
        del probe, st, x100
        torch.cuda.empty_cache()
        bad = [f"{k} {g} > {bt.HYB_F32_TERM_TOL[k]}" for k, g in gaps.items()
               if not g <= bt.HYB_F32_TERM_TOL[k]]
        if bad or sorted(gaps) != sorted(bt.HYB_F32_TERM_TOL):
            raise AssertionError(f"IN_HYB32K f32 terms at step 100: {bad}, "
                                 f"terms {sorted(gaps)}")
        phase("hyb32k", "IN_HYB32K each term alone in f32 on the f64 run's "
                        "step-100 positions = f64, of its own max|f| (gate "
                        "3x the CPU's 32k gap): " + ", ".join(
                            f"{k} {g:.3e} ({bt.HYB_F32_TERM_TOL[k]:.3e})"
                            for k, g in gaps.items()))
        # 3. the main path: f32 from the f64 deck's velocities, 1,000
        # steps; the counts are set to 0 just before it and read after
        for c in (gather.counts,) + grid:
            c.reset()
        t0 = time.perf_counter()
        script = hyb_setup(data, bt.HYB32K_REPLICAS, torch.float32)
        sim = script.sim
        sim.state = sim.state.replace(v=v64.to(torch.float32))
        seen = {}
        with recording_p1(seen):
            script.run_string("run 0")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
    f0 = tag_order(sim.state.f, sim.state.tag).double()
    ferr = float((f0 - f0_64).abs().max())
    if not ferr <= bt.HYB_F32_FORCE_TOL * fmax0:
        raise AssertionError(f"IN_HYB32K f32 step-0 forces: {ferr} > "
                             f"{bt.HYB_F32_FORCE_TOL} * {fmax0}")
    script.run_string("run 100")
    row100 = dict(sim.last_thermo)
    bad = bt.gate_failures(row100, {k: (row100_64[k], bt.HYB_F32_ROW_RTOL)
                                    for k in bt.HYB_KEYS})
    if bad:
        raise AssertionError(f"IN_HYB32K step 100, f32 against f64: {bad}")
    lt0 = sim.loop_time
    script.run_string("run 500")
    torch.cuda.synchronize()
    sps = 500 / (sim.loop_time - lt0)
    script.run_string("run 400")
    launches = gather.counts.kernel_launches
    plain = gather.counts.plain_calls + sum(c.plain_calls for c in grid)
    other = sum(c.kernel_launches for c in grid)
    # set-up, every step and one evaluation per thermo row
    force_evals = 1 + bt.HYB32K_STEPS + 10
    if launches < force_evals or plain or other or sim._ctx.is_cellgrid:
        raise AssertionError(f"IN_HYB32K: row_gather launches {launches} < "
                             f"force evaluations {force_evals}, or plain "
                             f"calls {plain}, or grid kernel launches {other}")
    rows = thermo_rows(sim)
    e = np.array([rows[k]["etotal"] for k in sorted(rows)])
    s, neigh, _ = sim._carry
    finite = (np.isfinite(np.array([list(r.values())
                                    for r in rows.values()])).all()
              and bool(torch.isfinite(s.x).all())
              and bool(torch.isfinite(s.v).all()))
    ntags = int(torch.unique(s.tag[s.tag > 0]).numel())
    if sorted(rows) != list(range(0, 1001, 100)) or not finite \
            or ntags != n or bool(neigh.overflow):
        raise AssertionError(f"IN_HYB32K: rows {sorted(rows)}, finite "
                             f"{finite}, atoms {ntags}, overflow "
                             f"{bool(neigh.overflow)}")
    drift = float(np.abs(e - e[0]).max() / abs(e[0]))
    drift_end = float(abs(e[-1] - e[0]) / abs(e[0]))
    if not drift <= bt.HYB_DRIFT_TOL:
        raise AssertionError(f"IN_HYB32K drift {drift} > "
                             f"{bt.HYB_DRIFT_TOL}")
    cfg = sim._neigh_cfg
    phase("hyb32k", f"IN_HYB32K f32 (matrix engine): set-up {setup_s:.3f} s "
                    f"(cells {cfg.nx}x{cfg.ny}x{cfg.nz} cap {cfg.cell_cap}, "
                    f"K {cfg.kmax}, max count {int(neigh.max_count)}); "
                    f"step-0 forces = f64 to {ferr:.3e} (<= "
                    f"{bt.HYB_F32_FORCE_TOL} x max|f| {fmax0:.4f}); step 100 "
                    f"= f64 to {bt.HYB_F32_ROW_RTOL}: "
                    f"{ {k: row100[k] for k in bt.HYB_KEYS} }; 1,000 steps, "
                    f"{ntags} atoms, no NaN, no overflow; drift "
                    f"{drift:.4e} (max), {drift_end:.4e} (end; "
                    f"gate {bt.HYB_DRIFT_TOL:.4e})")
    phase("hyb32k", f"IN_HYB32K timed 500 steps: {sps:.2f} timesteps/s, "
                    f"{sps * n / 1e6:.3f} Matom-step/s on {smi}; row_gather "
                    f"launches {launches} >= force evaluations {force_evals}"
                    f" ({launches / force_evals:.2f} a force evaluation; "
                    f"one a bonded style), plain calls {plain}, grid kernel "
                    f"launches {other}")
    phase("hyb32k", "IN_HYB32K " + profile_steps(script, 20, 1e3 / sps))
    # P1 against its plain version on every kind of input the set-up gave
    # it, then timed at the packed j-row gather of pair_sums
    p1_equal_plain(seen.values(), "hyb32k input")
    # the packed j rows (x and type, or with q): the last K the set-up took
    table, idx = [v for (d, t, i), v in seen.items()
                  if d == torch.float32 and t[0] == n and t[1] in (4, 5)
                  and len(i) == 2 and i[0] == n][-1]
    k = p1_at_shape("IN_HYB32K", table, idx, len(seen))
    del script, sim, s
    torch.cuda.empty_cache()
    return k, {"launches": launches, "sps": sps, "row0_64": row0_64,
               "row100_64": row100_64}

HOST_GOLDENS = {"fix_forces": 5, "press_ber": 6, "deform": 10, "fix_move": 5}


def host_goldens_phase():
    """The five fix and minimizer goldens verbatim in f64 on the card, on
    the cell grid: fix_forces, press_ber, deform and fix_move, every row of
    thermo.csv at rtol 2e-6 (tpumd's tests' tolerance), and min_cg (1,000
    cg iterations) to efinal.txt at 1e-8, B1 launched once per force
    evaluation (the set-up's and the minimizer's); B1 launched on each and
    no plain call."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.ops import lj_cellgrid
    from tpumd_torch.script.parser import LammpsScript
    notes = []
    for name in (*HOST_GOLDENS, "min_cg"):
        d = GOLDEN.parent / name
        lj_cellgrid.counts.reset()
        reset_list_counts()
        t0 = time.perf_counter()
        script = LammpsScript(device="cuda", dtype=torch.float64)
        script.data_dir = str(d)
        with contextlib.redirect_stdout(sys.stderr):
            script.run_string((d / "in.test").read_text())
        sim = script.sim
        if not sim._ctx.is_cellgrid:
            raise AssertionError(f"golden {name}: not on the cell grid")
        if name == "min_cg":
            want = float((d / "efinal.txt").read_text())
            got = sim.last_thermo["etotal"]
            if abs(got - want) > 1e-8 * abs(want):
                raise AssertionError(f"golden min_cg: etotal {got!r} vs "
                                     f"{want!r}")
            st = sim.min_stats
            evals = 1 + st["evaluations"]
            what = (f"etotal {got!r} (efinal {want!r}), {st['iterations']} "
                    f"iterations, {st['evaluations']} evaluations")
        else:
            rows = bt.golden_rows(sim.log_lines, HOST_GOLDENS[name])
            ref = np.loadtxt(d / "thermo.csv")
            worst = 0.0
            for r in np.atleast_2d(ref):
                mine = np.asarray(rows[int(r[0])][1:])
                bad = np.abs(mine - r[1:]) > 2e-6 * np.abs(r[1:]) + 1e-8
                if bad.any():
                    raise AssertionError(f"golden {name} step {int(r[0])}: "
                                         f"{mine} vs {r[1:]}")
                worst = max(worst, float(np.max(np.abs(mine - r[1:]) / (
                    np.abs(r[1:]) + 1e-8))))
            evals = None
            what = f"{len(np.atleast_2d(ref))} rows to {worst:.2g}"
        launches = lj_cellgrid.counts.kernel_launches
        plain = lj_cellgrid.counts.plain_calls + list_counts()[2]
        if not launches or plain or (evals is not None and launches != evals):
            raise AssertionError(f"golden {name}: B1 launches {launches} "
                                 f"(evaluations {evals}), plain {plain}")
        notes.append(f"{name} {what}, B1 x{launches} "
                     f"({time.perf_counter() - t0:.1f} s)")
    phase("hostfix", "five goldens verbatim in f64 on the card agree with "
                     "the reference binary's files: " + "; ".join(notes))


def b1_list_check(name: str, sim) -> tuple[float, float]:
    """B1 over the carried list against its stencil oracle, both in f64
    on the run's state: the energies to TOL_ORACLE relative, the forces to
    1e-9 absolute (at a minimum the forces cancel to ~1e-3, so a relative
    force test reads rounding; a pair that the list missed under a moving
    box or the minimizer's trial moves gives ~1e-2 and more).  Returns
    (max|df|, the oracle's energy per atom).  Its launch is a comparison's:
    it leaves the launch count as it was."""
    from tpumd_torch.ops.lj_cellgrid import counts, lj_cellgrid, \
        lj_cellgrid_plain
    launched = counts.kernel_launches
    s, neigh, _ = sim._carry
    x, box = s.x.double(), box_f64(s.box)
    c = sim.pair.kernel_coeffs()
    fk, ek, _ = lj_cellgrid(x, neigh.valid, box, sim._neigh_cfg, c, 1, 0,
                            (neigh.pairs, neigh.npairs, neigh.row2slot))
    fo, eo, _ = lj_cellgrid_plain(x, neigh.valid, box, sim._neigh_cfg, c, 1,
                                  0)
    torch.cuda.synchronize()
    counts.kernel_launches = launched
    df = float((fk - fo).abs().max())
    ek, eo = float(ek), float(eo)
    if not df <= 1e-9 or abs(ek - eo) > TOL_ORACLE[torch.float64] * abs(eo):
        raise AssertionError(f"{name}: B1 over the list against the "
                             f"stencil oracle: max|df| {df}, energy {ek!r} "
                             f"vs {eo!r}")
    return df, eo / sim.natoms


def b1_at_state(tag: str, sim, eflag: int, vflag: int) -> dict:
    """B1 at a deck's final state, in the state's dtype, with the flags its
    path launches it with, against its plain list sweep and the stencil
    oracle in f64.  f32: B1's max|f - f_oracle| within F32_GAP_FACTOR
    times the plain sweep's (both round the same sums in f32, in another
    order; a relative test reads rounding where forces cancel, as at a
    minimum), its energy and virial within TOL of the plain sweep's.  f64:
    B1 over the list against the oracle as b1_list_check holds it (forces
    to 1e-9 absolute, the energy to TOL_ORACLE: a pair missing from the
    list shows), the virial within TOL of the plain sweep's.  Timed
    against the plain sweep (time_kernel) and bounded as
    lj_kernel_vs_plain bounds in.lj's, the operations over the peak of
    the state's dtype: the kernels line's figures."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.ops.lj_cellgrid import lj_cellgrid, lj_cellgrid_plain, \
        lj_pairlist_plain
    s, neigh, _ = sim._carry
    x, valid, box, cfg = s.x, neigh.valid, s.box, sim._neigh_cfg
    f64 = x.dtype == torch.float64
    c = sim.pair.kernel_coeffs()
    plist = (neigh.pairs, neigh.npairs, neigh.row2slot)
    fk, ek, wk = lj_cellgrid(x, valid, box, cfg, c, 1, 1, plist)
    fp, ep, wp = lj_pairlist_plain(x, box, c, 1, 1, *plist[:2])
    fo, eo, _ = lj_cellgrid_plain(x.double(), valid, box_f64(box), cfg, c,
                                  1, 1)
    torch.cuda.synchronize()
    err_k = float((fk.double() - fo).abs().max())
    err_p = float((fp.double() - fo).abs().max())
    dw = float((wk - wp).abs().max())
    tol = TOL[x.dtype]
    if f64:
        de = abs(float(ek) - float(eo))
        bad = not err_k <= 1e-9 or de > TOL_ORACLE[x.dtype] * abs(float(eo))
        gate = ("max|f - f_oracle| 1e-9, the energy within "
                f"{TOL_ORACLE[x.dtype]:g} of the oracle's")
    else:
        de = abs(float(ek) - float(ep))
        bad = not err_k <= bt.F32_GAP_FACTOR * err_p or \
            de > tol * abs(float(ep))
        gate = (f"{bt.F32_GAP_FACTOR:g}x the plain sweep's max|f - "
                f"f_oracle|, the energy within {tol:g} of the plain sweep's")
    if bad or dw > tol * float(wp.abs().max()):
        raise AssertionError(
            f"{tag}: B1 {x.dtype} against the f64 oracle max|df| {err_k} "
            f"(the plain sweep's {err_p}), energy {float(ek)!r} vs plain "
            f"{float(ep)!r} oracle {float(eo)!r}, virial max|dw| {dw}")
    out = {"max_abs_err": float((fk - fp).abs().max())}
    K = plist[0].shape[1]
    name = "f64" if f64 else "f32"
    shape = f"{tag} final-state {name} e{eflag}v{vflag}"
    phase("kernel", f"lj_cellgrid at {tag}'s final state ({name}, grid "
                    f"{cfg.nx}x{cfg.ny}x{cfg.nz} cap {cfg.cap} K {K}, e{eflag}"
                    f"v{vflag}): max|f - f_oracle| {err_k:.3g} (the plain "
                    f"sweep's {err_p:.3g}; gates: {gate}, the virial within "
                    f"{tol:g} of the plain sweep's), max|f - f_plain| "
                    f"{out['max_abs_err']:.3g}")
    out.update(time_kernel(
        f"lj_cellgrid {tag}",
        lambda: lj_cellgrid(x, valid, box, cfg, c, eflag, vflag, plist),
        lambda: lj_pairlist_plain(x, box, c, eflag, vflag, *plist[:2]),
        lambda: lj_cellgrid(x, valid, box, cfg, c, 1, 1, plist),
        shape=shape, dtype=name))
    nlj, _ = pair_counts(x, valid, box, cfg, c.cutsq)
    np_, isz = cfg.capacity, x.element_size()
    # x and validity read, f (and the energies, the virials) written
    nbytes = np_ * (3 * isz + 1 + 3 * isz + isz * eflag + 6 * isz * vflag) \
        + 3 * isz
    out["bound_ms"], out["bound_by"] = bound(
        nlj, 0, nbytes, PEAK_F64_FLOPS if f64 else PEAK_F32_FLOPS)
    phase("kernel", f"lj_cellgrid {tag} bound: {nlj} unordered in-cutoff "
                    f"pairs, {nbytes} bytes -> {out['bound_ms']:.6f} ms "
                    f"({out['bound_by']})")
    return out


def build_figures(name: str, sim) -> dict:
    """The list build against its plain build, timed at a deck's final
    state (time_build)."""
    s, neigh, _ = sim._carry
    return time_build(name, (s.x, neigh.valid, s.tag, None, None, s.box,
                             sim._neigh_cfg, sim._ctx.pairlist_k, None, ()))


def min_path(smi: str) -> dict:
    """IN_LJ_MIN32K (in.lj's 32,000-atom box displaced by up to 0.08
    sigma, min_style cg; displaced again, fire) in f64, then in f32; B1
    launches = force evaluations (the set-up's and the evaluator's), no
    plain call; iterations, evaluations, host reads per iteration and ms
    per iteration.  f64: the final pe per atom of each minimization at the
    lattice's to 1e-9 relative.  f32: after each minimization B1 over the
    list against its stencil oracle in f64 (b1_list_check), whose energy
    splits the pe's gap to the lattice into the f32 box's own lattice
    (bench_targets.lattice_pe: the box rounded to f32 holds another
    density), the distance of the positions from that lattice in f64, and
    the f32 energy's rounding; the deck's final pe (fire's) within
    F32_GAP_FACTOR times the CPU's gap at 4^3 cells of its own box's
    lattice.  Then B1 (b1_at_state), the list build and refresh at the
    final state against their plain versions, timed."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.ops.lj_cellgrid import counts
    from tpumd_torch.script.parser import LammpsScript
    ncells = 20
    lines = bt.IN_LJ_MIN32K.format(n=ncells).splitlines()
    cut = lines.index("displace_atoms  all random 0.08 0.08 0.08 12345")
    out = {}
    for dtype in (torch.float64, torch.float32):
        counts.reset()
        reset_list_counts()
        script = LammpsScript(device="cuda", dtype=dtype)
        notes, evals, gaps, rebins = [], 0, [], 0
        for part in (lines[:cut], lines[cut:]):
            with contextlib.redirect_stdout(sys.stderr):
                script.run_string("\n".join(part))
            sim = script.sim
            st = sim.min_stats
            pe = sim.last_thermo["pe"]
            evals += 1 + st["evaluations"]     # the set-up's, then its own
            # a trial's re-bin builds a list even where the trial is
            # rejected: the evaluator counts them all
            rebins += st["rebins"]
            it = max(st["iterations"], 1)
            note = (f"{st['style']}: pe/atom {pe!r}, {st['iterations']} "
                    f"iterations, {st['evaluations']} force evaluations, "
                    f"{st['reads'] / it:.2f} host reads and "
                    f"{1e3 * st['seconds'] / it:.3f} ms an iteration "
                    f"({1e3 * st['seconds'] / st['evaluations']:.3f} ms an "
                    f"evaluation), {st['rebins']} re-bins")
            if dtype == torch.float64:
                gap = abs(pe - bt.LATTICE_PE) / abs(bt.LATTICE_PE)
                note += f", gap to the lattice {gap:.3g}"
            else:
                _, pe64 = b1_list_check(
                    f"IN_LJ_MIN32K f32 after {st['style']}", sim)
                s = sim._carry[0]
                pe_box = bt.lattice_pe((s.box.hi - s.box.lo).double().cpu()
                                       .numpy(), ncells)
                gap = abs(pe - pe_box) / abs(pe_box)

                def rel(a, b):
                    return f"{(a - b) / abs(b):+.3g}"
                note += (f"; pe - the lattice's {rel(pe, bt.LATTICE_PE)} = "
                         f"the f32 box's lattice {rel(pe_box, bt.LATTICE_PE)}"
                         f" + the positions in f64 {rel(pe64, pe_box)} + "
                         f"f32 rounding {rel(pe, pe64)} (B1 = the oracle "
                         f"there)")
            gaps.append(gap)
            notes.append(note)
        if dtype == torch.float64:
            tol, gated = bt.MIN32K_F64_RTOL, gaps
            what = f"the lattice's {bt.LATTICE_PE}"
        else:
            tol, gated = bt.F32_GAP_FACTOR * bt.MIN32K_F32_CPU_GAP, gaps[1:]
            what = ("the lattice of its f32 box (the deck's final pe; cg's "
                    f"gap to it {gaps[0]:.3g}, ungated)")
        launches, plain = counts.kernel_launches, counts.plain_calls
        builds, gates, list_plain = list_counts()
        plain += list_plain
        list_builds = sim.grid_setups + rebins
        if max(gated) > tol or launches != evals or plain or \
                builds != list_builds:
            raise AssertionError(
                f"IN_LJ_MIN32K {dtype}: gaps {gaps} (tol {tol:g}), B1 "
                f"launches {launches} vs evaluations {evals}, plain {plain},"
                f" list builds {builds} vs {list_builds}")
        name = "f64" if dtype == torch.float64 else "f32"
        phase("min32k", f"IN_LJ_MIN32K {name} on {smi}: " + "; ".join(notes)
              + f"; within {tol:g} of {what}; B1 launches {launches} = "
                f"force evaluations {evals}, plain calls {plain}; list "
                f"builds {builds} = {sim.grid_setups} grid set-ups + "
                f"{rebins} re-bins, refresh launches {gates}, refreshes "
                f"taken {sim.list_refreshes}")
        out[name] = {"launches": launches, "build_launches": builds,
                     "gates": gates, "refreshes": sim.list_refreshes}
    out["f32"]["b1"] = b1_at_state("min32k", sim, 1, 0)
    out["f32"]["build"] = build_figures("min32k", sim)
    out["f32"]["upkeep"] = time_upkeep("min32k", sim, build=False,
                                       refresh=out["f32"]["refreshes"] > 0)
    del script, sim
    torch.cuda.empty_cache()
    return out["f32"]


def replicated_run(deck: str, dtype):
    """Run a replicated golden deck split at its ``unfix`` lines; returns
    (script, {step: {col: value}} of each step's first row, list builds,
    force evaluations: set-ups, steps, segment ends)."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.script.parser import LammpsScript
    script = LammpsScript(device="cuda", dtype=dtype)
    chunks, cur = [], []
    for ln in deck.splitlines():
        if ln.startswith("unfix") and cur:
            chunks.append(cur)
            cur = []
        cur.append(ln)
    chunks.append(cur)
    rebuilds = evals = 0
    t0 = time.perf_counter()
    for chunk in chunks:
        with contextlib.redirect_stdout(sys.stderr):
            script.run_string("\n".join(chunk))
        sim = script.sim
        rebuilds += int(sim._carry[1].nbuilds) - 1
        nsteps = sum(int(ln.split()[1]) for ln in chunk
                     if ln.startswith("run"))
        every = sim.thermo_every
        evals += 1 + nsteps + -(-nsteps // every)
    torch.cuda.synchronize()
    rows = bt.golden_columns(sim.log_lines, sim.thermo_style[1:])
    return script, rows, sim.grid_setups + rebuilds, evals, \
        time.perf_counter() - t0


def replicated_path(tag: str, smi: str, golden: str, deck: str,
                    cpu_gaps: dict, flags: tuple, timed_deck: str = ""):
    """A replicated golden deck in f64 (every golden row at 2e-6, the
    scaled columns as ``bench_targets.replicated_failures`` has them) and
    in f32 (each column's gap within its gate); B1 launches = force
    evaluations (set-ups, steps and one at each segment's end, whose
    energies thermo reads before the box moves) and list builds = grid
    set-ups + rebuilds in both, no plain call; the timesteps/s of the f32
    run, or of the f32 run of ``timed_deck`` (the deform deck run longer:
    the box at its end 1.1 and 0.95 of the start in x and y); a profile of
    20 steps; B1 over the final list against its stencil oracle in f64, and
    B1 in f32 at the final state with ``flags`` (b1_at_state); the list
    build at the final state against its plain build, timed."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.ops.lj_cellgrid import counts
    ref = np.loadtxt(GOLDEN.parent / golden / "thermo.csv")
    out = {}
    for dtype in (torch.float64, torch.float32):
        counts.reset()
        reset_list_counts()
        script, rows, list_builds, evals, secs = replicated_run(deck, dtype)
        sim = script.sim
        cols = sim.thermo_style[1:]
        launches, plain = counts.kernel_launches, counts.plain_calls
        builds, gates, list_plain = list_counts()
        plain += list_plain
        if launches != evals or plain or builds != list_builds \
                or sim.natoms != 32000:
            raise AssertionError(
                f"{tag} {dtype}: B1 launches {launches} vs force "
                f"evaluations {evals}, plain {plain}, list builds {builds} "
                f"vs {list_builds}, atoms {sim.natoms}")
        if dtype == torch.float64:
            bad = bt.replicated_failures(rows, ref, cols, 2e-6)
            gate = f"every golden row at 2e-6 ({len(np.atleast_2d(ref))} rows)"
        else:
            gaps = bt.replicated_gaps(rows, ref, cols, bt.REPS)
            bad = bt.f32_gap_failures(gaps, cpu_gaps)
            gate = ("gaps " + ", ".join(f"{c} {g:.3g}" for c, g in
                                        gaps.items()) + " within "
                    f"{bt.F32_GAP_FACTOR:g}x the CPU's or {bt.F32_GAP_FLOOR}")
        if bad:
            raise AssertionError(f"{tag} {dtype}: {bad[:6]}")
        name = "f64" if dtype == torch.float64 else "f32"
        phase(tag, f"{tag} {name}: {gate}; B1 launches {launches} = force "
                   f"evaluations {evals}, plain calls {plain}; list builds "
                   f"{builds} = grid set-ups + rebuilds, refresh launches "
                   f"{gates}, refreshes taken {sim.list_refreshes}; "
                   f"{secs:.2f} s")
        out = {"launches": launches, "build_launches": builds,
               "gates": gates, "refreshes": sim.list_refreshes}
    if timed_deck:
        counts.reset()
        reset_list_counts()
        script, rows, list_builds, evals, _ = replicated_run(timed_deck,
                                                             torch.float32)
        sim = script.sim
        ell0 = np.asarray([rows[0][c] for c in ("lx", "ly", "lz")])
        ratio = sim._carry[0].box.lengths_np() / ell0
        if abs(ratio[0] - 1.1) > 1e-6 or abs(ratio[1] - 0.95) > 1e-6 \
                or abs(ratio[2] - 1.0) > 1e-6 or sim.natoms != 32000:
            raise AssertionError(f"{tag} timed run: box ratios {ratio}, "
                                 f"atoms {sim.natoms}")
        launches = counts.kernel_launches
        builds, gates, _ = list_counts()
        if launches != evals or builds != list_builds:
            raise AssertionError(f"{tag} timed run: B1 launches {launches} "
                                 f"vs {evals}, builds {builds} vs "
                                 f"{list_builds}")
        out = {"launches": launches, "build_launches": builds,
               "gates": gates, "refreshes": sim.list_refreshes}
        note = (f"{sim.loop_steps} steps, the box at the end "
                f"{ratio.tolist()} of the start (1.1, 0.95, 1), "
                f"{sim.natoms} atoms")
    else:
        note = "the golden's 200 steps"
    sps = sim.loop_steps / sim.loop_time
    phase(tag, f"{tag} f32 {sps:.2f} timesteps/s ({note}), "
               f"{sps * 32000 / 1e6:.3f} Matom-step/s on {smi}; B1 launches "
               f"{out['launches']}, list builds {out['build_launches']}, "
               f"refresh launches {out['gates']}")
    phase(tag, f"{tag} " + profile_steps(script, 20, 1e3 / sps))
    err, _ = b1_list_check(f"{tag} final state", sim)
    phase(tag, f"B1 over the final list = the stencil oracle in f64 (max|df| "
               f"{err:.3g}, energies to {TOL_ORACLE[torch.float64]:g})")
    out["b1"] = b1_at_state(tag, sim, *flags)
    out["build"] = build_figures(tag, sim)
    if out["gates"]:
        out["upkeep"] = time_upkeep(tag, sim, build=False,
                                    refresh=out["refreshes"] > 0)
    out["sps"] = sps
    del script, sim
    torch.cuda.empty_cache()
    return out


def golden_deck(golden: str) -> str:
    return (GOLDEN.parent / golden / "in.test").read_text()


def pressber_path(smi: str) -> dict:
    """IN_PRESSBER32K: tests/golden/press_ber replicated 4x4x4
    (``bench_targets.pressber32k_deck``), temp/berendsen then
    press/berendsen iso and aniso, 200 steps (replicated_path); B1's
    virial variant, as under the barostat every step."""
    from tpumd_torch import bench_targets as bt
    return replicated_path("pressber32k", smi, "press_ber",
                           bt.pressber32k_deck(golden_deck("press_ber")),
                           bt.PRESSBER_F32_CPU_GAP, (0, 1))


def deform_path(smi: str) -> dict:
    """IN_DEFORM32K: tests/golden/deform replicated 4x4x4 (fix deform x
    scale 1.1 y scale 0.95 remap x), 20 steps against the golden's rows,
    then 500 steps timed in f32 (replicated_path); B1's forces-only
    variant, as between thermo rows."""
    from tpumd_torch import bench_targets as bt
    text = golden_deck("deform")
    return replicated_path("deform32k", smi, "deform",
                           bt.deform32k_deck(text), bt.DEFORM_F32_CPU_GAP,
                           (0, 0), bt.deform32k_deck(text, 500))


# --------------------------------------------------------------- many-body
MB_SMALL = ("tersoff/mod", "tersoff/zbl", "vashishta", "edip", "eam/fs",
            "eam/he", "adp", "eim", "hybrid/scaled sw")


def mb_small_deck(style: str, tmp: Path) -> str:
    """A small f64 deck of style, its inputs written into tmp, to step
    10: 3^3 Si diamond (tersoff/mod, edip), a 3^3 SiC crystal in vacuum
    (tersoff/zbl in a box of 4 cells, vashishta of 6), the Cu/Al cell of
    IN_EAMALLOY (eam/fs, eam/he, adp), a 3^3 rock-salt crystal (eim), or
    sw and lj/cut on two types under hybrid/scaled."""
    from tpumd_torch import bench_targets as bt
    nve = ("velocity all create {t} 376847 loop geom\nneighbor 1.0 bin\n"
           "neigh_modify every 1 delay 5 check yes\nfix 1 all nve\n"
           "timestep {dt}\nthermo 5\n")
    si = ("units metal\natom_style atomic\nlattice diamond 5.431\n"
          "region box block 0 3 0 3 0 3\ncreate_box {nt} box\n"
          "create_atoms 1 box\nmass * 28.06\n")
    if style in ("tersoff/mod", "edip"):
        f = {"tersoff/mod": "Si.tersoff.mod", "edip": "Si.edip"}[style]
        pot = bt.write_potential(tmp, f)
        return (si.format(nt=1) + f"pair_style {style}\npair_coeff * * "
                f"{pot} Si\n" + nve.format(t=1200.0, dt=0.001))
    if style in ("tersoff/zbl", "vashishta"):
        f = {"tersoff/zbl": "SiC.tersoff.zbl",
             "vashishta": "SiC.vashishta"}[style]
        pot = bt.write_potential(tmp, f)
        data = tmp / f"data.{style.replace('/', '_')}"
        bt.two_type_data(data, "zincblende", 3,
                         box_cells=4 if style == "tersoff/zbl" else 6)
        return (f"units metal\natom_style atomic\nread_data {data}\n"
                f"pair_style {style}\npair_coeff * * {pot} Si C\n"
                + nve.format(t=1800.0, dt=0.0005))
    if style in ("eam/fs", "eam/he", "adp"):
        pot = tmp / f"CuAl.{style.replace('/', '_')}"
        bt.alloy_setfl(pot, fs=style == "eam/fs", adp=style == "adp",
                       he_rhomin=0.9 if style == "eam/he" else None)
        return (bt.IN_EAMALLOY.format(n=1, potential=pot)
                .replace("eam/alloy", style).replace("thermo          100",
                                                     "thermo 5"))
    if style == "eim":
        data, ffield = tmp / "data.nacl", tmp / "ffield.eim"
        bt.two_type_data(data, "rocksalt", 3)
        ffield.write_text(bt.FFIELD_EIM)
        return (f"units metal\natom_style atomic\nread_data {data}\n"
                f"pair_style eim\npair_coeff * * Na Cl {ffield} Na Cl\n"
                + nve.format(t=1400.0, dt=0.001))
    pot = bt.write_potential(tmp, "Si.sw")
    return (si.format(nt=2) + "region half block 0 1.5 0 3 0 3\n"
            "set region half type 2\n"
            "pair_style hybrid/scaled 0.5 lj/cut 4.0 0.8 sw\n"
            "pair_coeff * * lj/cut 0.01 2.0\n"
            f"pair_coeff * * sw {pot} Si Si\n"
            "pair_coeff 1 2 lj/cut 0.02 2.1\n"
            + nve.format(t=1200.0, dt=0.001))


def mb_card_vs_cpu(deck: str, steps: int = 10) -> tuple[dict, dict, int]:
    """(card row, CPU row, P1 launches on the card) of deck run to steps
    in f64 on both; raises where the card took a plain gather or a grid
    kernel, or P1 not once a force evaluation."""
    from tpumd_torch.ops import gather
    from tpumd_torch.script.parser import LammpsScript
    rows = {}
    for dev in ("cuda", "cpu"):
        script = LammpsScript(device=dev, dtype=torch.float64)
        with contextlib.redirect_stdout(sys.stderr):
            script.run_string(deck)
        script.sim.verbose = False
        gather.counts.reset()
        torch.cuda.reset_peak_memory_stats()
        script.run_string(f"run {steps}")
        rows[dev] = dict(script.sim.last_thermo)
        if dev == "cuda":
            launches = gather.counts.kernel_launches
            if gather.counts.plain_calls or launches < steps + 1 \
                    or script.sim._ctx.is_cellgrid:
                raise AssertionError(
                    f"card run: P1 launches {launches} < {steps + 1} or "
                    f"plain calls {gather.counts.plain_calls} or grid "
                    f"{script.sim._ctx.is_cellgrid}")
    return rows["cuda"], rows["cpu"], launches


def mb_p1_forces_vs_plain(tmp: Path):
    """sw and tersoff on a perturbed 4^3 Si crystal in f64 on the card:
    the forces with the neighbour rows gathered by P1 against those with
    the plain gather.  P1 writes outside autograd, so the j side of every
    term reaches the forces through the scatter alone."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.models import pair_manybody
    from tpumd_torch.ops import gather
    from tpumd_torch.script.parser import LammpsScript
    for style in ("sw", "tersoff"):
        pot = bt.write_potential(tmp, bt.MB32K_POTENTIAL[style])
        script = LammpsScript(device="cuda", dtype=torch.float64)
        with contextlib.redirect_stdout(sys.stderr):
            script.run_string(bt.in_mb32k(style, pot, (4, 4, 4)) + (
                "displace_atoms all random 0.1 0.1 0.1 4711 units box\n"
                "run 0\n"))
        sim = script.sim
        s, neigh = sim._carry[0], sim._carry[1]
        args = (s.x, s.type, s.box, neigh.idx, neigh.sbits, None, None,
                True, True)
        gather.counts.reset()
        f, e, _, v = sim.pair.compute(*args)
        launched = gather.counts.kernel_launches
        pair_manybody.gather_rows = gather.gather_rows_plain
        try:
            fp, ep, _, vp = sim.pair.compute(*args)
        finally:
            pair_manybody.gather_rows = gather.gather_rows
        err = float((f - fp).abs().max())
        scale = float(fp.abs().max())
        if not (launched >= 1 and err <= 1e-12 * scale and scale > 0.1
                and abs(float(e - ep)) <= 1e-12 * abs(float(ep))
                and float((v - vp).abs().max())
                <= 1e-12 * float(vp.abs().max())):
            raise AssertionError(f"{style}: forces through P1 against the "
                                 f"plain gather: {err} of {scale}, "
                                 f"launches {launched}")
        phase("manybody", f"{style} forces through P1 = through the plain "
                          f"gather (f64, 512 atoms): max|diff| {err:.3e} "
                          f"of max|f| {scale:.4f}, energy and virial alike")


def manybody_phase():
    """The many-body styles' checks on the card in f64: forces through P1
    against the plain gather, the two MEAM goldens and the atm golden
    against the reference binary's rows, and a small deck of each other
    style on the card against the CPU at step 10."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.ops import gather
    from tpumd_torch.script.parser import LammpsScript
    gold = Path(__file__).resolve().parent / "tests" / "golden" / "meam"
    goldens = [(f"meam {n}", bt.meam_golden_deck((gold / n).read_text()), w)
               for n, w in bt.MEAM_GOLDEN_ROWS.items()]
    goldens.append(("atm 6^3", bt.IN_ATM_GOLDEN, bt.ATM_GOLDEN_ROW))
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        mb_p1_forces_vs_plain(tmp)
        for f in ("data.meam", "library.meam", "SiC.meam", "Ni.meam"):
            (tmp / f).write_bytes((gold / f).read_bytes())
        for name, deck, want in goldens:
            gather.counts.reset()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            script = LammpsScript(device="cuda", dtype=torch.float64)
            script.data_dir = str(tmp)
            with contextlib.redirect_stdout(sys.stderr):
                script.run_string(deck)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = script.sim.last_thermo
            bad = [k for k, w in want.items()
                   if abs(got[k] - w) > (1e-5 if k == "press" else 1e-6)
                   * abs(w)]
            if bad or gather.counts.plain_calls \
                    or gather.counts.kernel_launches == 0:
                raise AssertionError(f"{name} on the card: {bad} "
                                     f"{ {k: got[k] for k in want} }")
            cfg = script.sim._neigh_cfg
            phase("manybody", f"{name} golden in f64 on the card = the "
                              f"reference binary's row (1e-6, press 1e-5): "
                              f"{ {k: got[k] for k in want} }; K "
                              f"{cfg.kmax}, P1 launches "
                              f"{gather.counts.kernel_launches}, {secs:.2f} "
                              "s, peak "
                              f"{torch.cuda.max_memory_allocated() / 2**30:.2f}"
                              " GiB")
            del script
        for style in MB_SMALL:
            card, cpu, launches = mb_card_vs_cpu(mb_small_deck(style, tmp))
            gaps = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-300)
                    for k in ("temp", "epair", "etotal", "press")}
            if not all(g <= 1e-10 for g in gaps.values()):
                raise AssertionError(f"{style} card against CPU at step 10:"
                                     f" {gaps}")
            phase("manybody", f"{style} small deck in f64, card = CPU at "
                              f"step 10 to 1e-10 (largest gap "
                              f"{max(gaps.values()):.2e}): etotal "
                              f"{card['etotal']!r}; P1 launches {launches}"
                              ", no plain call")


def mb32k_path(name: str, deck: str, smi: str, step0_check, cpu_gap: dict,
               timed: int, total: int) -> tuple[dict, dict]:
    """A 32k deck on the matrix engine: in f64 step 0 behind step0_check
    (its message) and the step-100 row and forces; then the main path in
    f32 from the f64 deck's velocities and types: the step-100 row against
    f64 (3x the CPU's gap of the small deck), `timed` timed steps after 100
    of warm-up, `total` steps without a NaN, a lost atom or a neighbour
    overflow, the energy drift, P1's launches (no plain call, no grid
    kernel), peak memory and a profile of 20 steps; f32 forces on the f64
    run's step-100 positions against f64 there; P1 at the deck's packed
    neighbour-row shape."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.ops import cellgrid_pairlist, charmm_cellgrid, \
        eam_cellgrid, gather, gran_cellgrid, lj_cellgrid, lj_fene_cellgrid
    grid = (lj_cellgrid.counts, lj_fene_cellgrid.counts,
            eam_cellgrid.rho_counts, eam_cellgrid.force_counts,
            charmm_cellgrid.counts, gran_cellgrid.counts,
            cellgrid_pairlist.counts, cellgrid_pairlist.refresh_counts)
    # 1. f64: step 0, then the step-100 row, positions and forces
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref = card_script(deck, torch.float64)
    v64, t64 = ref.sim.state.v.clone(), ref.sim.state.type.clone()
    ref.run_string("run 0")
    n = ref.sim.natoms
    msg = step0_check(ref.sim)
    ref.run_string("run 100")
    torch.cuda.synchronize()
    s64_s = time.perf_counter() - t0
    row100_64 = dict(ref.sim.last_thermo)
    x100 = tag_order(ref.sim.state.x, ref.sim.state.tag).clone()
    f100 = tag_order(ref.sim.state.f, ref.sim.state.tag).clone()
    phase(name, f"f64 step 0 ({n} atoms, matrix engine): {msg}; to step "
                f"100 in {s64_s:.2f} s, peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del ref
    torch.cuda.empty_cache()
    # 2. the main path in f32; the counts are set to 0 just before it
    for c in (gather.counts,) + grid:
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    script = card_script(deck, torch.float32)
    sim = script.sim
    sim.state = sim.state.replace(v=v64.to(torch.float32), type=t64)
    seen = {}
    with recording_p1(seen):
        script.run_string("run 0")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    script.run_string("run 100")
    row100 = dict(sim.last_thermo)
    gaps = {k: abs(row100[k] - row100_64[k]) / abs(row100_64[k])
            for k in ("temp", "epair", "etotal", "press")}
    bad = bt.f32_gap_failures(gaps, cpu_gap)
    if bad:
        raise AssertionError(f"{name} step 100, f32 against f64: {bad}")
    lt0 = sim.loop_time
    script.run_string(f"run {timed}")
    torch.cuda.synchronize()
    sps = timed / (sim.loop_time - lt0)
    script.run_string(f"run {total - 100 - timed}")
    torch.cuda.synchronize()
    launches = gather.counts.kernel_launches
    plain = gather.counts.plain_calls + sum(c.plain_calls for c in grid)
    other = sum(c.kernel_launches for c in grid)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # a force evaluation at each of the four runs' set-ups and each step
    force_evals = 4 + total
    if launches < force_evals or plain or other or sim._ctx.is_cellgrid:
        raise AssertionError(f"{name}: row_gather launches {launches} < "
                             f"force evaluations {force_evals}, or plain "
                             f"calls {plain}, or grid kernel launches {other}")
    rows = thermo_rows(sim)
    e = np.array([rows[k]["etotal"] for k in sorted(rows)])
    s, neigh, _ = sim._carry
    finite = (np.isfinite(np.array([list(r.values())
                                    for r in rows.values()])).all()
              and bool(torch.isfinite(s.x).all())
              and bool(torch.isfinite(s.v).all()))
    ntags = int(torch.unique(s.tag[s.tag > 0]).numel())
    if sorted(rows)[-1] != total or not finite or ntags != n \
            or bool(neigh.overflow):
        raise AssertionError(f"{name}: rows {sorted(rows)}, finite "
                             f"{finite}, atoms {ntags}, overflow "
                             f"{bool(neigh.overflow)}")
    drift = float(np.abs(e - e[0]).max() / abs(e[0]))
    cfg = sim._neigh_cfg
    phase(name, f"f32 (matrix engine): set-up {setup_s:.3f} s (cells "
                f"{cfg.nx}x{cfg.ny}x{cfg.nz} cap {cfg.cell_cap}, K "
                f"{cfg.kmax}, max count {int(neigh.max_count)}); step 100 "
                f"= f64 within 3x the CPU's gaps: " + ", ".join(
                    f"{k} {g:.2e}" for k, g in gaps.items())
                + f"; {total} steps, {ntags} atoms, no NaN, no overflow; "
                f"energy drift {drift:.4e} (max over the rows)")
    phase(name, f"timed {timed} steps after 100: {sps:.2f} timesteps/s, "
                f"{sps * n / 1e6:.3f} Matom-step/s on {smi}; row_gather "
                f"launches {launches} over {force_evals} force evaluations "
                f"({launches / force_evals:.2f} a force evaluation, the "
                f"neighbour builds' included), plain calls {plain}, grid "
                f"kernel launches {other}; peak {peak:.2f} GiB")
    phase(name, profile_steps(script, 20, 1e3 / sps))
    del script, sim, s, neigh
    torch.cuda.empty_cache()
    # 3. f32 forces on the f64 run's step-100 positions
    probe = card_script(deck, torch.float32)
    st = probe.sim.state
    probe.sim.state = st.replace(x=x100[st.tag.long() - 1].to(torch.float32),
                                 type=t64)
    probe.run_string("run 0")
    f32 = tag_order(probe.sim.state.f, probe.sim.state.tag).double()
    ferr = float((f32 - f100).abs().max() / f100.abs().max())
    tol = max(bt.F32_GAP_FACTOR * cpu_gap["force"], bt.F32_GAP_FLOOR)
    if not ferr <= tol:
        raise AssertionError(f"{name} f32 forces at step 100: {ferr} > {tol}")
    phase(name, f"f32 forces on the f64 run's step-100 positions = f64 to "
                f"{ferr:.3e} of max|f| {float(f100.abs().max()):.4f} (gate "
                f"{tol:.3e})")
    del probe, st
    torch.cuda.empty_cache()
    p1_equal_plain(seen.values(), f"{name} input")
    table, idx = [v for (d, t, i), v in seen.items()
                  if d == torch.float32 and t == (n, 4) and len(i) == 2
                  and i[0] == n][-1]
    k = p1_at_shape(name, table, idx, len(seen))
    return k, {"launches": launches, "sps": sps}


def mb32k_step0_check(style: str):
    """The f64 step-0 gate of IN_SW32K or IN_TERSOFF32K: the perfect
    lattice's pe per atom and virial pressure equal the 3x3x3 lattice's in
    tpumd (bench_targets.MB32K_STEP0) to 1e-12."""
    from tpumd_torch import bench_targets as bt

    def check(sim):
        got = bt.mb32k_step0(sim.last_thermo, sim.natoms,
                             float(sim.state.box.volume))
        want = bt.MB32K_STEP0[style]
        bad = bt.mb32k_step0_failures(got, want, bt.MB32K_STEP0_RTOL)
        fmax = float(sim.state.f.abs().max())
        if bad or sim._ctx.is_cellgrid:
            raise AssertionError(f"{style} 32k f64 step 0: {got} vs {want}")
        return (f"pe/atom {got['pe_atom']!r}, virial pressure "
                f"{got['press_virial']!r} = the 3^3 lattice's in tpumd "
                f"{want['pe_atom']!r}, {want['press_virial']!r} (to "
                f"{bt.MB32K_STEP0_RTOL} of pe/atom and of the kinetic "
                f"pressure {got['press_kinetic']:.2f}); max|f| {fmax:.3e} "
                "(a perfect lattice)")
    return check


def sw32k_path(smi: str) -> tuple[dict, dict]:
    """IN_SW32K: LAMMPS's bench/POTENTIALS/in.sw at 32,000 atoms."""
    from tpumd_torch import bench_targets as bt
    with tempfile.TemporaryDirectory() as tmpdir:
        pot = bt.write_potential(tmpdir, "Si.sw")
        return mb32k_path("sw32k", bt.in_mb32k("sw", pot), smi,
                          mb32k_step0_check("sw"),
                          bt.MB32K_F32_CPU_GAP["sw"], 500, 1000)


def tersoff32k_path(smi: str) -> tuple[dict, dict]:
    """IN_TERSOFF32K: the same deck with Tersoff's Si(B)."""
    from tpumd_torch import bench_targets as bt
    with tempfile.TemporaryDirectory() as tmpdir:
        pot = bt.write_potential(tmpdir, "Si.tersoff")
        return mb32k_path("tersoff32k", bt.in_mb32k("tersoff", pot), smi,
                          mb32k_step0_check("tersoff"),
                          bt.MB32K_F32_CPU_GAP["tersoff"], 500, 1000)


def fcc_site_keys(x, a: float, cells: int):
    """Each atom's fcc site in one cell of `cells` lattice cells (edge a):
    an integer key from its position in half lattice constants."""
    h = torch.round(x.double() * (2.0 / a)).long() % (2 * cells)
    return (h[:, 0] * (2 * cells) + h[:, 1]) * (2 * cells) + h[:, 2]


def eamalloy32k_path(smi: str) -> tuple[dict, dict]:
    """IN_EAMALLOY32K: the two-element Cu/Al cell replicated 5^3 (32,000
    atoms) on the matrix engine: the cell in f64 against tpumd's step-0
    numbers, the 32k deck's energies 125x the cell's and its forces the
    cell's, replicated; then the main path in f32 (200 timed steps)."""
    from tpumd_torch import bench_targets as bt
    with tempfile.TemporaryDirectory() as tmpdir:
        pot = Path(tmpdir) / "CuAl.eam.alloy"
        bt.alloy_setfl(pot)
        cell = card_script(bt.IN_EAMALLOY.format(n=1, potential=pot),
                            torch.float64)
        cell.run_string("run 0")
        csim = cell.sim
        got = bt.mb32k_step0(csim.last_thermo, csim.natoms,
                             float(csim.state.box.volume))
        bad = bt.mb32k_step0_failures(got, bt.EAMALLOY_CELL_STEP0, 1e-12)
        if bad or csim._mode != "matrix":
            raise AssertionError(f"eam/alloy cell on the card: {got}")
        keys = fcc_site_keys(csim.state.x, bt.ALLOY_A0, 4)
        order = torch.argsort(keys)
        ckeys, cf = keys[order], csim.state.f[order].clone()
        ctype = csim.state.type[order].clone()
        cepair = csim.last_thermo["epair"]
        del cell, csim
        reps = bt.EAMALLOY32K_REPS

        def check(sim):
            s = sim.state
            at = torch.searchsorted(ckeys, fcc_site_keys(s.x, bt.ALLOY_A0,
                                                         4))
            ferr = float((s.f - cf[at]).abs().max() / cf.abs().max())
            ratio = sim.last_thermo["epair"] / cepair
            g = bt.mb32k_step0(sim.last_thermo, sim.natoms,
                               float(s.box.volume))
            if not (torch.equal(s.type, ctype[at]) and ferr <= 1e-10
                    and abs(ratio - reps ** 3) <= 1e-12 * reps ** 3
                    and not bt.mb32k_step0_failures(g, got, 1e-12)):
                raise AssertionError(f"IN_EAMALLOY32K f64 step 0: forces "
                                     f"{ferr}, epair ratio {ratio}, {g}")
            return (f"epair {ratio!r} x the cell's (= tpumd's pe/atom "
                    f"{got['pe_atom']!r} to 1e-12), virial pressure the "
                    f"cell's, forces the cell's replicated to {ferr:.2e} "
                    f"of max|f| {float(cf.abs().max()):.4f}")
        return mb32k_path("eamalloy32k",
                          bt.IN_EAMALLOY.format(n=reps, potential=pot),
                          smi, check, bt.EAMALLOY_F32_CPU_GAP, 200, 1000)


def kspace_goldens_phase():
    """The six DPD and kspace goldens (tpumd_torch.kspace_goldens) verbatim
    and the pppm/ad and pppm/cg water decks in f64 on the card: the
    goldens' solver parameters, last rows and pppm_stagger's dump against
    the reference binary at tpumd's tests' tolerances; every deck's printed
    rows against the same deck on the CPU (8 digits) and its last row to
    1e-9; P1 (or, for pppm_stagger's CHARMM water on the grid, B5)
    launched and no plain call."""
    from tpumd_torch import kspace_goldens as kg
    from tpumd_torch.ops import charmm_cellgrid, gather
    gold = str(GOLDEN.parent)
    counted = (gather.counts, charmm_cellgrid.counts)
    notes = []
    t0 = time.perf_counter()
    for name in list(kg.DECKS) + list(kg.VARIANTS):
        with tempfile.TemporaryDirectory() as cpu_dir, \
                tempfile.TemporaryDirectory() as where:
            cpu = kg.run(gold, name, cpu_dir, "cpu", torch.float64)
            for c in counted:
                c.reset()
            script = kg.run(gold, name, where, "cuda", torch.float64)
            launches = sum(c.kernel_launches for c in counted)
            plain = sum(c.plain_calls for c in counted)
            bad = (kg.failures(gold, name, script, where)
                   if name in kg.DECKS else [])
        got, want = thermo_rows(script.sim), thermo_rows(cpu.sim)
        if sorted(got) != sorted(want) or not got:
            bad.append(f"{name}: rows {sorted(got)} vs the CPU's "
                       f"{sorted(want)}")
        for step in set(got) & set(want):
            for key, w in want[step].items():
                if not abs(got[step][key] - w) <= 1e-7 * max(abs(w), 1e-3):
                    bad.append(f"{name} step {step} {key}: card "
                               f"{got[step][key]!r} vs CPU {w!r}")
        for key, w in cpu.sim.last_thermo.items():
            g = script.sim.last_thermo[key]
            if not abs(g - w) <= 1e-9 * max(abs(w), 1e-6):
                bad.append(f"{name} {key}: card {g!r} vs CPU {w!r}")
        if bad or launches == 0 or plain:
            raise AssertionError(f"kspace golden {name}: {bad[:6]}; "
                                 f"launches {launches}, plain calls {plain}")
        ks = script.sim.kspace
        notes.append(f"{name} ({ks.style if ks else 'no kspace'}, "
                     f"{'grid B5' if script.sim._ctx.is_cellgrid else 'P1'}"
                     f" x{launches})")
    phase("kspace", f"{len(notes)} DPD and kspace decks in f64 on the card "
                    f"({time.perf_counter() - t0:.1f} s with their CPU "
                    "runs): the six goldens' parameters, last rows and "
                    "dump to the reference binary at tpumd's tests' "
                    "tolerances, every deck's rows = the CPU's: "
                    + ", ".join(notes))


def card_script(deck: str, dtype):
    """LammpsScript of a deck's set-up lines on the card, verbose off,
    before its first run."""
    from tpumd_torch.script.parser import LammpsScript
    script = LammpsScript(device="cuda", dtype=dtype)
    with contextlib.redirect_stdout(sys.stderr):
        script.run_string(deck)
    script.sim.verbose = False
    return script


def kspace32k_path(name: str, deck: str, smi: str, step0: dict,
                   cpu_gap: dict, timed: int, total: int,
                   width: int) -> tuple[dict, dict]:
    """A 30k/32k DPD or TIP4P deck on the matrix engine: in f64 the step-0
    row against the port's CPU f64 row (step0, to 1e-9) and f32 on the
    step-100 state against f64 there (bench_targets.f32_gaps_at, 3x the
    CPU's gaps); then the main path in f32 from the f64 deck's velocities:
    `total` steps without a NaN, a lost atom or a neighbour overflow,
    `timed` of them timed after 100, P1's launches (no plain call, no grid
    kernel), peak memory and a profile of 20 steps; P1 at the deck's
    packed j rows (`width` columns) beside its bound and index_select."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.ops import cellgrid_pairlist, charmm_cellgrid, \
        eam_cellgrid, gather, gran_cellgrid, lj_cellgrid, lj_fene_cellgrid
    grid = (lj_cellgrid.counts, lj_fene_cellgrid.counts,
            eam_cellgrid.rho_counts, eam_cellgrid.force_counts,
            charmm_cellgrid.counts, gran_cellgrid.counts,
            cellgrid_pairlist.counts, cellgrid_pairlist.refresh_counts)
    # 1. f64: step 0 against the CPU's row; the step-100 state in f32
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref = card_script(deck, torch.float64)
    v64 = ref.sim.state.v.clone()
    ref.run_string("run 0")
    n = ref.sim.natoms
    row0 = dict(ref.sim.last_thermo)
    bad = [f"{k} {row0[k]!r} vs {w!r}" for k, w in step0.items()
           if not abs(row0[k] - w) <= 1e-9 * max(abs(w), 1.0)]
    if bad or ref.sim._ctx.is_cellgrid:
        raise AssertionError(f"{name} f64 step 0 against the CPU: {bad}")
    ref.run_string("run 100")
    torch.cuda.synchronize()
    s64_s = time.perf_counter() - t0
    gaps, probe = bt.f32_gaps_at(ref, deck, "cuda")
    del probe
    bad = bt.f32_gap_failures(gaps, cpu_gap)
    if bad:
        raise AssertionError(f"{name} f32 on the f64 step-100 state: {bad}")
    phase(name, f"f64 ({n} atoms, matrix engine): step 0 = the port's CPU "
                f"f64 row to 1e-9: {row0['epair']!r} epair, "
                f"{row0['press']!r} press; to step 100 in {s64_s:.2f} s; "
                "f32 on the f64 step-100 state within 3x the CPU's gaps: "
                + ", ".join(f"{k} {g:.2e} (CPU {cpu_gap[k]:.2e})"
                            for k, g in gaps.items()))
    del ref
    torch.cuda.empty_cache()
    # 2. the main path in f32; the counts are set to 0 just before it
    for c in (gather.counts,) + grid:
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    script = card_script(deck, torch.float32)
    sim = script.sim
    sim.state = sim.state.replace(v=v64.to(torch.float32))
    seen = {}
    with recording_p1(seen):
        script.run_string("run 0")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    script.run_string("run 100")
    lt0 = sim.loop_time
    script.run_string(f"run {timed}")
    torch.cuda.synchronize()
    sps = timed / (sim.loop_time - lt0)
    script.run_string(f"run {total - 100 - timed}")
    torch.cuda.synchronize()
    launches = gather.counts.kernel_launches
    plain = gather.counts.plain_calls + sum(c.plain_calls for c in grid)
    other = sum(c.kernel_launches for c in grid)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # a force evaluation at each of the four runs' set-ups and each step
    force_evals = 4 + total
    if launches < force_evals or plain or other or sim._ctx.is_cellgrid:
        raise AssertionError(f"{name}: row_gather launches {launches} < "
                             f"force evaluations {force_evals}, or plain "
                             f"calls {plain}, or grid kernel launches {other}")
    rows = thermo_rows(sim)
    s, neigh, _ = sim._carry
    finite = (np.isfinite(np.array([list(r.values())
                                    for r in rows.values()])).all()
              and bool(torch.isfinite(s.x).all())
              and bool(torch.isfinite(s.v).all()))
    ntags = int(torch.unique(s.tag[s.tag > 0]).numel())
    if sorted(rows)[-1] != total or not finite or ntags != n \
            or bool(neigh.overflow):
        raise AssertionError(f"{name}: rows {sorted(rows)}, finite "
                             f"{finite}, atoms {ntags}, overflow "
                             f"{bool(neigh.overflow)}")
    e = np.array([rows[k]["etotal"] for k in sorted(rows)])
    drift = float(np.abs(e - e[0]).max() / abs(e[0]))
    temps = [rows[k]["temp"] for k in sorted(rows) if k >= 100]
    mean_t = float(np.mean(temps))
    if name == "dpd32k" and not abs(mean_t - bt.DPD10_MEAN_TEMP) <= \
            bt.DPD_MEAN_TEMP_RTOL * bt.DPD10_MEAN_TEMP:
        raise AssertionError(f"dpd32k mean temperature {mean_t} vs the "
                             f"10^3 CPU f64 run's {bt.DPD10_MEAN_TEMP}")
    cfg = sim._neigh_cfg
    phase(name, f"f32 (matrix engine): set-up {setup_s:.3f} s (cells "
                f"{cfg.nx}x{cfg.ny}x{cfg.nz} cap {cfg.cell_cap}, K "
                f"{cfg.kmax}, max count {int(neigh.max_count)}); {total} "
                f"steps, {ntags} atoms, no NaN, no overflow; energy drift "
                f"{drift:.4e} (max over the rows); mean temperature of "
                f"steps 100-{total} {mean_t:.6f}"
                + (f" (the 10^3 CPU f64 run's {bt.DPD10_MEAN_TEMP:.6f}, "
                   f"gate {bt.DPD_MEAN_TEMP_RTOL:.0%})"
                   if name == "dpd32k" else ""))
    phase(name, f"timed {timed} steps after 100: {sps:.2f} timesteps/s, "
                f"{sps * n / 1e6:.3f} Matom-step/s on {smi}; row_gather "
                f"launches {launches} over {force_evals} force evaluations "
                f"({launches / force_evals:.2f} a force evaluation, the "
                f"neighbour builds' included), plain calls {plain}, grid "
                f"kernel launches {other}; peak {peak:.2f} GiB")
    phase(name, profile_steps(script, 20, 1e3 / sps))
    del script, sim, s, neigh
    torch.cuda.empty_cache()
    p1_equal_plain(seen.values(), f"{name} input")
    table, idx = [v for (d, t, i), v in seen.items()
                  if d == torch.float32 and t == (n, width) and len(i) == 2
                  and i[0] == n][-1]
    k = p1_at_shape(name, table, idx, len(seen))
    return k, {"launches": launches, "sps": sps}


def tip4p30k_path(smi: str) -> tuple[dict, dict]:
    """IN_TIP4P30K: tests/golden/tip4p's water replicated 4x4x5 (30,000
    atoms, TIP4P under pppm/tip4p); P1 at the Coulomb sum's (xq, type, q)
    rows."""
    from tpumd_torch import bench_targets as bt
    deck = bt.IN_TIP4P30K.format(golden=GOLDEN.parent / "tip4p",
                                 thermo=100)
    return kspace32k_path("tip4p30k", deck, smi, bt.TIP4P30K_STEP0_F64,
                          bt.TIP4P30K_F32_CPU_GAP, 200, 1000, 5)


def dpd32k_path(smi: str) -> tuple[dict, dict]:
    """IN_DPD32K: LAMMPS's bench/POTENTIALS/in.dpd (32,000 particles); P1
    at DPD's packed (x, v, tag, type) rows."""
    from tpumd_torch import bench_targets as bt
    deck = bt.IN_DPD32K.format(n=bt.DPD32K_CELLS, thermo=100)
    return kspace32k_path("dpd32k", deck, smi, bt.DPD32K_STEP0_F64,
                          bt.DPD32K_F32_CPU_GAP, 500, 1000, 8)



# ---------------------------------- output remainders, NEMD and reactive
# the three decks' size: 20^3 fcc cells (32,000 atoms), chain_data's 32,000
# beads
CELLS_32K = 20
BEADS_32K = 32000

class HostReads:
    """Counts every read of a tensor's value into Python or numpy (item,
    tolist, cpu, numpy, bool, int, float, index) within the block."""

    NAMES = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
             "__float__", "__index__")

    def __enter__(self):
        self.count = 0
        self.saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}
        for n, fn in self.saved.items():
            def wrap(*a, _fn=fn, **k):
                self.count += 1
                return _fn(*a, **k)
            setattr(torch.Tensor, n, wrap)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(torch.Tensor, n, fn)


def remainder_goldens_phase():
    """The ten goldens of this slice (tpumd_torch.remainder_goldens:
    create_mol, dump_local, ave_grid, bindump, the four nemd decks,
    bond_break, bond_create) verbatim in f64 on the card: each against the
    reference binary's log and files at tpumd's tests' tolerances, its
    printed rows against the same deck on the CPU (8 digits) and its last
    row to 1e-9; its force kernel launched (B1 on the grid, P1 on the
    matrix engine) and no plain call."""
    from tpumd_torch import remainder_goldens as rg
    from tpumd_torch.ops import gather, lj_cellgrid
    gold = str(GOLDEN.parent)
    counted = (gather.counts, lj_cellgrid.counts)
    notes = []
    t0 = time.perf_counter()
    for name in rg.DECKS:
        with tempfile.TemporaryDirectory() as cpu_dir, \
                tempfile.TemporaryDirectory() as where:
            cpu = rg.run(gold, name, cpu_dir, "cpu", torch.float64)
            for c in counted:
                c.reset()
            script = rg.run(gold, name, where, "cuda", torch.float64)
            launches = sum(c.kernel_launches for c in counted)
            plain = sum(c.plain_calls for c in counted)
            bad = rg.failures(gold, name, script, where)
        got, want = thermo_rows(script.sim), thermo_rows(cpu.sim)
        if sorted(got) != sorted(want) or not got:
            bad.append(f"{name}: rows {sorted(got)} vs the CPU's "
                       f"{sorted(want)}")
        for step in set(got) & set(want):
            for key, w in want[step].items():
                if not abs(got[step][key] - w) <= 1e-7 * max(abs(w), 1e-3):
                    bad.append(f"{name} step {step} {key}: card "
                               f"{got[step][key]!r} vs CPU {w!r}")
        for key, w in cpu.sim.last_thermo.items():
            g = script.sim.last_thermo[key]
            if not abs(g - w) <= 1e-9 * max(abs(w), 1e-6):
                bad.append(f"{name} {key}: card {g!r} vs CPU {w!r}")
        if bad or launches == 0 or plain:
            raise AssertionError(f"remainder golden {name}: {bad[:6]}; "
                                 f"launches {launches}, plain {plain}")
        notes.append(f"{name} ({'B1' if script.sim._ctx.is_cellgrid else 'P1'}"
                     f" x{launches})")
    phase("remainders", f"{len(notes)} goldens in f64 on the card "
                        f"({time.perf_counter() - t0:.1f} s with their CPU "
                        "runs) = the reference binary's logs and files at "
                        "tpumd's tests' tolerances and the CPU's rows: "
                        + ", ".join(notes))


def full_row_failures(what, got: dict, want: dict, rtol: float) -> list:
    return [f"{what} {k}: {got[k]!r} vs {w!r}" for k, w in want.items()
            if not abs(got[k] - w) <= rtol * max(abs(w), 1e-12)]


def timed_window(script, timed: int) -> tuple[float, int]:
    """(timesteps/s of a run of timed steps, host reads per 1,000 steps of
    a run of 100 more, counted)."""
    sim = script.sim
    torch.cuda.synchronize()
    lt0 = sim.loop_time
    script.run_string(f"run {timed}")
    torch.cuda.synchronize()
    sps = timed / (sim.loop_time - lt0)
    with HostReads() as reads:
        script.run_string("run 100")
        torch.cuda.synchronize()
    return sps, 10 * reads.count


def output_step_ms(fn) -> float:
    """Host ms of one call of an output writer, the card idle first."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def kappa32k_path(tmp: Path, smi: str) -> dict:
    """IN_KAPPA32K (tests/golden/nemd/in.tc on 20^3 cells, fix ave/grid and
    dump grid) on the grid: f64 steps 0 and 100 against the port's CPU f64
    rows to 1e-9 (f_2 included), the total momentum at 0 and etotal's
    drift over steps 0-100 within KAPPA32K_DRIFT_FACTOR x the CPU's; then
    the main path in f32 to step 1000: B1 launches = force evaluations,
    the list kernel's builds = grid set-ups + rebuilds, no plain call;
    500 timed steps, host reads per 1,000 steps, a profile, peak memory;
    ave/grid's hot slab (z cells 10) hotter than its cold slab (0); the
    NEMD swap on the card under torch's sync debug mode (no host sync);
    the host ms of dump grid and of a binary dump of the 32,000 atoms
    beside a text dump of the same columns; B1 at the final state."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.io.dump import make_dump
    from tpumd_torch.ops.lj_cellgrid import counts
    deck = bt.IN_KAPPA32K.format(n=CELLS_32K, grid=tmp / "kappa.grid",
                                 thermo=10)
    t0 = time.perf_counter()
    ref = card_script(deck, torch.float64)
    ref.run_string("run 0")
    row0 = dict(ref.sim.last_thermo)
    ref.run_string("run 100")
    row100 = dict(ref.sim.last_thermo)
    bad = (full_row_failures("step 0", row0, bt.KAPPA32K_ROWS_F64[0], 1e-9)
           + full_row_failures("step 100", row100,
                               bt.KAPPA32K_ROWS_F64[100], 1e-9))
    rows = thermo_rows(ref.sim)
    e = np.array([rows[k]["etotal"] for k in sorted(rows)])
    drift = float(np.abs(e - e[0]).max() / abs(e[0]))
    s = ref.sim._carry[0]
    m = ref.sim._ctx.mass_per_atom(s).double()
    p = (m[:, None] * s.v.double())[s.tag > 0].sum(0)
    pmax = float(p.abs().max())
    dlim = bt.KAPPA32K_DRIFT_FACTOR * bt.KAPPA32K_ETOTAL_DRIFT_F64 + 1e-8
    if bad or drift > dlim or pmax > 1e-9 * ref.sim.natoms \
            or not ref.sim._ctx.is_cellgrid:
        raise AssertionError(f"IN_KAPPA32K f64: {bad}, drift {drift} > "
                             f"{dlim}, momentum {pmax}")
    phase("kappa32k", f"f64 ({ref.sim.natoms} atoms, grid): steps 0 and "
                      f"100 = the port's CPU f64 rows to 1e-9 (f_2 "
                      f"{row100['f_2']!r}); momentum max|P| {pmax:.2e}; "
                      f"etotal drift {drift:.3e} (CPU "
                      f"{bt.KAPPA32K_ETOTAL_DRIFT_F64:.3e});"
                      f" {time.perf_counter() - t0:.2f} s")
    del ref
    torch.cuda.empty_cache()
    # the main path in f32; the counts are set to 0 just before it
    counts.reset()
    reset_list_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    script = card_script(deck.replace("thermo          10",
                                      "thermo          100"), torch.float32)
    sim = script.sim
    script.run_string("run 0")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    script.run_string("run 100")
    sps, reads = timed_window(script, 500)
    script.run_string("run 300")
    torch.cuda.synchronize()
    nruns, nsteps = 5, 1000
    evals = force_evals_of(sim, 1, nsteps, nruns)
    launches, plain = counts.kernel_launches, counts.plain_calls
    builds, gates, list_plain = list_counts()
    list_builds = sim.grid_setups + int(sim._carry[1].nbuilds) - 1
    peak = torch.cuda.max_memory_allocated() / 2**30
    fx = next(f for f in sim.fixes if f.name == "ave/grid")
    temp = fx.grid_data(sim, "data", 3)
    cnt = fx.grid_data(sim, "count")
    hot = float((temp[10] * cnt[10]).sum() / cnt[10].sum())
    cold = float((temp[0] * cnt[0]).sum() / cnt[0].sum())
    if launches != evals or plain or list_plain or builds != list_builds \
            or not hot > cold or sim.step != 1000:
        raise AssertionError(f"IN_KAPPA32K f32: B1 launches {launches} vs "
                             f"{evals}, plain {plain + list_plain}, builds "
                             f"{builds} vs {list_builds}, hot {hot} cold "
                             f"{cold}, step {sim.step}")
    phase("kappa32k", f"f32: set-up {setup_s:.3f} s; {sps:.2f} timesteps/s "
                      f"({sps * 32000 / 1e6:.3f} Matom-step/s) over 500 "
                      f"steps on {smi}; host reads {reads} per 1,000 steps; "
                      f"B1 launches {launches} = force evaluations {evals}; "
                      f"list builds {builds} = grid set-ups + rebuilds, "
                      f"refresh launches {gates}; plain calls 0; peak "
                      f"{peak:.2f} GiB; at step 1000 ave/grid's hot slab "
                      f"{hot:.4f} > cold slab {cold:.4f}, f_2 "
                      f"{sim.last_thermo['f_2']:.6g}")
    phase("kappa32k", profile_steps(script, 20, 1e3 / sps))
    # the swap alone under the sync debug mode: any host sync raises
    tc = next(f for f in sim._ctx.fixes if f.name == "thermal/conductivity")
    k = sim._ctx.fixes.index(tc)
    s, fs = sim._carry[0], tc.set_step(sim._carry[2][k], 10)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tc.end_of_step(s, fs, sim._ctx)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    swap_ms = cuda_ms(lambda: tc.end_of_step(s, fs, sim._ctx), 50,
                      ahead=False)
    grid = make_dump("gg", "all", "grid", 1, str(tmp / "one.grid"),
                     ["f_3:grid:data[3]", "f_3:grid:count"])
    cols = ["id", "type", "x", "y", "z", "vx", "vy", "vz"]
    binary = make_dump("b", "all", "custom", 1, str(tmp / "atoms.bin"), cols)
    text = make_dump("t", "all", "custom", 1, str(tmp / "atoms.txt"), cols)
    for d in (binary, text):
        d.sort = True
    g_ms = output_step_ms(lambda: grid.write(sim))
    b_ms = output_step_ms(lambda: binary.write(sim))
    t_ms = output_step_ms(lambda: text.write(sim))
    phase("kappa32k", f"thermal/conductivity's swap with no host sync "
                      f"(torch.cuda sync debug mode 'error'), "
                      f"{swap_ms:.4f} ms of the card a swap (CUDA events, "
                      f"host-bound); host ms of an output step: dump grid "
                      f"({4 * 4 * 20} cells) {g_ms:.2f}, binary dump of "
                      f"32,000 atoms x {len(cols)} columns {b_ms:.2f} "
                      f"({(tmp / 'atoms.bin').stat().st_size} bytes) beside "
                      f"the text dump {t_ms:.2f} "
                      f"({(tmp / 'atoms.txt').stat().st_size} bytes)")
    err, _ = b1_list_check("kappa32k final state", sim)
    out = {"launches": launches, "build_launches": builds, "gates": gates,
           "refreshes": sim.list_refreshes, "sps": sps}
    out["b1"] = b1_at_state("kappa32k", sim, 0, 0)
    out["build"] = build_figures("kappa32k", sim)
    if gates:
        out["upkeep"] = time_upkeep("kappa32k", sim, build=False,
                                    refresh=out["refreshes"] > 0)
    del script, sim, s
    torch.cuda.empty_cache()
    return out


def bond_event_checks(sim, before: set, cut: float) -> tuple[set, int]:
    """After an event: the new bonds are shorter than cut at their
    formation, no atom holds more than one, and dump local's property/
    local rows are the live bonds; (the bonds now, how many were new)."""
    bonds = sim.live_topology("bond")
    now = {tuple(sorted((int(b[1]), int(b[2])))) for b in bonds}
    new = now - before
    s = sim._carry[0]
    x = torch.zeros((sim.natoms + 1, 3), dtype=torch.float64,
                    device=s.x.device)
    x[s.tag.long()] = s.x.double()
    ell = (s.box.hi - s.box.lo).double()
    if new:
        ab = torch.tensor(sorted(new), device=s.x.device)
        d = x[ab[:, 0]] - x[ab[:, 1]]
        d = d - ell * torch.round(d / ell)
        longest = float(torch.sqrt((d * d).sum(1)).max())
    else:
        longest = 0.0
    deg = np.bincount(np.asarray(bonds)[:, 1:].ravel()) if len(bonds) \
        else np.zeros(1, int)
    rows = sim.computes["pl"](sim).cpu().numpy()
    listed = {tuple(sorted((int(a), int(b)))) for a, b in rows[:, :2]}
    if not before <= now or deg.max() > 1 or longest >= cut \
            or listed != now:
        raise AssertionError(f"bond/create at step {sim.step}: count "
                             f"{len(before)} -> {len(now)}, most bonds of "
                             f"an atom {deg.max()}, longest new {longest}, "
                             f"dump local rows {len(listed)}")
    return now, len(new)


def bondcreate32k_path(tmp: Path, smi: str) -> tuple[dict, dict]:
    """IN_BONDCREATE32K (step-growth dimerisation of 32,000 monomers at
    melt density) on the matrix engine: f64 step 0 against the port's CPU
    f64 row to 1e-9 and the bonds made at step 5 equal to the CPU run's as
    a set of tag pairs (count and digest); every event to step 50: caps,
    lengths below Rmin, a bond count that never falls, dump local's rows
    the live bonds; then the main path in f32 (P1 launched, no plain call,
    no grid kernel): 500 timed steps, host reads per 1,000 steps, a
    profile, peak memory, the bonds at every event checked to step 700; a
    bond/create event's time on the card; dump local's host ms; P1 at the
    deck's packed rows."""
    import hashlib
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.ops import gather
    deck = bt.IN_BONDCREATE32K.format(n=CELLS_32K, local=tmp / "bonds.local",
                                      thermo=100)
    t0 = time.perf_counter()
    ref = card_script(deck, torch.float64)
    ref.run_string("run 0")
    bad = full_row_failures("step 0", ref.sim.last_thermo,
                            bt.BONDCREATE32K_STEP0_F64, 1e-9)
    bonds, made = set(), []
    for _ in range(10):
        ref.run_string("run 5")
        bonds, n_new = bond_event_checks(ref.sim, bonds, 1.15)
        made.append(n_new)
        if ref.sim.step == 5:
            text = "\n".join(f"{a} {b}" for a, b in sorted(bonds))
            got5 = (len(bonds), hashlib.sha256(text.encode()).hexdigest())
    if bad or got5 != bt.BONDCREATE32K_STEP5_BONDS or ref.sim._ctx.is_cellgrid:
        raise AssertionError(f"IN_BONDCREATE32K f64: {bad}; step-5 bonds "
                             f"{got5} vs the CPU's "
                             f"{bt.BONDCREATE32K_STEP5_BONDS}")
    phase("bondcreate32k", f"f64 ({ref.sim.natoms} monomers, matrix "
                           f"engine): step 0 = the port's CPU f64 row to "
                           f"1e-9; the {got5[0]} bonds of step 5 = the CPU "
                           f"run's tag pairs; events to step 50 made "
                           f"{made} bonds (caps 1, each shorter than Rmin "
                           f"1.15 when made, the count never falls, dump "
                           f"local's rows = the bonds); "
                           f"{time.perf_counter() - t0:.2f} s")
    del ref
    torch.cuda.empty_cache()
    gather.counts.reset()
    reset_list_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    script = card_script(deck, torch.float32)
    sim = script.sim
    seen = {}
    with recording_p1(seen):
        script.run_string("run 0")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    script.run_string("run 100")
    sps, reads = timed_window(script, 500)
    bonds = {tuple(sorted((int(b[1]), int(b[2]))))
             for b in sim.live_topology("bond")}
    launches = gather.counts.kernel_launches
    plain = gather.counts.plain_calls + list_counts()[2]
    other = list_counts()[0]
    peak = torch.cuda.max_memory_allocated() / 2**30
    evals = force_evals_of(sim, 1, 700, 4)
    fx = next(f for f in sim.fixes if f.name == "bond/create")
    counts_ok = all(n >= 0 for _, n in fx.events)
    if launches < evals or plain or other or not counts_ok \
            or sim._ctx.is_cellgrid:
        raise AssertionError(f"IN_BONDCREATE32K f32: P1 launches {launches} "
                             f"< force evaluations {evals}, plain {plain}, "
                             f"grid list builds {other}, events "
                             f"{fx.events[-5:]}")
    for _ in range(4):
        script.run_string("run 5")
        bonds, _ = bond_event_checks(sim, bonds, 1.15)
    ntotal = len(bonds)
    phase("bondcreate32k", f"f32: set-up {setup_s:.3f} s; {sps:.2f} "
                           f"timesteps/s ({sps * 32000 / 1e6:.3f} "
                           f"Matom-step/s) over 500 steps on {smi}; host "
                           f"reads {reads} per 1,000 steps; P1 launches "
                           f"{launches} over {evals} force evaluations "
                           f"({launches / evals:.2f} each, the neighbour "
                           f"builds' included), plain calls 0, grid kernel "
                           f"launches 0; peak {peak:.2f} GiB; {ntotal} bonds "
                           f"at step {sim.step} from {len(fx.events)} events "
                           f"(none shrank the count; the last 4 events "
                           f"checked: caps, Rmin, dump local)")
    phase("bondcreate32k", profile_steps(script, 20, 1e3 / sps))
    # one event's time on the card: the event step's post_integrate on
    # the current state, its table and count put back after each call
    s, neigh = sim._carry[0], sim._carry[1]
    step = (sim.step // 5 + 1) * 5
    saved = (fx._table.clone(), fx._count.clone(), fx._over.clone())
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fx.post_integrate(s, step, sim._ctx, neigh)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
        fx._table.copy_(saved[0])
        fx._count.copy_(saved[1])
        fx._over.copy_(saved[2])
        fx._undo = None
    local = next(d for d in sim.dumps if d.id == "d")
    nrows = len(sim.live_topology("bond"))
    l_ms = output_step_ms(lambda: local.write(sim))
    phase("bondcreate32k", f"a bond/create event: {np.median(times):.3f} ms "
                           f"of the card (CUDA events around the event "
                           f"step's post_integrate, median of 5, host-bound "
                           f"launches included); dump local of {nrows} "
                           f"bond rows: {l_ms:.2f} host ms")
    del script, sim, s, neigh
    torch.cuda.empty_cache()
    p1_equal_plain(seen.values(), "bondcreate32k input")
    table, idx = [v for (d, t, i), v in seen.items()
                  if d == torch.float32 and len(t) == 2 and len(i) == 2
                  and i[0] == t[0] == 4 * CELLS_32K ** 3][-1]
    kk = p1_at_shape("bondcreate32k", table, idx, len(seen))
    return kk, {"launches": launches, "sps": sps}


def respa32k_path(tmp: Path, smi: str) -> tuple[dict, dict]:
    """IN_CHAIN_RESPA32K (chain_data's 32,000 beads under run_style respa
    2 2 bond 1 pair 2) on the matrix engine: f64 step 0 against the port's
    CPU f64 row to 1e-9; respa 2 1 against verlet over 100 steps in f64 on
    the card, every printed row to 1e-7; then the main path in f32 (P1,
    no plain call, no grid kernel): 500 timed steps after 100 with
    etotal's drift over them within RESPA32K_F32_DRIFT (written before the
    first run), host reads per 1,000 steps, a profile, peak memory; P1 at
    the deck's packed rows."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.ops import gather
    data = tmp / "data.chain.respa"
    bt.chain_data(str(data), natoms=BEADS_32K)
    deck = bt.IN_CHAIN_RESPA32K.format(data=data, inner=2, thermo=10)
    t0 = time.perf_counter()
    ref = card_script(deck, torch.float64)
    ref.run_string("run 0")
    bad = full_row_failures("step 0", ref.sim.last_thermo,
                            bt.CHAIN_RESPA32K_STEP0_F64, 1e-9)
    if bad or ref.sim._ctx.is_cellgrid:
        raise AssertionError(f"IN_CHAIN_RESPA32K f64 step 0: {bad}")
    del ref
    one = card_script(deck.replace("respa 2 2", "respa 2 1"), torch.float64)
    one.run_string("run 100")
    verlet = card_script(deck.replace("run_style       respa 2 2 bond 1 "
                                      "pair 2", ""), torch.float64)
    verlet.run_string("run 100")
    a, b = thermo_rows(one.sim), thermo_rows(verlet.sim)
    gap = max(abs(a[k][c] - b[k][c]) / max(abs(b[k][c]), 1e-3)
              for k in b for c in b[k])
    if sorted(a) != sorted(b) or gap > 1e-7:
        raise AssertionError(f"respa 2 1 vs verlet: steps {sorted(a)} vs "
                             f"{sorted(b)}, largest gap {gap}")
    phase("respa32k", f"f64 ({one.sim.natoms} beads): step 0 = the port's "
                      f"CPU f64 row to 1e-9; respa 2 1 (matrix engine) = "
                      "verlet ("
                      + ("grid B2" if verlet.sim._ctx.is_cellgrid else "P1")
                      + ")"
                      f" over 100 steps, every printed row to 1e-7 (largest"
                      f" {gap:.2e}); {time.perf_counter() - t0:.2f} s")
    del one, verlet
    torch.cuda.empty_cache()
    gather.counts.reset()
    reset_list_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    script = card_script(deck.replace("thermo          10",
                                      "thermo          50"), torch.float32)
    sim = script.sim
    seen = {}
    with recording_p1(seen):
        script.run_string("run 0")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    script.run_string("run 100")
    sps, reads = timed_window(script, 500)
    rows = thermo_rows(sim)
    e = np.array([rows[k]["etotal"] for k in sorted(rows) if 100 <= k <= 600])
    drift = float(np.abs(e - e[0]).max() / abs(e[0]))
    launches = gather.counts.kernel_launches
    plain = gather.counts.plain_calls + list_counts()[2]
    other = list_counts()[0]
    peak = torch.cuda.max_memory_allocated() / 2**30
    evals = force_evals_of(sim, 1, 700, 4)
    if launches < evals or plain or other or drift > bt.RESPA32K_F32_DRIFT \
            or sim._ctx.is_cellgrid or not np.isfinite(e).all():
        raise AssertionError(f"IN_CHAIN_RESPA32K f32: P1 launches "
                             f"{launches} < {evals}, plain {plain}, grid "
                             f"{other}, drift {drift} > "
                             f"{bt.RESPA32K_F32_DRIFT}")
    phase("respa32k", f"f32 respa 2 2: set-up {setup_s:.3f} s; {sps:.2f} "
                      f"timesteps/s ({sps * 32000 / 1e6:.3f} Matom-step/s) "
                      f"over 500 steps on {smi}; etotal drift over them "
                      f"{drift:.3e} (bound {bt.RESPA32K_F32_DRIFT:g}); host "
                      f"reads {reads} per 1,000 steps; P1 launches "
                      f"{launches} over {evals} outer steps' and rows' "
                      f"evaluations, plain calls 0, grid launches 0; peak "
                      f"{peak:.2f} GiB")
    phase("respa32k", profile_steps(script, 20, 1e3 / sps))
    del script, sim
    torch.cuda.empty_cache()
    p1_equal_plain(seen.values(), "respa32k input")
    table, idx = [v for (d, t, i), v in seen.items()
                  if d == torch.float32 and len(t) == 2 and len(i) == 2
                  and i[0] == t[0] == BEADS_32K][-1]
    kk = p1_at_shape("respa32k", table, idx, len(seen))
    return kk, {"launches": launches, "sps": sps}


# --------------------------------------------------------------------------
# the replica layer and the library interface (temper, neb, prd, tad,
# hyper, fix external, the API, PyLammps and the C shim)


class ForceEvals:
    """Counts the port's force evaluations (calls of verlet.compute_forces,
    from the run loop, the minimizer or the NEB band) within the block:
    on the grid each launches B1 once."""

    MODULES = ("tpumd_torch.md.verlet", "tpumd_torch.md.minimize",
               "tpumd_torch.md.neb")

    def __enter__(self):
        import importlib
        self.count = 0
        self.saved = []
        # every module imported before any is patched: a module imported
        # after verlet's patch would bind the wrapper and count twice
        mods = [importlib.import_module(name) for name in self.MODULES]
        for mod in mods:
            fn = mod.compute_forces

            def wrap(*a, _fn=fn, **k):
                self.count += 1
                return _fn(*a, **k)
            self.saved.append((mod, fn))
            mod.compute_forces = wrap
        return self

    def __exit__(self, *exc):
        for mod, fn in reversed(self.saved):
            mod.compute_forces = fn


def b1_calls() -> tuple[int, int]:
    """(B1 launches, plain calls) since the reset."""
    from tpumd_torch.ops.lj_cellgrid import counts
    return counts.kernel_launches, counts.plain_calls


def reset_b1():
    from tpumd_torch.ops.lj_cellgrid import counts
    counts.reset()
    reset_list_counts()


def sync(dev: str):
    if dev == "cuda":
        torch.cuda.synchronize()


def device_share(fn, wall_ms: float) -> str:
    """fn's device milliseconds under torch.profiler (fn is a repeat of
    work whose unprofiled wall time was wall_ms) and their share of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_ms = sum(ev.self_device_time_total for ev in prof.key_averages()
                 if ev.device_type == DeviceType.CUDA) / 1e3
    return (f"device busy {dev_ms:.2f} ms = {dev_ms / wall_ms:.1%} of the "
            f"unprofiled {wall_ms:.2f} ms")


def tag_positions(state) -> torch.Tensor:
    """(N, 3) f64 positions in tag order."""
    from tpumd_torch.core.state import tag_rows
    n = int((state.tag > 0).sum())
    return state.x[tag_rows(state.tag, n)].double()


def min_image_gap(a, b, box) -> float:
    """max |a - b| over the nearest images (positions of one box)."""
    d = (a - b).double()
    ell = box.lengths.double()
    return float((d - ell * torch.round(d / ell)).abs().max())


def temper32k_path(smi: str) -> dict:
    """IN_TEMPER32K in f32: four replicas of in.lj's 32,000 atoms under fix
    nvt at 1.000-1.012, ``temper 1000 100``.  Gates: every replica at step
    1000 with finite rows; the attempts of each window = the pairs of its
    parity (RanPark 3847's draws); B1 launches = the replicas' force
    evaluations (every compute_forces call, counted), no plain call.
    Prints the acceptance, timesteps/s per replica-step, the swaps' host
    ms, host reads per replica-window, device busy share and peak
    memory."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.md.temper import temper
    from tpumd_torch.script.parser import LammpsScript
    from tpumd_torch.utils.ranpark import RanPark
    steps, every = 1000, 100
    reset_b1()
    torch.cuda.reset_peak_memory_stats()
    script = LammpsScript(device="cuda", dtype=torch.float32)
    t0 = time.perf_counter()
    with ForceEvals() as ev, HostReads() as reads, \
            contextlib.redirect_stdout(sys.stderr):
        script.run_string(bt.IN_TEMPER32K.format(n=20, steps=steps,
                                                 every=every))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sims, acc = script.replicas, script.temper_accepts
    rp = RanPark(3847)
    want = [len(range(int(rp.uniform() < 0.5), len(sims) - 1, 2))
            for _ in range(steps // every)]
    launches, plain = b1_calls()
    builds, gates, list_plain = list_counts()
    bad = [k for k, sim in enumerate(sims) if sim.step != steps
           or not np.isfinite(sim.last_thermo["etotal"])]
    if bad or [a[1] for a in acc] != want or launches != ev.count \
            or plain or list_plain \
            or not all(sim._ctx.is_cellgrid for sim in sims):
        raise AssertionError(
            f"IN_TEMPER32K: replicas off {bad}, attempts "
            f"{[a[1] for a in acc]} vs {want}, B1 launches {launches} vs "
            f"force evaluations {ev.count}, plain {plain}/{list_plain}")
    loop = sum(sim.loop_time for sim in sims)
    rsteps = steps * len(sims)
    nacc, natt = sum(a for a, _ in acc), sum(want)
    peak = torch.cuda.max_memory_allocated() / 2**30
    temps = [float(t) for t in bt.TEMPER32K_WORLDS]
    # a window of 10 steps a replica: the profiler's host cost grows with
    # the events it records
    window_ms = 1e3 * loop / steps * 10
    share = device_share(lambda: temper(
        sims, temps, 10, 10, 11, 12, sims[0].units.boltz,
        log=lambda *a: None), window_ms)
    phase("temper32k", f"{len(sims)} replicas x {sims[0].natoms} atoms "
                       f"f32 on {smi}: {nacc}/{natt} swaps accepted "
                       f"({nacc / natt:.1%}) over {len(acc)} windows "
                       f"{acc}; {rsteps / loop:.2f} timesteps/s per "
                       f"replica-step ({rsteps} replica-steps, the run "
                       f"{wall:.2f} s with set-ups); swaps' host "
                       f"{1e3 * script.temper_stats['swap_s']:.3f} ms in "
                       f"all; host reads "
                       f"{reads.count / len(acc) / len(sims):.1f} per "
                       f"replica-window; a window of 10 steps: {share}; B1 "
                       f"launches {launches} = force evaluations "
                       f"{ev.count}, plain calls 0; list builds {builds}, "
                       f"refresh launches {gates}; peak {peak:.2f} GiB")
    return {"launches": launches, "build_launches": builds, "sim": sims[0],
            "sps": rsteps / loop}


def neb_run(tmp: Path, dev: str, dtype, n: int, n1: int, n2: int):
    """The vacancy hop's NEB; returns (script, result, force evaluations,
    B1 launches, plain calls)."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.script.parser import LammpsScript
    head = LammpsScript(device="cpu", dtype=torch.float64)
    with contextlib.redirect_stdout(sys.stderr):
        head.run_string(bt.IN_NEB32K_HEAD.format(n=n))
    head._finalize_atoms()
    final = tmp / f"final{n}.neb"
    bt.neb_final_file(str(final), head.sim.state)
    reset_b1()
    script = LammpsScript(device=dev, dtype=dtype)
    with ForceEvals() as ev, contextlib.redirect_stdout(sys.stderr):
        script.run_string(bt.IN_NEB32K.format(n=n, n1=n1, n2=n2,
                                              final=final))
    sync(dev)
    return (script, script.neb_result, ev.count) + b1_calls()


def neb32k_path(tmp: Path, smi: str) -> dict:
    """IN_NEB32K in f64: tests/test_neb.py's vacancy hop in 20^3 fcc cells
    at 0.85 (31,999 atoms, 8 images).  Gates: max |F_neb| < ftol 1e-6 at
    the end; EBF = EBR to 1e-6 relative (the hop's mirror symmetry); the
    climber at rd 0.5 +- 0.05; the end images' energies equal to 1e-6
    relative; B1 launches = the images' force evaluations, no plain call.
    Prints iterations, evaluations, host reads a chunk, ms an iteration
    and the barrier; then the same hop in f32 for fewer iterations, its
    barrier beside the f64 one, not gated (an image's energy is about
    -2e5 eps, the barrier about 1 eps: f32 cannot resolve it).  Returns
    the f64 run's launches and its state."""
    script, r, evals, launches, plain = neb_run(tmp, "cuda", torch.float64,
                                                20, 1000, 4000)
    builds, _, list_plain = list_counts()
    e, rd, c = r["energies"], r["rd"], r["climber"]
    if not r["fmax_atom"] < 1e-6 or abs(r["ebf"] - r["ebr"]) > 1e-6 * abs(
            r["ebf"]) or abs(rd[c] - 0.5) > 0.05 or abs(e[0] - e[-1]) > \
            1e-6 * abs(e[0]) or launches != evals or plain or list_plain \
            or not script.sim._ctx.is_cellgrid:
        raise AssertionError(
            f"IN_NEB32K f64: fmax_atom {r['fmax_atom']}, EBF {r['ebf']!r} "
            f"EBR {r['ebr']!r}, climber {c} at rd {rd[c]}, ends {e[0]!r} "
            f"{e[-1]!r}, B1 launches {launches} vs evaluations {evals}, "
            f"plain {plain}/{list_plain}")
    phase("neb32k", f"{script.sim.natoms} atoms x 8 images f64 on {smi}: "
                    f"{r['iterations']} FIRE iterations "
                    f"({r['stage1']['step']} + {r['step']}), "
                    f"{r['evaluations']} force evaluations, {r['rebuilds']} "
                    f"list rebuilds, {r['reads'] / r['chunks']:.1f} host "
                    f"reads a chunk of 100 (one an iteration: the images' "
                    f"skin checks, one the chunk's diagnostics), "
                    f"{1e3 * r['wall_s'] / r['iterations']:.3f} ms an "
                    f"iteration; barrier EBF {r['ebf']!r} EBR {r['ebr']!r}, "
                    f"climber {c} at rd {rd[c]:.4f}, max|F| "
                    f"{r['fmax_atom']:.3g}; B1 launches {launches} = force "
                    f"evaluations {evals}, list builds {builds}")
    sim = script.sim
    del script
    s32, r32, evals32, launches32, plain32 = neb_run(tmp, "cuda",
                                                     torch.float32, 20, 200,
                                                     300)
    del s32
    if launches32 != evals32 or plain32:
        raise AssertionError(f"IN_NEB32K f32: B1 launches {launches32} vs "
                             f"evaluations {evals32}, plain {plain32}")
    phase("neb32k", f"f32, {r32['iterations']} iterations (not gated): "
                    f"EBF {r32['ebf']!r} EBR {r32['ebr']!r} (f64 "
                    f"{r['ebf']!r}), max|F| {r32['fmax_atom']:.3g}, "
                    f"{1e3 * r32['wall_s'] / r32['iterations']:.3f} ms an "
                    f"iteration; B1 launches {launches32} = force evaluations"
                    f" {evals32}")
    return {"launches": launches, "build_launches": builds, "sim": sim,
            "ebf64": r["ebf"], "ebf32": r32["ebf"]}


def event_script(deck: str, dev: str, dtype, n: int):
    from tpumd_torch.script.parser import LammpsScript
    script = LammpsScript(device=dev, dtype=dtype)
    with contextlib.redirect_stdout(sys.stderr):
        script.run_string(deck.format(n=n))
    script._finalize_atoms()
    script.sim.verbose = False
    script.sim.setup()
    return script


def prd32k_path(smi: str) -> dict:
    """IN_PRD32K in f32 (tests/test_prd.py's deck, 32,000 atoms): ``prd 20
    10 1 10 0 ev 482794 temp 0.1 replicas 4`` with no event, then a run
    whose detector fires at its fifth check (replica 0's first search
    quench, after the four dephase checks), as test_prd_real_event_
    shares_state forces it.  Gates: no event: the one initial row, the
    loop's clock 4 x 20; the event: the rows' steps, clock (RanPark 482794
    + 1000's in-segment draw), replica and flags; the stored event state =
    replica 0's quench to the f32 tolerance; the run goes on, finite; B1
    launches = force evaluations (the deck's set-up's included, as the
    list builds), no plain call of B1 or the list kernels."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.md.prd import PRD, EventDetector, unwrapped_tagged
    from tpumd_torch.utils.ranpark import RanPark
    reset_b1()
    with ForceEvals() as ev0:
        script = event_script(bt.IN_PRD32K, "cuda", torch.float32, 20)
    t0 = time.perf_counter()
    with ForceEvals() as ev, HostReads() as reads:
        script.execute("prd 20 10 1 10 0 ev 482794 temp 0.1 replicas 4")
    torch.cuda.synchronize()
    wall0 = time.perf_counter() - t0
    rows = [(e["step"], e["clock"], e["event"]) for e in script.prd_events]
    runner = script.prd_runner
    launches, plain = b1_calls()
    if rows != [(0, 0, 0)] or runner.clock != 80 or \
            launches != ev0.count + ev.count or plain:
        raise AssertionError(f"IN_PRD32K no event: rows {rows}, clock "
                             f"{runner.clock}, B1 {launches} vs {ev0.count} "
                             f"+ {ev.count}")
    notes = [f"no event: rows {rows}, clock {runner.clock}, "
             f"{runner.segments} segments and {runner.quenches} quenches in "
             f"{wall0:.2f} s, {reads.count} host reads"]
    sim = script.sim

    class OneShot(EventDetector):
        checks = 0

        def check(self, sim, carry):
            self.checks += 1
            return self.checks == 5

    class Recorded(PRD):
        def _quench(self, carry, step):
            q = super()._quench(carry, step)
            self.quenched.append(q)
            return q

    det = OneShot(0.9)
    runner = Recorded(sim, 4, det, 9871, temp=0.1, etol=1e-4, ftol=1e-4,
                      maxiter=100, maxeval=100)
    runner.quenched = []
    start = sim.step
    t0 = time.perf_counter()
    with ForceEvals() as ev:
        events = runner.run(nsteps=20, t_event=10, n_dephase=1,
                            t_dephase=5, t_corr=0)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    # the initial share counts the steps before it on every replica
    # (store_event_prd: delta = (step - 0) x nrep)
    frac = int(RanPark(9871 + 1000).uniform() * 10)
    want = [(start, 4 * start, 0, 0, 0, 0),
            (start + 10, 4 * start + 4 * 10 - (10 - frac) * 4, 1, 0, 1, 0)]
    got = [(e["step"], e["clock"], e["event"], e["correlated"],
            e["coincident"], e["replica"]) for e in events]
    # quench 0 is the initial one, 1-4 the dephases', 5 replica 0's search
    gap = float((det.xevent - unwrapped_tagged(sim, runner.quenched[5]))
                .abs().max()) if len(runner.quenched) > 5 else np.inf
    with ForceEvals() as ev2:
        script.execute("run 10")
    launches2, plain = b1_calls()
    builds, gates, list_plain = list_counts()
    if got != want or not gap <= TOL[torch.float32] or sim.step != \
            start + 30 or not np.isfinite(sim.last_thermo["etotal"]) or \
            launches2 != launches + ev.count + ev2.count or plain or \
            list_plain:
        raise AssertionError(f"IN_PRD32K event: rows {got} vs {want}, "
                             f"event state gap {gap}, step {sim.step}, B1 "
                             f"{launches2} vs {launches} + {ev.count} + "
                             f"{ev2.count}, plain {plain}/{list_plain}")
    notes.append(f"forced event: rows {got}, the stored state = replica "
                 f"0's quench (max gap {gap:.3g}), {runner.segments} "
                 f"segments and {runner.quenches} quenches in {wall1:.2f} s;"
                 f" 10 steps on, etotal {sim.last_thermo['etotal']!r}")
    phase("prd32k", f"{sim.natoms} atoms f32 x 4 replicas on {smi}: "
                    + "; ".join(notes) + f"; B1 launches {launches2} = force "
                    f"evaluations (the set-up's included), plain calls 0; "
                    f"list builds {builds} (the set-up's included), refresh "
                    f"launches {gates}")
    return {"launches": launches2, "build_launches": builds, "sim": sim}


def hop_tad(dev: str, dtype, n: int, neb_iters: int, tmp: Path):
    """``tad 10 10 0.1 0.5 0.1 0.001 ev min 1e-6 1e-6 200 200 neb 0.0 1e-6
    N N 10 replicas 4`` on IN_TAD32K through the script, with one event
    forced: TAD._quench is wrapped for the command's run so that the first
    search segment's quench starts from the hot state with the hopping
    atom set on the vacancy site; the detector (the deck's compute
    event/displace 0.9) then sees the hop and the NEB (4 images, N =
    neb_iters iterations a stage) measures its barrier.  Returns (runner,
    rows, force evaluations, wall s)."""
    from unittest import mock
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.core.state import tag_rows
    from tpumd_torch.md.tad import TAD
    script = event_script(bt.IN_TAD32K, dev, dtype, n)
    sim = script.sim
    tag = bt.neb_final_file(str(tmp / "hop.neb"), sim.state)
    start = sim.step
    quench, hopped = TAD._quench, []

    def hop_quench(self, carry, step):
        if step > start and not hopped:
            hopped.append(step)
            s = carry[0]
            row = tag_rows(s.tag, sim.natoms)[tag - 1:tag]
            carry = (s.replace(x=s.x.index_copy(0, row, torch.zeros(
                (1, 3), dtype=s.x.dtype, device=s.x.device))),) + \
                tuple(carry[1:])
        return quench(self, carry, step)

    reset_b1()
    t0 = time.perf_counter()
    with ForceEvals() as ev, mock.patch.object(TAD, "_quench", hop_quench), \
            contextlib.redirect_stdout(sys.stderr):
        script.execute(f"tad 10 10 0.1 0.5 0.1 0.001 ev min 1e-6 1e-6 200 "
                       f"200 neb 0.0 1e-6 {neb_iters} {neb_iters} 10 "
                       f"replicas 4")
    sync(dev)
    return (script.tad_runner, script.tad_events, ev.count,
            time.perf_counter() - t0)


def tad32k_path(tmp: Path, smi: str) -> dict:
    """IN_TAD32K in f64 (tests/test_tad_hyper.py's TAD at T 0.1 on the
    vacancy deck, 31,999 atoms) through the ``tad`` command, with one event
    forced: the first search segment's candidate is the vacancy hop, its
    NEB runs on the 4-image band of 31,999 atoms.  Gates: the rows (E at
    0, DF at 10: with a 2 eps barrier at T_lo 0.1 the stop time exceeds
    the segment, so the event is not yet confident), 1 < barrier < 3 eps,
    delt_lo = 10 exp(barrier delta_beta) to 1e-9; B1 launches = force
    evaluations, no plain call of B1 or the list kernels.  Returns the
    run's launches, list builds and state."""
    runner, rows, evals, wall = hop_tad("cuda", torch.float64, 20, 100, tmp)
    launches, plain = b1_calls()
    builds, _, list_plain = list_counts()
    got = [(r["step"], r["status"]) for r in rows]
    eb = rows[1]["barrier"] if len(rows) > 1 else np.inf
    deltlo = 10 * np.exp(eb * runner.delta_beta)
    if got != [(0, "E "), (10, "DF")] or not 1.0 < eb < 3.0 \
            or abs(rows[1]["delt_lo"] - deltlo) > 1e-9 * deltlo or \
            launches != evals or plain or list_plain:
        raise AssertionError(f"IN_TAD32K: rows {got}, barrier {eb}, delt_lo "
                             f"{rows[-1]['delt_lo'] if rows else None}, B1 "
                             f"{launches} vs {evals}, plain "
                             f"{plain}/{list_plain}")
    neb = runner.nebs[0]
    phase("tad32k", f"{runner.sim.natoms} atoms f64 on {smi}: rows {got}, "
                    f"barrier {eb!r} (EBR {neb['ebr']!r}), delt_lo "
                    f"{rows[1]['delt_lo']!r}; the NEB: {neb['iterations']} "
                    f"iterations on 4 images, max|F| {neb['fmax_atom']:.3g}, "
                    f"{1e3 * neb['wall_s'] / neb['iterations']:.3f} ms an "
                    f"iteration; the whole run {wall:.2f} s; B1 launches "
                    f"{launches} = force evaluations {evals}, list builds "
                    f"{builds}")
    return {"launches": launches, "build_launches": builds,
            "sim": runner.sim}


def hyper32k_path(smi: str) -> dict:
    """IN_HYPER32K in f32 (tests/test_tad_hyper.py's hyper deck, 32,000
    atoms, fix h all hyper/global 1.3 0.3 0.4 0.4): ``hyper 50 10 h ev min
    1e-6 1e-6 200 200``.  Gates: boost > 1 and t_hyper > steps dt with no
    event; the bias reads nothing from the host (its post_force under
    torch's sync debug mode "error", 20 calls); B1 launches = force
    evaluations (the deck's set-up's included, as the list builds), no
    plain call of B1 or the list kernels."""
    from tpumd_torch import bench_targets as bt
    steps = 50
    reset_b1()
    with ForceEvals() as ev0:
        script = event_script(bt.IN_HYPER32K, "cuda", torch.float32, 20)
    sim = script.sim
    t0 = time.perf_counter()
    with ForceEvals() as ev:
        script.execute(f"hyper {steps} 10 h ev min 1e-6 1e-6 200 200")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = script.hyper_stats
    launches, plain = b1_calls()
    builds, gates, list_plain = list_counts()
    evals = ev0.count + ev.count
    fx = [f for f in sim.fixes if f.name == "hyper/global"][0]
    s, neigh, fstates = sim._carry
    fs = fstates[sim.fixes.index(fx)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(20):
            s2, fs = fx.post_force(s, fs, sim._ctx)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # ~60 launches a call: 8 calls stay inside the card's launch queue
    bias_ms = cuda_ms(lambda: fx.post_force(s, fs, sim._ctx), 8)
    bias_us = host_us(lambda: fx.post_force(s, fs, sim._ctx), 8)
    if not st["boost"] > 1.0 or not st["t_hyper"] > steps * sim.dt or \
            st["nevent"] or launches != evals or plain or list_plain:
        raise AssertionError(f"IN_HYPER32K: {st}, B1 {launches} vs "
                             f"{evals}, plain {plain}/{list_plain}")
    phase("hyper32k", f"{sim.natoms} atoms f32 on {smi}: boost "
                      f"{st['boost']!r}, t_hyper {st['t_hyper']!r} over "
                      f"{steps} steps, {st['nbonds']} bonds, nbias "
                      f"{st['nbias']} nobias {st['nobias']} negstrain "
                      f"{st['negstrain']}, no event; {st['quenches']} "
                      f"quenches, the run {wall:.2f} s; the bias "
                      f"{bias_ms:.4f} ms of the card a step on "
                      f"{st['nbonds']} bonds (CUDA events), {bias_us:.1f} us "
                      f"of host, no host read in 20 calls under sync debug "
                      f"mode error; B1 launches {launches} = force "
                      f"evaluations {evals} and list builds {builds}, the "
                      f"set-up's included; refresh launches {gates}")
    return {"launches": launches, "build_launches": builds, "sim": sim}


def spring_callback(k: float, ell: float):
    """fix external's callback for -k (x - x0), the displacement taken to
    the nearest image (x is wrapped)."""
    x0 = {}

    def cb(caller, step, nlocal, ids, x, fext):
        if not x0:
            x0["x"] = x.copy()
        d = x - x0["x"]
        fext[:] = -k * (d - ell * np.round(d / ell))
    return cb


def external_run(dtype, mode, extra="", hook=None, steps=100):
    """in.lj's 32,000-atom melt through api.TpuMD on the card, with ``fix
    ext all external mode`` where mode is given and extra's lines, hook(md)
    before the run of steps steps; returns the TpuMD."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.api import TpuMD
    md = TpuMD(device="cuda", dtype=dtype)
    deck = (bt.IN_EXTERNAL32K.format(n=20, mode=mode) if mode
            else bt.IN_LJ.format(n=20))
    with contextlib.redirect_stdout(sys.stderr):
        md.commands_string(deck + extra)
        md.sim.verbose = False
        if hook:
            hook(md)
        md.run(steps)
    return md


def capi_run(deck: str, natoms: int):
    """The deck through the C shim in this process (lammps_open_no_mpi with
    --device cuda and --dtype f64, lammps_commands_string,
    lammps_gather_atoms, lammps_extract_atom); returns (x in tag order,
    x[0] by the row table of lammps_extract_atom's host copy)."""
    import ctypes
    from tpumd_torch.capi.build import build
    lib = ctypes.CDLL(build())
    P = ctypes.c_void_p
    lib.lammps_open_no_mpi.restype = P
    lib.lammps_open_no_mpi.argtypes = [ctypes.c_int, P, P]
    lib.lammps_commands_string.argtypes = [P, ctypes.c_char_p]
    lib.lammps_gather_atoms.argtypes = [P, ctypes.c_char_p, ctypes.c_int,
                                        ctypes.c_int, P]
    lib.lammps_extract_atom.restype = P
    lib.lammps_extract_atom.argtypes = [P, ctypes.c_char_p]
    lib.lammps_close.argtypes = [P]
    args = [b"lmp", b"--device", b"cuda", b"--dtype", b"f64"]
    argv = (ctypes.c_char_p * len(args))(*args)
    h = lib.lammps_open_no_mpi(len(args), ctypes.cast(argv, P), None)
    with contextlib.redirect_stdout(sys.stderr):
        lib.lammps_commands_string(h, deck.encode())
    buf = (ctypes.c_double * (3 * natoms))()
    lib.lammps_gather_atoms(h, b"x", 1, 3, buf)
    x = np.frombuffer(buf, np.float64).reshape(natoms, 3).copy()
    rows = ctypes.cast(lib.lammps_extract_atom(h, b"x"),
                       ctypes.POINTER(ctypes.POINTER(ctypes.c_double)))
    row0 = [rows[0][i] for i in range(3)]
    lib.lammps_close(h)
    return x, row0


def external32k_path(smi: str) -> dict:
    """IN_EXTERNAL32K: in.lj's 32,000-atom melt driven three ways.
    Through ``api.TpuMD`` in f64 for 100 steps: ``fix ext all external
    pf/callback 1 1`` with the callback -k (x - x0) against fix spring/self
    k (positions to 1e-8), pf/array's constant buffer against fix addforce
    (to 1e-9); in f32, the callback's host ms a step, host reads per 1,000
    steps, and B1 launches = force evaluations with no plain call.
    Through PyLammps in f32: its thermo series of 100 steps = the API's of
    the same deck (to 1e-6 relative).  Through the C shim (built with gcc
    here, run in this process) in f64: its positions after 100 steps =
    the API's (to 1e-9); the row table of lammps_extract_atom's host copy
    finite."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.pylammps import PyLammps
    k, natoms = bt.EXTERNAL32K_K, 4 * 20 ** 3
    ell = 20 * (4 / 0.8442) ** (1 / 3)
    f64 = torch.float64
    spring = external_run(f64, "", f"fix ext all spring/self {k}\n")
    cb = external_run(f64, "pf/callback 1 1", hook=lambda md: (
        md.set_fix_external_callback("ext", spring_callback(k, ell))))
    gap_cb = float(np.abs(cb.gather_atoms("x") - spring.gather_atoms(
        "x")).max())
    del spring

    def push(md):
        md.command("run 0")
        md.fix_external_get_force("ext")[:] = [0.11, -0.23, 0.05]
    add = external_run(f64, "", "fix ext all addforce 0.11 -0.23 0.05\n")
    arr = external_run(f64, "pf/array 1", hook=push)
    gap_arr = float(np.abs(arr.gather_atoms("x") - add.gather_atoms(
        "x")).max())
    del add, arr
    plain = external_run(f64, "")
    x_api = plain.gather_atoms("x").astype(np.float64)
    del plain
    x_c, row0 = capi_run(bt.IN_LJ.format(n=20) + "run 100\n", natoms)
    gap_c = float(np.abs(x_c - x_api).max())
    if not gap_cb <= 1e-8 or not gap_arr <= 1e-9 or not gap_c <= 1e-9 or \
            not np.isfinite(row0).all():
        raise AssertionError(f"IN_EXTERNAL32K f64: callback vs spring/self "
                             f"{gap_cb}, pf/array vs addforce {gap_arr}, C "
                             f"shim vs API {gap_c}, row 0 {row0}")
    # f32: the callback's cost, counted
    reset_b1()
    with ForceEvals() as ev:
        md = external_run(torch.float32, "pf/callback 1 1",
                          hook=lambda md: md.set_fix_external_callback(
                              "ext", spring_callback(k, ell)))
        fx = md._find_external("ext")
        torch.cuda.synchronize()
        lt0, calls0, cs0 = md.sim.loop_time, fx.reads, fx.callback_s
        md.run(200)
        torch.cuda.synchronize()
        sps = 200 / (md.sim.loop_time - lt0)
        cb_ms = 1e3 * (fx.callback_s - cs0) / (fx.reads - calls0)
        with HostReads() as reads:
            md.run(100)
            torch.cuda.synchronize()
    launches, plain_calls = b1_calls()
    builds, _, list_plain = list_counts()
    # a run of N steps: the callback at its set-up and at every step
    if launches != ev.count or plain_calls or list_plain or fx.reads != 403:
        raise AssertionError(f"IN_EXTERNAL32K f32: B1 {launches} vs "
                             f"{ev.count}, plain {plain_calls}/{list_plain},"
                             f" callbacks {fx.reads}")
    # PyLammps: the same deck's thermo through both front ends, f32
    api = external_run(torch.float32, "", "thermo 50\n", steps=0)
    api.run(100)
    L = PyLammps(device="cuda", dtype=torch.float32)
    with contextlib.redirect_stdout(sys.stderr):
        for line in (bt.IN_LJ.format(n=20) + "thermo 50\n").splitlines():
            if line.strip():
                L.command(line)
        L.lmp.sim.verbose = False
        L.run(0)
        L.run(100)
    th = L.last_run.thermo
    want = api.sim.thermo_rows[-len(th.Step):]
    gap_py = max(abs(a - r[key]) / max(abs(r[key]), 1e-30)
                 for r, a in zip(want, th.TotEng) for key in ("etotal",))
    if [r["step"] for r in want] != list(th.Step) or not gap_py <= 1e-6:
        raise AssertionError(f"IN_EXTERNAL32K PyLammps: steps {th.Step}, "
                             f"etotal gap {gap_py}")
    phase("external32k", f"{natoms} atoms on {smi}: f64 100 steps: "
                         f"pf/callback -k(x - x0) vs fix spring/self "
                         f"max|dx| {gap_cb:.3g}, pf/array vs fix addforce "
                         f"{gap_arr:.3g}, the C shim's lammps_gather_atoms"
                         f" vs the API {gap_c:.3g}; f32: {sps:.2f} "
                         f"timesteps/s with the callback every step, the "
                         f"callback's host {cb_ms:.3f} ms a step, host "
                         f"reads {10 * reads.count} per 1,000 steps; "
                         f"PyLammps' TotEng = the API's to {gap_py:.2e}; "
                         f"B1 launches {launches} = force evaluations "
                         f"{ev.count}, plain calls 0")
    return {"launches": launches, "build_launches": builds, "sim": md.sim}


def replica_small_card_vs_cpu(tmp: Path):
    """The CPU tests' small decks in f64 on the card against the same decks
    on the CPU, each on the engine the CPU run takes (the grid at 4^3
    cells, the matrix engine at 3^3, whose box is narrower than 2
    cutneigh): temper's swap decisions equal and each replica's last pe to
    1e-9; NEB's short stages (N1 20, N2 10) equal to 1e-9 (band, up to
    box lengths, and energies); the prd event rows and tad rows equal
    (floats to 1e-9); hyper's statistics to 1e-9.  P1 launched on the
    matrix-engine decks, B1 on the grid's."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.ops import gather
    from tpumd_torch.script.parser import LammpsScript
    notes = []
    t0 = time.perf_counter()
    gather.counts.reset()
    reset_b1()
    out = {}
    for dev in ("cpu", "cuda"):
        sc = LammpsScript(device=dev, dtype=torch.float64)
        with contextlib.redirect_stdout(sys.stderr):
            sc.run_string(bt.IN_TEMPER32K.format(n=4, steps=120, every=30))
        out[dev] = (sc.temper_accepts, [s.last_thermo["pe"]
                                        for s in sc.replicas],
                    sc.sim._ctx.is_cellgrid)
    (ac, pc, gc), (ag, pg, gg) = out["cpu"], out["cuda"]
    if ac != ag or gc != gg or max(abs(a - b) / abs(b)
                                   for a, b in zip(pg, pc)) > 1e-9:
        raise AssertionError(f"temper small: {out}")
    notes.append(f"temper 4x256 atoms {ag} (grid)")
    out = {}
    for dev in ("cpu", "cuda"):
        sc, r, _, _, _ = neb_run(tmp, dev, torch.float64, 3, 20, 10)
        out[dev] = (r, sc.sim)
    (rc, simc), (rg, simg) = out["cpu"], out["cuda"]
    ell = 3 * bt.NEB_ALAT
    d = rg["band_x"] - rc["band_x"]
    gap = float(np.abs(d - ell * np.round(d / ell)).max())
    egap = max(abs(a - b) / abs(b) for a, b in zip(rg["energies"],
                                                   rc["energies"]))
    if gap > 1e-9 or egap > 1e-9 or rg["climber"] != rc["climber"] or \
            simg._ctx.is_cellgrid or simc._ctx.is_cellgrid:
        raise AssertionError(f"neb small: band gap {gap}, energies {egap}")
    notes.append(f"neb 107 atoms x 8 images (matrix engine): band max|dx| "
                 f"{gap:.2e}, energies {egap:.2e}")
    out = {}
    for dev in ("cpu", "cuda"):
        sc = event_script(bt.IN_PRD32K, dev, torch.float64, 3)
        sc.execute("prd 20 10 1 10 0 ev 482794 temp 0.1 replicas 2")
        rows = [tuple(e[k] for k in ("step", "clock", "event", "correlated",
                                     "coincident", "replica"))
                for e in sc.prd_events]
        tad, trows, _, _ = hop_tad(dev, torch.float64, 4, 20, tmp)
        trows = [(r["step"], r["status"], r["barrier"], r["delt_lo"])
                 for r in trows]
        sc = event_script(bt.IN_HYPER32K, dev, torch.float64, 3)
        sc.execute("hyper 40 10 h ev min 1e-6 1e-6 200 200")
        out[dev] = (rows, trows, sc.hyper_stats)
    (rc, tc, hc), (rg, tg, hg) = out["cpu"], out["cuda"]
    tgap = max(abs(a[k] - b[k]) / max(abs(b[k]), 1.0) for a, b in zip(tg, tc)
               for k in (2, 3))
    hkeys = ("t_hyper", "boost", "nbias", "nobias", "negstrain",
             "ave_boost", "nevent")
    hgap = max(abs(hg[k] - hc[k]) / max(abs(hc[k]), 1e-30) for k in hkeys)
    if rg != rc or [t[:2] for t in tg] != [t[:2] for t in tc] or \
            tgap > 1e-9 or hgap > 1e-9:
        raise AssertionError(f"prd/tad/hyper small: {out}")
    notes.append(f"prd rows {rg}; tad rows {[t[:2] for t in tg]} (floats "
                 f"within {tgap:.2e}); hyper boost {hg['boost']!r} (stats "
                 f"within {hgap:.2e})")
    p1, b1 = gather.counts.kernel_launches, b1_calls()[0]
    if not p1 or not b1:
        raise AssertionError(f"replica small decks: P1 {p1}, B1 {b1} "
                             "launches")
    phase("replica_small", f"card = CPU in f64: " + "; ".join(notes)
          + f"; P1 launches {p1}, B1 launches {b1}; "
          f"{time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------------------
# The one-card part of the parallel layer: B1's special-weighted
# variant and IN_HYB32K on the grid, the r/k split on two streams, balance
# and fix balance, and atom_style ellipsoid.

def live_by_tag(t, tag):
    """The live rows of t (padding dropped) in tag order."""
    from tpumd_torch.core.state import tag_rows
    return t[tag_rows(tag, int((tag > 0).sum()))]


def special_pairs(s, neigh, c, special) -> tuple[int, int]:
    """(unordered pairs that B1-special weighs on this list: live entries
    within the cutoff whose weight is not 0, halved; the list's live
    entries), counted in f64 by the plain sweep's own entry walk."""
    from tpumd_torch.ops.cellgrid_pairlist import list_entries
    _, _, _, r2, code = list_entries(s.x.double(), box_f64(s.box),
                                     neigh.pairs, neigh.npairs,
                                     with_codes=True)
    w = torch.tensor((1.0,) + tuple(special), dtype=torch.float64,
                     device=r2.device)[code]
    return int(((r2 < c.cutsq) & (w != 0)).sum()) // 2, \
        int(neigh.npairs.sum())


def b1_special_vs_plain(sim) -> dict:
    """B1's special-weighted variant at IN_HYB32K's grid shape (the f64
    grid run's step-0 state, and that state in f32 over the same list):
    against its plain list sweep in every flag combination (forces within
    TOL_LIST of max|f|: f32 2e-6, f64 1e-13; energies and virial within
    TOL) and, in f64, against the stencil oracle matching the special tags
    (TOL_ORACLE); timed in f32 with the main path's flags (forces only) in
    the order plain, kernel, kernel, plain, beside its bound and beside B1
    without the weights (code-0 entries only) on the same list.  Its
    launches here are a comparison's: the counts are left as they were."""
    from tpumd_torch.md.verlet import grid_special
    from tpumd_torch.ops.lj_cellgrid import counts, lj_cellgrid, \
        lj_cellgrid_plain, lj_pairlist_plain
    saved = dict(vars(counts))
    s, neigh, _ = sim._carry
    cfg, valid = sim._neigh_cfg, neigh.valid
    w = grid_special(s, sim._ctx)["special"]
    c = sim.pair.kernel_coeffs()
    plist = (neigh.pairs, neigh.npairs, neigh.row2slot)
    out, notes = {}, []
    for dtype in (torch.float64, torch.float32):
        x, box = s.x.to(dtype), s.box.to(device=s.x.device, dtype=dtype)
        worst = 0.0
        for eflag, vflag in ((0, 0), (1, 1), (1, 0), (0, 1)):
            k = lj_cellgrid(x, valid, box, cfg, c, eflag, vflag, plist,
                            special=w)
            p = lj_pairlist_plain(x, box, c, eflag, vflag, *plist[:2],
                                  special=w)
            err = check_close(f"B1-special {str(dtype)[6:]} e{eflag}v{vflag}",
                              k[0], p[0], (k[1],), (p[1],), k[2], p[2],
                              TOL[dtype], eflag, vflag)
            if err > TOL_LIST[dtype]:
                raise AssertionError(f"B1-special {dtype}: forces {err} of "
                                     f"max|f| from the plain list sweep > "
                                     f"{TOL_LIST[dtype]}")
            worst = max(worst, err)
            if dtype == torch.float32 and (eflag, vflag) == (0, 0):
                out["max_abs_err"] = float((k[0] - p[0]).abs().max())
        notes.append(f"{str(dtype)[6:]} {worst:.3g}")
        if dtype == torch.float64:
            k = lj_cellgrid(x, valid, box, cfg, c, 1, 1, plist, special=w)
            o = lj_cellgrid_plain(x, valid, box, cfg, c, 1, 1, special=(
                s.tag, s.special_tags, s.special_codes, w))
            oerr = check_close("B1-special f64 vs the stencil oracle", k[0],
                               o[0], (k[1],), (o[1],), k[2], o[2],
                               TOL[dtype], 1, 1)
            if oerr > TOL_ORACLE[dtype]:
                raise AssertionError(f"B1-special f64: forces {oerr} of "
                                     "max|f| from the stencil oracle")
            notes.append(f"the f64 stencil oracle {oerr:.3g}")
    x32, box32 = s.x.float(), s.box.to(device=s.x.device,
                                       dtype=torch.float32)
    out.update(time_kernel(
        "lj_cellgrid special",
        lambda: lj_cellgrid(x32, valid, box32, cfg, c, 0, 0, plist,
                            special=w),
        lambda: lj_pairlist_plain(x32, box32, c, 0, 0, *plist[:2],
                                  special=w),
        lambda: lj_cellgrid(x32, valid, box32, cfg, c, 1, 1, plist,
                            special=w),
        shape="IN_HYB32K grid", dtype="f32"))
    unweighed = cuda_ms(lambda: lj_cellgrid(x32, valid, box32, cfg, c, 0, 0,
                                            plist), 200)
    nlj, entries = special_pairs(s, neigh, c, w)
    np_, natoms = cfg.capacity, sim.natoms
    # x and validity read, f written (f32), the box lengths
    nbytes = np_ * (12 + 1 + 12) + 12
    out["bound_ms"], out["bound_by"] = bound(nlj, 0, nbytes)
    floor = 4 * entries + 4 * np_ + 8 * natoms
    floor_ms, floor_by = bound(nlj, 0, nbytes + floor)
    phase("kernel", f"lj_cellgrid special at IN_HYB32K's grid shape (grid "
                    f"{cfg.nx}x{cfg.ny}x{cfg.nz} cap {cfg.cap} K "
                    f"{plist[0].shape[1]}, weights {w}): max|f_kernel - "
                    f"f_plain| / max|f| over the four flag combinations "
                    + ", ".join(notes) + f"; {nlj} unordered weighed pairs "
                    f"({2 * nlj / natoms:.2f} an atom) of {entries} list "
                    f"entries ({entries / natoms:.2f} a row), {nbytes} "
                    f"bytes -> bound {out['bound_ms']:.6f} ms "
                    f"({out['bound_by']}); the list's floor {floor} bytes "
                    f"more -> {floor_ms:.6f} ms ({floor_by}); B1 without "
                    f"the weights on this list {unweighed:.4f} ms")
    vars(counts).update(saved)
    return out


def hyb32k_grid_path(smi: str, matrix: dict) -> tuple[dict, dict]:
    """IN_HYB32K on the cell grid, where "auto" sends it since B1's
    special-weighted variant: in f64 the step-0 row against the matrix
    engine's f64 row of this call (hyb32k_path) to 1e-10 and the step-100
    row to 1e-7 (the engines' roundings part over 100 steps);
    B1-special against its plain versions at that state
    (b1_special_vs_plain); then in f32 from the f64 deck's velocities the
    main path: step-0 forces and the step-100 row against the f64 grid
    run's (the f32 gates), 500 timed steps beside the matrix engine's,
    B1-special once per force evaluation and no plain call, the list's
    builds and refresh calls, a profile of 20 steps, and the list build at
    the final state (with the special tags) against its plain build."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.ops import gather
    from tpumd_torch.ops.lj_cellgrid import counts
    with tempfile.TemporaryDirectory() as tmpdir:
        data = Path(tmpdir) / "data.hyb"
        bt.hyb_cell(data)
        ref = hyb_setup(data, bt.HYB32K_REPLICAS, torch.float64, mode="auto")
        v64 = ref.sim.state.v.clone()
        ref.run_string("run 0")
        sim = ref.sim
        row0 = dict(sim.last_thermo)
        bad = bt.gate_failures(row0, {k: (matrix["row0_64"][k], 1e-10)
                                      for k in bt.HYB_KEYS})
        if bad or not sim._ctx.is_cellgrid or sim.state.special_tags is None:
            raise AssertionError(f"IN_HYB32K f64 on the grid, step 0 "
                                 f"against the matrix engine: {bad}, grid "
                                 f"{sim._ctx.is_cellgrid}")
        f0_64 = live_by_tag(sim.state.f, sim.state.tag).clone()
        fmax0 = float(f0_64.abs().max())
        k = b1_special_vs_plain(sim)
        ref.run_string("run 100")
        row100_64 = dict(sim.last_thermo)
        bad = bt.gate_failures(row100_64, {kk: (matrix["row100_64"][kk],
                                                1e-7) for kk in bt.HYB_KEYS})
        if bad:
            raise AssertionError(f"IN_HYB32K f64 on the grid, step 100 "
                                 f"against the matrix engine: {bad}")
        cfg = sim._neigh_cfg
        phase("hyb32k_grid", f"IN_HYB32K f64 on the grid ({cfg.nx}x{cfg.ny}"
                             f"x{cfg.nz} cells, cap {cfg.cap}, K "
                             f"{sim._ctx.pairlist_k}): step 0 = the matrix "
                             f"engine's row to 1e-10, step 100 to 1e-7: "
                             f"{ {kk: row100_64[kk] for kk in bt.HYB_KEYS} }")
        del ref, sim
        torch.cuda.empty_cache()
        # the main path: the counts set to 0 just before it, read after
        counts.reset()
        reset_list_counts()
        gather.counts.reset()
        with ForceEvals() as fe:
            t0 = time.perf_counter()
            script = hyb_setup(data, bt.HYB32K_REPLICAS, torch.float32,
                               mode="auto")
            sim = script.sim
            sim.state = sim.state.replace(v=v64.to(torch.float32))
            script.run_string("run 0")
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            f0 = live_by_tag(sim.state.f, sim.state.tag).double()
            script.run_string("run 100")
            row100 = dict(sim.last_thermo)
            lt0 = sim.loop_time
            script.run_string("run 500")
            torch.cuda.synchronize()
            sps = 500 / (sim.loop_time - lt0)
        evals = fe.count
    launches, special, plain = (counts.kernel_launches,
                                counts.special_launches, counts.plain_calls)
    builds, gates, list_plain = list_counts()
    plain += list_plain + gather.counts.plain_calls
    ferr = float((f0 - f0_64).abs().max())
    bad = bt.gate_failures(row100, {kk: (row100_64[kk], bt.HYB_F32_ROW_RTOL)
                                    for kk in bt.HYB_KEYS})
    if not ferr <= bt.HYB_F32_FORCE_TOL * fmax0 or bad:
        raise AssertionError(f"IN_HYB32K f32 on the grid: step-0 forces "
                             f"{ferr} > {bt.HYB_F32_FORCE_TOL} * {fmax0}, or "
                             f"step 100 {bad}")
    if not special == launches == evals or plain or not sim._ctx.is_cellgrid:
        raise AssertionError(f"IN_HYB32K f32 on the grid: B1-special "
                             f"launches {special} (B1 {launches}) vs force "
                             f"evaluations {evals}, plain calls {plain}")
    s, neigh, _ = sim._carry
    natoms = 256 * bt.HYB32K_REPLICAS ** 3
    finite = bool(torch.isfinite(s.x).all()) and bool(
        torch.isfinite(s.v).all()) and not bool(neigh.overflow)
    if not finite or int((s.tag > 0).sum()) != natoms:
        raise AssertionError("IN_HYB32K f32 on the grid: a NaN, an "
                             "overflow or a lost atom")
    phase("hyb32k_grid", f"IN_HYB32K f32 on the grid: set-up {setup_s:.3f} "
                         f"s; step-0 forces = f64 to {ferr:.3e} (<= "
                         f"{bt.HYB_F32_FORCE_TOL} x max|f| {fmax0:.4f}); "
                         f"step 100 = f64 to {bt.HYB_F32_ROW_RTOL}; timed "
                         f"500 steps: {sps:.2f} timesteps/s, "
                         f"{sps * natoms / 1e6:.3f} Matom-step/s on {smi} "
                         f"(the matrix engine's in this call: "
                         f"{matrix['sps']:.2f}); B1-special launches "
                         f"{special} = force evaluations {evals}, plain "
                         f"calls 0; list builds {builds}, refresh launches "
                         f"{gates}, refreshes {sim.list_refreshes}; P1 "
                         f"launches {gather.counts.kernel_launches}")
    phase("hyb32k_grid", "IN_HYB32K grid " + profile_steps(script, 20,
                                                           1e3 / sps))
    kb = time_build("hyb32k_grid", (s.x, neigh.valid, s.tag, s.special_tags,
                                    s.special_codes, s.box, sim._neigh_cfg,
                                    sim._ctx.pairlist_k, None, ()))
    m = {"launches": special, "build_launches": builds, "gates": gates,
         "refreshes": sim.list_refreshes, "sps": sps, "build": kb}
    if gates:
        m["upkeep"] = time_upkeep("hyb32k_grid", sim, build=False,
                                  refresh=sim.list_refreshes > 0)
    del script, sim, s, neigh
    torch.cuda.empty_cache()
    return k, m


def stream_times(fn, n: int = 5) -> dict:
    """Per call of fn under torch.profiler: each stream's kernel ms, their
    sum and the union of the kernels' intervals on the card (what they
    overlap is the sum less the union), from the Chrome trace; empty if
    the trace holds no kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmpdir:
        path = Path(tmpdir) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
              (e.get("args") or {}).get("stream", e.get("tid")))
             for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                 "gpu_memset")
             and "dur" in e]
    if not spans:
        return {}
    per = {}
    for a, b, st in spans:
        per[st] = per.get(st, 0.0) + (b - a)
    union, end = 0.0, -np.inf
    for a, b, _ in sorted(spans):
        if b > end:
            union += b - max(a, end)
            end = b
    return {"streams": {st: v / 1e3 / n for st, v in per.items()},
            "sum": sum(per.values()) / 1e3 / n, "union": union / 1e3 / n}


def host_sync(fn) -> str:
    """Where fn first makes the host wait for the card: under
    torch.cuda.set_sync_debug_mode("error") a synchronizing call raises,
    and the innermost frame of the port's code in its traceback (file:line)
    names it; "none" when fn runs through."""
    import traceback
    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as err:
        ours = [fr for fr in traceback.extract_tb(err.__traceback__)
                if "tpumd_torch" in fr.filename]
        return (f"{Path(ours[-1].filename).name}:{ours[-1].lineno}"
                if ours else "outside the port") + f" ({str(err)[:60]})"
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return "none"


def rk_split_phase(smi: str) -> dict:
    """The r/k-space split (tpumd_torch/parallel/rkspace.py) at
    rhodo_class (the peptide replicated 2x2x4, 32,064 atoms, CHARMM + PPPM
    1e-4, the grid) in f64 at the set-up's state: the split (k-space on a
    side stream) = the fused evaluation to 1e-11 of max|f|; then the
    split, the fused evaluation, the r-space part and PPPM alone timed by
    CUDA events (the card's span of 20 calls) and by the host clock to a
    synchronize, in the order fused, split, split, fused; each stream's
    kernel time and their overlap under the profiler; and the first host
    read (a synchronizing call) in the k-space branch and in the r-space
    part, which would serialise the two streams."""
    from tpumd_torch.md.verlet import compute_forces
    from tpumd_torch.parallel import rkspace
    script = rhodo_setup("2 2 4", "cuda", torch.float64)
    script.run_string("run 0")
    sim = script.sim
    s, neigh, _ = sim._carry
    ctx = sim._ctx
    f_split, f_fused = rkspace.dryrun_rk_split(sim)
    torch.cuda.synchronize()
    fmax = float(f_fused.abs().max())
    err = float((f_split - f_fused).abs().max())
    if not err <= 1e-11 * fmax or not ctx.is_cellgrid:
        raise AssertionError(f"r/k split at rhodo_class: max|f_split - "
                             f"f_fused| {err} > 1e-11 x {fmax}")
    split = rkspace.make_split_force_fn(ctx)
    fns = {"fused": lambda: compute_forces(s, neigh, ctx, False, False),
           "split": lambda: split(s, neigh),
           "r-space": lambda: compute_forces(s, neigh, ctx, False, False,
                                             cats=rkspace.RCATS),
           "PPPM": lambda: rkspace.kspace_forces(s, ctx)}

    def wall_ms(fn, n=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n
    ev, wall = {}, {}
    for name in ("fused", "split", "split", "fused", "r-space", "PPPM"):
        ev.setdefault(name, []).append(cuda_ms(fns[name], 20, ahead=False))
        wall.setdefault(name, []).append(wall_ms(fns[name]))
    ev = {k: min(v) for k, v in ev.items()}
    wall = {k: min(v) for k, v in wall.items()}
    streams = {name: stream_times(fns[name]) for name in ("split", "fused")}
    syncs = {name: host_sync(fns[name]) for name in ("PPPM", "r-space")}
    prof = "; ".join(
        f"{name}: " + (", ".join(f"stream {st} {v:.4f}" for st, v in
                                 t["streams"].items())
                       + f", sum {t['sum']:.4f}, union {t['union']:.4f} ms "
                       f"(overlap {t['sum'] - t['union']:.4f})"
                       if t else "no kernel in the trace (not measured)")
        for name, t in streams.items())
    phase("rksplit", f"rhodo_class f64 ({sim.natoms} atoms, PPPM mesh "
                     f"{ctx.kspace.nx}x{ctx.kspace.ny}x{ctx.kspace.nz}): "
                     f"max|f_split - f_fused| = {err:.3e} (<= 1e-11 x max|f|"
                     f" {fmax:.4f}) on {smi}")
    phase("rksplit", "CUDA events ms a call: " + ", ".join(
        f"{k} {v:.4f}" for k, v in ev.items()) + "; host clock ms a call: "
          + ", ".join(f"{k} {v:.4f}" for k, v in wall.items())
          + f"; PPPM {ev['PPPM'] / ev['fused']:.1%} of the fused "
          f"evaluation; the split {ev['split'] / ev['fused']:.3f} x the "
          f"fused (max(r, k) {max(ev['r-space'], ev['PPPM']):.4f} ms)")
    phase("rksplit", f"profiled kernels ms a call: {prof}")
    phase("rksplit", "the first host read (a synchronizing call) in each "
                     "half: " + "; ".join(f"{k} {v}" for k, v in
                                          syncs.items()))
    out = {"ev": ev, "wall": wall, "streams": streams, "syncs": syncs,
           "err": err}
    del script, sim, s, neigh, f_split, f_fused
    torch.cuda.empty_cache()
    return out


BALANCE_CELLS = 20   # in.lj's box: 32,000 atoms


def balance32k_phase() -> tuple[dict, dict]:
    """balance and fix balance with 8 parts (``part_count`` set to 8, as
    the CPU tests set it) on the 32k in.lj deck on the matrix engine, its
    list checked every step, f64:
    ``balance 1.1 rcb`` and ``fix fb all balance 50 1.0 rcb`` through
    LammpsScript, against the same deck without them: the rows of steps
    0, 50 and 100 equal to 1e-12 (step 0) and 1e-9 (the row order changes
    the sums' order), the printed line and the fix's log lines, P1
    launched and no plain call in both runs; P1 bit-equal to its plain
    version on every kind of input the balanced run gave it, and timed at
    its packed j rows (p1_at_shape)."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.ops import gather
    from tpumd_torch.parallel import balance
    from tpumd_torch.script.parser import LammpsScript
    # the list checked every step, so that the fix's re-set-ups (a list
    # built anew) leave the pairs summed as they were
    deck = bt.IN_LJ.format(n=BALANCE_CELLS) + (
        "neigh_modify    delay 0 every 1 check yes\nthermo          50\n")
    natoms = 4 * BALANCE_CELLS ** 3
    rows, notes = {}, {}
    saved = balance.part_count
    balance.part_count = lambda device: 8
    try:
        for name, extra in (("plain", ""),
                            ("balanced", "balance 1.1 rcb\nfix fb all "
                                         "balance 50 1.0 rcb\n")):
            gather.counts.reset()
            script = LammpsScript(device="cuda", dtype=torch.float64)
            printed, seen = io.StringIO(), {}
            with contextlib.redirect_stdout(printed), recording_p1(seen):
                script.run_string(deck)
                script.sim.neighbor_mode = "matrix"
                script.run_string(extra)
                order = script.sim.state.tag.clone()
                script.run_string("run 100")
            sim = script.sim
            rows[name] = {int(r["step"]): r for r in sim.thermo_rows}
            launches, plain = gather.counts.kernel_launches, \
                gather.counts.plain_calls
            if sim._ctx.is_cellgrid or not launches or plain:
                raise AssertionError(f"balance32k {name}: P1 launches "
                                     f"{launches}, plain {plain}")
            notes[name] = ([ln.strip() for ln in printed.getvalue()
                            .splitlines() if "rebalancing" in ln]
                           + [ln for ln in sim.log_lines
                              if "fix balance" in ln], launches,
                           bool(torch.equal(order, torch.sort(order)[0])))
            del script, sim
    finally:
        balance.part_count = saved
    lines, launches, sorted_rows = notes["balanced"]
    if sorted(rows["plain"]) != sorted(rows["balanced"]) != [0, 50, 100] \
            or len(lines) != 3 or sorted_rows:
        raise AssertionError(f"balance32k: rows {sorted(rows['balanced'])}, "
                             f"lines {lines}, rows left in tag order "
                             f"{sorted_rows}")
    for step, r in rows["balanced"].items():
        tol = 1e-12 if step == 0 else 1e-9
        bad = bt.gate_failures(r, {k: (rows["plain"][step][k], tol)
                                   for k in ("temp", "epair", "etotal",
                                             "press")})
        if bad:
            raise AssertionError(f"balance32k step {step}: {bad}")
    phase("balance", f"32k in.lj f64 on the matrix engine, 8 parts: "
                     f"{'; '.join(lines)}; rows of steps 0, 50, 100 = the "
                     f"unbalanced run's (1e-12, 1e-9): etotal "
                     f"{rows['balanced'][100]['etotal']!r} vs "
                     f"{rows['plain'][100]['etotal']!r}; P1 launches "
                     f"{launches} (unbalanced {notes['plain'][1]}), plain "
                     "calls 0")
    kinds = p1_equal_plain(seen.values(), "balance32k input")
    table, idx = max((v for (d, t, i), v in seen.items()
                      if t[0] == natoms and len(i) == 2),
                     key=lambda v: v[1].numel())
    k = p1_at_shape("balance32k", table, idx, kinds)
    return k, {"launches": launches}


def ellipsoid_card_vs_cpu():
    """bench_targets' ellipsoid liquid (8^3 = 512 ellipsoids, every eighth
    a point) 50 steps in f64 on the card (the grid, B1 launched, no plain
    call) and on the CPU: every row equal to 1e-10, and the flags,
    semi-axes, quaternions, angular momenta, torques and masses, moved
    with their atoms through the re-bins, equal by tag to the data
    file's."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.io.restart import tag_ordered
    from tpumd_torch.ops.lj_cellgrid import counts
    from tpumd_torch.script.parser import LammpsScript
    fields = ("ellipsoid", "shape", "quat", "angmom", "torque", "rmass")
    rows, got = {}, {}
    with tempfile.TemporaryDirectory() as tmpdir:
        data = Path(tmpdir) / "data.ell"
        n = bt.ellipsoid_data(data, 8)
        for dev in ("cpu", "cuda"):
            counts.reset()
            script = LammpsScript(device=dev, dtype=torch.float64)
            with contextlib.redirect_stdout(sys.stderr):
                script.run_string(bt.IN_ELLIPSOID.format(data=data))
                start = {k: getattr(tag_ordered(script.sim), k).cpu()
                         for k in fields}
                script.run_string("run 50")
            sim = script.sim
            rows[dev] = {int(r["step"]): r for r in sim.thermo_rows}
            end = tag_ordered(sim)
            got[dev] = all(torch.equal(getattr(end, k).cpu(), start[k])
                           for k in fields)
        if not sim._ctx.is_cellgrid or counts.kernel_launches < 50 \
                or counts.plain_calls or not all(got.values()):
            raise AssertionError(f"ellipsoid deck: grid "
                                 f"{sim._ctx.is_cellgrid}, B1 launches "
                                 f"{counts.kernel_launches}, plain "
                                 f"{counts.plain_calls}, fields kept {got}")
    for step, r in rows["cuda"].items():
        bad = bt.gate_failures(r, {k: (rows["cpu"][step][k], 1e-10)
                                    for k in ("temp", "epair", "etotal",
                                              "press")})
        if bad:
            raise AssertionError(f"ellipsoid deck step {step}: {bad}")
    phase("ellipsoid", f"{n} ellipsoids (atom_style ellipsoid) f64 50 "
                       f"steps, card (grid, B1 {counts.kernel_launches} "
                       f"launches) = CPU to 1e-10 at steps "
                       f"{sorted(rows['cuda'])}; the six per-atom fields "
                       "equal by tag after the re-bins")


# ------------------------------------------------------------ decomp_path
# the layouts of part 1: 4 z-slabs and 2 x 2 (z, y) pencils
DECOMP_LAYOUTS = ((4, 1), (2, 2))
# an owned row's forces against the global launch's (of max|f|)
DECOMP_TOL = {torch.float32: 1e-6, torch.float64: 1e-13}
# part 1 takes its states this many steps after the set-up: at the fcc
# start an atom's forces cancel to rounding, which no tolerance of max|f|
# can hold
DECOMP_STEPS = 100


def decomp_local(lay, s, valid, K):
    """A rank's local grid (GridLayout lay) assembled by index from the
    global grid-ordered state s on the card, and its pair list built by
    the list kernel on the box whose split axes are not periodic: (local
    state, valid, owned, global slot of each local slot, plist (pairs,
    npairs, the owned slots))."""
    from tpumd_torch.ops.cellgrid_pairlist import cellgrid_pairlist
    from tpumd_torch.parallel.decomp import assemble_slots
    sl, vl = assemble_slots(lay, s, valid)
    gslot, _, own = (torch.as_tensor(a, device=s.x.device)
                     for a in lay.slot_maps)
    owned = vl & own
    pairs, npairs, _, over = cellgrid_pairlist(
        sl.x, vl, sl.tag, None, None, lay.list_box(s.box), lay.local_cfg, K)
    if bool(over):
        raise AssertionError(f"local grid {lay.pz}x{lay.py} rank {lay.rank}:"
                             f" pair list overflow at K {K}")
    return sl, vl, owned, gslot, (pairs, npairs,
                                  torch.nonzero(owned).reshape(-1))


def owned_gap(what, f, fg, plist, gslot, gn, tol) -> tuple[float, bool]:
    """(max|f - f_global| / max|f_global| over the owned rows, whether they
    are bit-equal); raises past tol, or where an owned row's list length
    differs from its global row's."""
    torch.cuda.synchronize()
    rows = plist[2]
    if not torch.equal(plist[1][rows], gn[gslot[rows]]):
        raise AssertionError(f"{what}: owned rows' list lengths differ from "
                             "the global list's")
    a, b = f[rows], fg[gslot[rows]]
    err = float((a - b).abs().max()) / float(fg.abs().max())
    if not torch.isfinite(a).all() or not err <= tol:
        raise AssertionError(f"{what}: owned rows' forces {err} of max|f| "
                             f"from the global launch's (tol {tol:g})")
    return err, bool(torch.equal(a, b))


def plain_gap(what, f, fp, rows, tol) -> tuple[float, float]:
    """(max|f - f_plain| over the owned rows (the kernel's and its plain
    version's on the same local inputs), the same of their largest
    |f_plain|); raises where the second passes tol or f is not finite."""
    a, b = f[rows], fp[rows]
    err = float((a - b).abs().max())
    rel = err / float(b.abs().max())
    if not torch.isfinite(a).all() or not rel <= tol:
        raise AssertionError(f"{what}: owned rows {err} from the plain "
                             f"version's, {rel} of its max (tol {tol:g})")
    return err, rel


def owned_pairs(x, box, plist, cutsq) -> int:
    """In-cutoff code-0 entries of the owned rows, halved: the unordered
    pairs' worth of work a local sweep does."""
    from tpumd_torch.ops.cellgrid_pairlist import list_entries
    *_, r2 = list_entries(x.double(), box_f64(box), plist[0], plist[1],
                          rows=plist[2])
    return int((r2 < cutsq).sum()) // 2


def decomp_grids(name, s, valid, cfg, K, launch, plain) -> tuple:
    """Part 1 on one deck: for f32 and f64 the global list and launch,
    then each rank's local grid of each layout (``decomp_local``) and its
    launch, every owned row held to its plain version on the same local
    inputs (TOL_LIST: the same pairs in the same order) and to the global
    launch (DECOMP_TOL).  launch(x_state, valid, owned, cfg, plist,
    fp_global, gslot) -> the forces and EAM's F' (else None), fp_global
    the global density pass's F' for EAM's halos (None at the global
    launch); plain(x_state, owned, plist, fp) -> the same of the plain
    versions, fp the kernel's F' with its halos filled (B4's input).
    Returns ([(layout, rank 0's local state, valid, owned, plist)] of the
    first layout, f32 then f64, for the timings; the f32 global (list,
    F'); {"f", "fp": the largest |kernel - plain| of the owned rows'
    forces and F'; "rel_f", "rel_fp": the same of the plain's max;
    "gap_f", "gap_fp": the largest gap of the owned rows from the global
    launch's, of its max|f|})."""
    from tpumd_torch.ops.cellgrid_pairlist import cellgrid_pairlist
    from tpumd_torch.parallel.decomp import GridLayout
    keys = ("f", "fp", "rel_f", "rel_fp", "gap_f", "gap_fp")
    kept, worst_all = [], dict.fromkeys(keys, 0.0)
    for dtype in (torch.float32, torch.float64):
        sd = s.replace(x=s.x.to(dtype),
                       box=s.box.to(device=s.x.device, dtype=dtype))
        gp, gn, _, over = cellgrid_pairlist(sd.x, valid, sd.tag, None, None,
                                            sd.box, cfg, K)
        if bool(over):
            raise AssertionError(f"{name}: global list overflow at K {K}")
        gplist = (gp, gn, torch.nonzero(valid).reshape(-1))
        fg, fpg = launch(sd, valid, valid, cfg, gplist, None, None)
        if dtype == torch.float32:
            glob = (gplist, fpg)
        worst = dict.fromkeys(worst_all, 0.0)
        bit = True
        for pz, py in DECOMP_LAYOUTS:
            for rank in range(pz * py):
                lay = GridLayout(cfg, pz, py, rank)
                sl, vl, owned, gslot, plist = decomp_local(lay, sd, valid, K)
                f, fp = launch(sl, vl, owned, lay.local_cfg, plist, fpg,
                               gslot)
                pf, pfp = plain(sl, owned, plist, fp)
                what = f"{name} {pz}x{py} rank {rank} {str(dtype)[6:]}"
                gaps = [("f", plain_gap(what, f, pf, plist[2],
                                        TOL_LIST[dtype]))]
                err, same = owned_gap(what, f, fg, plist, gslot, gn,
                                      DECOMP_TOL[dtype])
                if fp is not None:
                    gaps.append(("fp", plain_gap(what + " F'", fp, pfp,
                                                 plist[2], TOL_LIST[dtype])))
                    e2, s2 = owned_gap(what + " F'", fp, fpg, plist, gslot,
                                       gn, DECOMP_TOL[dtype])
                    worst["gap_fp"], same = max(worst["gap_fp"], e2), \
                        same and s2
                for k, (e, r) in gaps:
                    worst[k] = max(worst[k], e)
                    worst["rel_" + k] = max(worst["rel_" + k], r)
                worst["gap_f"], bit = max(worst["gap_f"], err), bit and same
                if rank == 0 and (pz, py) == DECOMP_LAYOUTS[0]:
                    kept.append((lay, sl, vl, owned, plist))
        layouts = " and ".join(f"{a}x{b}" for a, b in DECOMP_LAYOUTS)
        eam = (f", F' {worst['rel_fp']:.3g} of max|F'| (tol "
               f"{TOL_LIST[dtype]:g})" if fpg is not None else "")
        phase("decomp", f"{name} {str(dtype)[6:]}: grid {cfg.nx}x{cfg.ny}x"
                        f"{cfg.nz} cap {cfg.cap} K {K}, local grids as "
                        f"{layouts} assembled by index (halos with their "
                        f"seam shift): every owned row against the plain "
                        f"list sweeps on the same local grid, f "
                        f"{worst['rel_f']:.3g} of max|f| (tol "
                        f"{TOL_LIST[dtype]:g}){eam}; its list length and "
                        f"forces = the "
                        f"global launch's to {worst['gap_f']:.3g} max|f| "
                        f"(tol {DECOMP_TOL[dtype]:g}), "
                        f"{'bit-equal' if bit else 'not bit-equal'}")
        for k in worst_all:
            worst_all[k] = max(worst_all[k], worst[k])
    return kept, glob, worst_all


def decomp_local_grids(tmp: Path) -> dict:
    """Part 1 of decomp_path: lj864 (bench/in.lj with x, y, z 3, in f32)
    and in.eam at 32,000 atoms (12^3 cells), DECOMP_STEPS steps from the
    set-up, their global grids cut into the local grids of 4 z-slabs and
    2 x 2 pencils on the one card:
    the list kernel and B1 (eam: B3, F' of the halo slots from the global
    pass by index, B4) on each local grid against their plain versions on
    the same local inputs and against the global launch; then at rank 0's
    4-slab local grid in f32, each kernel timed beside its plain version,
    the global launch and its bound, and the list build against its plain
    build (time_build).  Returns the kernels line's figures."""
    from tpumd_torch.bench_targets import IN_LJ_BENCH, eam_funcfl
    from tpumd_torch.ops.eam_cellgrid import eam_force_cellgrid, \
        eam_force_pairlist_plain, eam_rho_cellgrid, eam_rho_pairlist_plain
    from tpumd_torch.ops.lj_cellgrid import lj_cellgrid, lj_pairlist_plain
    from tpumd_torch.script.parser import LammpsScript
    out = {}
    script = LammpsScript(device="cuda", dtype=torch.float32,
                          var_overrides={"x": 3, "y": 3, "z": 3})
    script.run_string(IN_LJ_BENCH.rsplit("\nrun", 1)[0])
    sim = script.sim
    sim.verbose = False
    script.run_string(f"run {DECOMP_STEPS}")
    s, neigh, _ = sim._carry
    c = sim.pair.kernel_coeffs()
    K = sim._ctx.pairlist_k

    def lj(sd, valid, owned, cfg, plist, fpg, gslot):
        return lj_cellgrid(sd.x, owned, sd.box, cfg, c, 0, 0, plist)[0], None

    def lj_plain(sd, owned, plist, fp):
        return lj_pairlist_plain(sd.x, sd.box, c, 0, 0, plist[0], plist[1],
                                 rows=plist[2])[0], None

    ((lay, sl, vl, owned, plist), _), (gplist, _), err = decomp_grids(
        "lj864", s, neigh.valid, sim._neigh_cfg, K, lj, lj_plain)
    lc = lay.local_cfg
    ms = min(cuda_ms(lambda: lj_cellgrid(sl.x, owned, s.box, lc, c, 0, 0,
                                         plist), 100) for _ in range(2))
    # the global launch in this call, beside the local one
    g_ms = min(cuda_ms(lambda: lj_cellgrid(s.x, neigh.valid, s.box,
                                           sim._neigh_cfg, c, 0, 0, gplist),
                       100) for _ in range(2))
    plain_ms = cuda_ms(lambda: lj_pairlist_plain(
        sl.x, s.box, c, 0, 0, plist[0], plist[1], rows=plist[2]), 2,
        ahead=False)
    nlj = owned_pairs(sl.x, s.box, plist, c.cutsq)
    nbytes = lc.capacity * (12 + 1 + 12) + 12
    b_ms, b_by = bound(nlj, 0, nbytes)
    phase("kernel", f"lj_cellgrid on lj864's 4-slab local grid (rank 0: "
                    f"{lc.nx}x{lc.ny}x{lc.nz} cap {lc.cap}, "
                    f"{plist[2].numel()} owned atoms), f32 forces: kernel "
                    f"{ms:.4f} ms (the global 35^3 launch {g_ms:.4f} ms in "
                    f"this call), plain list sweep {plain_ms:.4f} ms, bound "
                    f"{b_ms:.6f} ms ({b_by}: {nlj} pairs, {nbytes} bytes)")
    out["b1"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "max_abs_err": err["f"],
                 "global_gap": err["gap_f"], "global_ms": g_ms}
    box = lay.list_box(s.box)
    out["build"] = time_build("lj864 4-slab local grid (rank 0)",
                              (sl.x, vl, sl.tag, None, None, box, lc, K),
                              plain_reps=1)
    del script, sim, s, neigh, sl, plist, gplist
    torch.cuda.empty_cache()

    pot = tmp / "Cu.eam"
    eam_funcfl(str(pot))
    script = eam_setup(pot, 20, "cuda", torch.float32)
    script.run_string(f"run {DECOMP_STEPS}")
    sim = script.sim
    s, neigh, _ = sim._carry
    K = sim._ctx.pairlist_k
    tabs = {}

    def table(x):
        if x.dtype not in tabs:
            tabs[x.dtype] = sim.pair.kernel_tables(x)
        return tabs[x.dtype]

    def eam(sd, valid, owned, cfg, plist, fpg, gslot):
        tab = table(sd.x)
        _, fp, _ = eam_rho_cellgrid(sd.x, owned, sd.box, cfg, tab, 0, plist)
        if fpg is not None:
            # F' of the halo slots from their owners (here, the global pass)
            fp = torch.where(owned, fp, torch.where(valid, fpg[gslot], 0.0))
        f = eam_force_cellgrid(sd.x, owned, fp, sd.box, cfg, tab, 0, 0,
                               plist)[0]
        return f, fp

    def eam_plain(sd, owned, plist, fp):
        tab = table(sd.x)
        _, pfp, _ = eam_rho_pairlist_plain(sd.x, owned, sd.box, tab, 0,
                                           plist[0], plist[1], rows=plist[2])
        f = eam_force_pairlist_plain(sd.x, fp, sd.box, tab, 0, 0, plist[0],
                                     plist[1], rows=plist[2])[0]
        return f, pfp

    ((lay, sl, _, owned, plist), _), (gplist, gfp), err = decomp_grids(
        "eam32k", s, neigh.valid, sim._neigh_cfg, K, eam, eam_plain)
    lc, gc = lay.local_cfg, sim._neigh_cfg
    tab = tabs[torch.float32]
    _, fp, _ = eam_rho_cellgrid(sl.x, owned, s.box, lc, tab, 0, plist)
    rho_ms = min(cuda_ms(lambda: eam_rho_cellgrid(
        sl.x, owned, s.box, lc, tab, 0, plist), 100) for _ in range(2))
    force_ms = min(cuda_ms(lambda: eam_force_cellgrid(
        sl.x, owned, fp, s.box, lc, tab, 0, 0, plist), 100)
        for _ in range(2))
    # the global 12^3 launches in this call, beside the local ones
    g_rho = min(cuda_ms(lambda: eam_rho_cellgrid(
        s.x, neigh.valid, s.box, gc, tab, 0, gplist), 100) for _ in range(2))
    g_force = min(cuda_ms(lambda: eam_force_cellgrid(
        s.x, neigh.valid, gfp, s.box, gc, tab, 0, 0, gplist), 100)
        for _ in range(2))
    rho_plain = cuda_ms(lambda: eam_rho_pairlist_plain(
        sl.x, owned, s.box, tab, 0, plist[0], plist[1], rows=plist[2]), 5,
        ahead=False)
    force_plain = cuda_ms(lambda: eam_force_pairlist_plain(
        sl.x, fp, s.box, tab, 0, 0, plist[0], plist[1], rows=plist[2]), 5,
        ahead=False)
    npair = owned_pairs(sl.x, s.box, plist, tab.cutsq)
    natoms = plist[2].numel()
    np_ = lc.capacity
    tables = 4 * (tab.rhor.numel() + tab.frho.numel())
    rho_b = roof(npair * OPS_EAM_RHO_PAIR + natoms * OPS_EAM_EMBED,
                 np_ * (12 + 1 + 4 + 4) + 12 + tables)
    tables = 4 * (tab.rhor.numel() + tab.z2r.numel())
    force_b = roof(npair * OPS_EAM_FORCE_PAIR,
                   np_ * (12 + 1 + 4 + 12) + 12 + tables)
    phase("kernel", f"eam on eam32k's 4-slab local grid (rank 0: "
                    f"{lc.nx}x{lc.ny}x{lc.nz} cap {lc.cap}, {natoms} owned "
                    f"atoms, {npair} pairs), f32: B3 {rho_ms:.4f} ms (plain "
                    f"{rho_plain:.4f}, bound {rho_b[0]:.6f} {rho_b[1]}), B4 "
                    f"{force_ms:.4f} ms (plain {force_plain:.4f}, bound "
                    f"{force_b[0]:.6f} {force_b[1]}); the global "
                    f"{gc.nx}x{gc.ny}x{gc.nz} launches in this call: B3 "
                    f"{g_rho:.4f} ms, B4 {g_force:.4f} ms")
    out["rho"] = {"ms": rho_ms, "plain_ms": rho_plain, "bound_ms": rho_b[0],
                  "bound_by": rho_b[1], "max_abs_err": err["fp"],
                  "global_gap": err["gap_fp"], "global_ms": g_rho}
    out["force"] = {"ms": force_ms, "plain_ms": force_plain,
                    "bound_ms": force_b[0], "bound_by": force_b[1],
                    "max_abs_err": err["f"], "global_gap": err["gap_f"],
                    "global_ms": g_force}
    del script, sim, s, neigh, sl, plist, gplist, gfp
    torch.cuda.empty_cache()
    out["p1"] = decomp_rows_p1()
    return out


def decomp_rows_p1() -> dict:
    """P1 at the matrix engine's row-block shape: the 32k in.lj deck's
    matrix set-up in f32, rank 0's rows of 4 built over every row's
    positions (``build_neighbors(..., rows=)``, its gathers P1's), then
    the pair sweep's packed j-side gather of those rows timed
    (p1_timed)."""
    from tpumd_torch.bench_targets import IN_LJ
    from tpumd_torch.ops import neighbor as nb
    from tpumd_torch.script.parser import LammpsScript
    script = LammpsScript(device="cuda", dtype=torch.float32)
    script.run_string(IN_LJ.format(n=20))
    sim = script.sim
    sim.verbose = False
    sim.neighbor_mode = "matrix"
    script.run_string("run 0")
    s = sim._carry[0]
    n = s.x.shape[0]
    idx, _, _, over = nb.build_neighbors(s.x, s.box, sim._neigh_cfg,
                                         rows=(0, n // 4))
    full = nb.build_neighbors(s.x, s.box, sim._neigh_cfg)[0]
    if bool(over) or not torch.equal(idx, full[:n // 4]):
        raise AssertionError("matrix rows 0 to n/4: their block's rows "
                             "differ from the whole build's")
    table = torch.cat([s.x, s.type.to(s.x.dtype)[:, None]], dim=1)
    return p1_timed(f"in.lj 32k matrix rows of rank 0 of 4 ({n // 4} of "
                    f"{n}, K {idx.shape[1]})", table, idx)


def decomp_run_phase(tmp: Path, smi: str, one: dict) -> dict:
    """Part 2 of decomp_path: P = min(4, the card count) workers over NCCL
    (``parallel/launch.py``), one card each, run lj864 in f32 (run 100,
    then 100 timed steps and 10 counted ones) and in.eam at 32,000 atoms
    in f64 (run 100) decomposed; step 0 of lj864 against the one-card
    run's row (one, from script_lj864_path), its step 100 behind the
    lj864 gates, eam's rows against a one-card f64 run in this process to
    1e-10; each rank's B1 (B3, B4) launches = its force evaluations, no
    plain call; the collectives a step by kind (none an all-gather), the
    exchange's ms and bytes a step; timesteps/s beside the one-card
    run's."""
    from tpumd_torch.bench_targets import IN_EAM, IN_LJ, IN_LJ_BENCH, \
        SANITY, STEP0, STEP0_RTOL, eam_funcfl, gate_failures
    from tpumd_torch.script.parser import LammpsScript
    from tpumd_torch.parallel.launch import run_decks, spawn_world
    ncards = torch.cuda.device_count()
    nprocs = min(4, ncards)
    pot = tmp / "Cu_decomp.eam"
    eam_funcfl(str(pot))
    eam_deck = IN_EAM.format(n=20, potential=pot)
    ref = eam_setup(pot, 20, "cuda", torch.float64)
    ref.run_string("run 100")
    ref_rows = ref.sim.thermo_rows
    mref = LammpsScript(device="cuda", dtype=torch.float32)
    mref.run_string(IN_LJ.format(n=20) + "thermo 20\n")
    mref.sim.verbose = False
    mref.sim.neighbor_mode = "matrix"
    mref.run_string("run 20")
    mref_rows = mref.sim.thermo_rows
    del ref, mref
    torch.cuda.empty_cache()
    lj_pre = IN_LJ_BENCH.rsplit("\nrun", 1)[0]
    specs = [{"setup": lj_pre, "vars": {"x": 3, "y": 3, "z": 3},
              "dtype": "f32", "runs": ["run 100"], "timed": 100,
              "steady": 10},
             {"setup": eam_deck, "dtype": "f64", "runs": ["run 100"]},
             {"setup": IN_LJ.format(n=20) + "thermo 20\n", "dtype": "f32",
              "mode": "matrix", "runs": ["run 20"], "steady": 4}]
    t0 = time.perf_counter()
    ranks = spawn_world(run_decks, nprocs, "nccl", tmp / "pg", (specs,),
                        timeout=400)
    wall = time.perf_counter() - t0
    if nprocs == 1:
        phase("decomp", f"{ncards} card: a world of one over NCCL; the run "
                        "went through the mesh, the agreed flags and the "
                        "thermo reductions, split no axis and exchanged no "
                        "halo (NCCL takes no two ranks on one card); the "
                        "exchange is checked on the CPU by the gloo tests "
                        "and here by the local grids assembled by index")
    bad = []
    for rank, (lj, eam, mat) in enumerate(ranks):
        row0, row100 = lj["rows"][0], lj["rows"][-1]
        bad += gate_failures(row0, {k: (v, STEP0_RTOL)
                                    for k, v in STEP0["lj864"].items()})
        bad += gate_failures(row100, SANITY["lj864"])
        for k in ("temp", "epair", "etotal", "press"):
            a, b = row0[k], one["row0"][k]
            same = (f"{a:12.8g}" == f"{b:12.8g}" if nprocs == 1
                    else abs(a - b) <= 1e-6 * abs(b))
            if not same:
                bad.append(f"rank {rank} lj864 step 0 {k} {a!r} vs one card "
                           f"{b!r}")
        for got, want in zip(eam["rows"], ref_rows):
            for k in ("temp", "epair", "etotal", "press"):
                if not abs(got[k] - want[k]) <= 1e-10 * abs(want[k]):
                    bad.append(f"rank {rank} eam step {got['step']} {k} "
                               f"{got[k]!r} vs one card {want[k]!r}")
        if len(eam["rows"]) != len(ref_rows):
            bad.append(f"rank {rank} eam: {len(eam['rows'])} rows")
        evals = 1 + 100 + 1
        if (lj["counts"]["b1"] != (evals, 0)
                or lj["timed"]["counts"]["b1"] != (101, 0)
                or eam["counts"]["rho"] != (evals + 1, 0)
                or eam["counts"]["force"] != (evals + 1, 0)):
            bad.append(f"rank {rank} launches: B1 {lj['counts']['b1']} and "
                       f"{lj['timed']['counts']['b1']}, B3 "
                       f"{eam['counts']['rho']}, B4 {eam['counts']['force']}"
                       f" (force evaluations {evals}, 101, {evals + 1})")
        st = lj["steady"]
        if st["calls"]["all_gather"] or st["calls"]["all_reduce"]:
            bad.append(f"rank {rank}: collectives between output steps "
                       f"{st['calls']}")
        # the matrix engine's rows: the one-card run's rows (f32 sums of
        # other blocks where P > 1), P1 launched, an all-gather a step
        for got, want in zip(mat["rows"], mref_rows):
            for k in ("temp", "epair", "etotal", "press"):
                tol = 0.0 if nprocs == 1 else 1e-5
                if not abs(got[k] - want[k]) <= tol * abs(want[k]):
                    bad.append(f"rank {rank} matrix step {got['step']} {k} "
                               f"{got[k]!r} vs one card {want[k]!r}")
        if (mat["counts"]["p1"][1] or not mat["counts"]["p1"][0]
                or mat["steady"]["calls"]["all_gather"] != 4):
            bad.append(f"rank {rank} matrix: P1 {mat['counts']['p1']}, "
                       f"collectives {mat['steady']['calls']}")
    if bad:
        raise AssertionError("decomp_path: " + "; ".join(bad))
    lj0 = ranks[0][0]
    sps = [r[0]["timed"]["steps"] / r[0]["timed"]["seconds"] for r in ranks]
    phase("decomp", f"P {nprocs} on {ncards} card(s) ({smi}); world of "
                    f"{nprocs} over NCCL, {wall:.1f} s with its start; lj864 "
                    f"f32 as {lj0['layout']['pz']}x{lj0['layout']['py']} "
                    f"(local grid {lj0['layout']['local']}): step 0 "
                    f"{lj0['rows'][0]['etotal']!r} (one card "
                    f"{one['row0']['etotal']!r}), step 100 passes the lj864 "
                    f"gates; eam32k f64 rows = the one-card run's to 1e-10 "
                    f"at steps {[r['step'] for r in ref_rows]}")
    for rank, (lj, eam, mat) in enumerate(ranks):
        t, st = lj["timed"], lj["steady"]
        per_step = {k: v / 10 for k, v in st["calls"].items()}
        window = t["collectives"]["bytes"]["exchange"] / t["steps"]
        phase("decomp", f"rank {rank}: timed 100 steps {sps[rank]:.2f} "
                        f"timesteps/s, {sps[rank] * 864000 / 1e6:.3f} "
                        f"Matom-step/s (one card in this call "
                        f"{one['sps']:.2f}); exchange "
                        f"{t['exchange_ms'] / t['steps']:.4f} ms and "
                        f"{window:.0f} bytes a step over the window (re-bins "
                        f"included), {st['bytes']['exchange'] / 10:.0f} bytes"
                        f" a step between output steps; collectives a step "
                        f"{per_step}; "
                        f"B1 {lj['counts']['b1'][0]} + "
                        f"{t['counts']['b1'][0]} launches = force "
                        f"evaluations; B3 {eam['counts']['rho'][0]}, B4 "
                        f"{eam['counts']['force'][0]}; list builds "
                        f"{lj['counts']['build'][0]} + "
                        f"{t['counts']['build'][0]}; matrix in.lj 32k P1 "
                        f"{mat['counts']['p1'][0]} launches, "
                        f"{mat['steady']['bytes']['all_gather'] / 4:.0f} "
                        f"bytes all-gathered a step")
    return {"b1": lj0["counts"]["b1"][0] + lj0["timed"]["counts"]["b1"][0],
            "rho": ranks[0][1]["counts"]["rho"][0],
            "force": ranks[0][1]["counts"]["force"][0],
            "build": (lj0["counts"]["build"][0]
                      + lj0["timed"]["counts"]["build"][0]
                      + ranks[0][1]["counts"]["build"][0]),
            "p1": ranks[0][2]["counts"]["p1"][0], "sps": sps}


def decomp_path(smi: str, one: dict) -> tuple[dict, dict]:
    """The decomposed grid (``tpumd_torch/parallel``): part 1, the local
    grids of 4 slabs and 2 x 2 pencils on the one card against the global
    launch (``decomp_local_grids``); part 2, the decomposed runs over NCCL
    (``decomp_run_phase``).  Returns (the kernels' figures, the launches
    of the decomposed runs)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        k = decomp_local_grids(tmp)
        torch.cuda.empty_cache()
        m = decomp_run_phase(tmp, smi, one)
    phase("decomp", f"decomp_path {time.perf_counter() - t0:.1f} s")
    return k, m


# ------------------------------------------ the molecular stack decomposed
class LocalGrid:
    """The decomposition a step context reads on a local grid assembled on
    one card: its layout, and the halo slots' velocities and forces as the
    caller filled them (by index from the global grid)."""

    kind = "grid"

    def __init__(self, layout):
        self.layout = layout

    def exchange_vf(self, v, f):
        return v, f


def water_shake30k(dtype, bonded_grid=False):
    """LammpsScript of IN_WATER_SHAKE30K on the card, on the grid, verbose
    off, before its first run."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.script.parser import LammpsScript
    script = LammpsScript(device="cuda", dtype=dtype)
    script.run_string(bt.IN_WATER_SHAKE30K.format(
        golden=GOLDEN.parent / "water_shake"))
    sim = script.sim
    sim.verbose = False
    sim.neighbor_mode = "cellgrid"
    sim.bonded_grid = bonded_grid
    return script


def shake_residuals(fx, x, lengths) -> tuple[float, float]:
    """(the largest |d - d0| / d0 of fix shake's bonds, of its angle
    clusters' 1-2 distances) at positions x by tag - 1 (f64, the minimum
    image of the box lengths)."""
    x = x.double()
    worst = [0.0, 0.0]
    for members, dists in fx._tables(x).values():
        if members.shape[0] == 0:
            continue
        pts = [x[members[:, k]] for k in range(members.shape[1])]
        pairs = [(0, k) for k in range(1, len(pts))]
        if members.shape[1] == 3 and len(dists) == 3:
            pairs = [(0, 1), (0, 2), (1, 2)]
        for (a, b), d0 in zip(pairs, dists):
            d = pts[b] - pts[a]
            d = d - lengths * torch.round(d / lengths)
            gap = float(torch.max(torch.abs(
                torch.linalg.vector_norm(d, dim=1) - d0) / d0))
            k = int((a, b) == (1, 2))
            worst[k] = max(worst[k], gap)
    return worst[0], worst[1]


def molecular_local_grids(script, smi: str) -> dict:
    """Part 1 of decomp_molecular_path, on one card: IN_WATER_SHAKE30K's f64
    state 100 steps on, cut into the local grids of 4 z-slabs and 2 x 2
    pencils (``assemble_slots``: charges, special lists and the per-atom
    tables with the atoms, the halos' seam shift).  In f32 and f64 the
    global grid's B5-rows launch over every atom against its rowless
    launch (in f64 to TOL; in f32 reported), and on every local grid, each
    owned row's B5-rows forces
    against the global B5-rows launch (bit for bit) and against the plain
    version on the same local inputs (TOL_LIST).  In f64 the tag-matched
    bonded forces (the deck's bonds and angles, which SHAKE takes out of
    the run, evaluated here with every tuple) and SHAKE's tag-matched
    deltas (the halos' v and f by index from the global grid) against the
    tag-order view's and the slot-map path's, per owned atom, to 1e-12 of
    their largest.  Then at rank 0's 4-slab grid in f32: B5-rows timed
    beside its plain version, its bound and the global launch; the list
    build (time_build); match_members in ms and bytes a call, there and on
    the global grid.  Returns the kernels line's figures."""
    from tpumd_torch.ops import cellgrid_tuples as ct
    from tpumd_torch.ops.cellgrid_pairlist import cellgrid_pairlist
    from tpumd_torch.ops.charmm_cellgrid import charmm_cellgrid, \
        charmm_rows_plain
    from tpumd_torch.parallel.decomp import GridLayout, assemble_slots
    sim = script.sim
    s, neigh, _ = sim._carry
    cfg, K, ctx = sim._neigh_cfg, sim._ctx.pairlist_k, sim._ctx
    valid = neigh.valid
    grows = torch.nonzero(valid).reshape(-1)
    kept = {}
    worst = {"rel_f": 0.0, "gap_rowless": 0.0, "bonded": 0.0, "shake": 0.0}
    for dtype in (torch.float32, torch.float64):
        sd = s.replace(x=s.x.to(dtype), q=s.q.to(dtype),
                       box=s.box.to(device=s.x.device, dtype=dtype))
        c = sim.pair.kernel_coeffs(sd.x, *sim._special_weights())
        gp, gn, _, over = cellgrid_pairlist(
            sd.x, valid, sd.tag, sd.special_tags, sd.special_codes, sd.box,
            cfg, K)
        if bool(over):
            raise AssertionError(f"water_shake30k: global list overflow at "
                                 f"K {K}")
        gargs = (sd.x, sd.q, sd.type, gp, gn, sd.box, cfg, c)
        fg = charmm_cellgrid(*gargs, 0, 0, rows=grows)[0]
        f0 = charmm_cellgrid(*gargs, 0, 0)[0]
        torch.cuda.synchronize()
        rowless = float((fg - f0).abs().max()) / float(f0.abs().max())
        # the two round only a seam pair's image otherwise; in f32 that
        # rounding (~1e-5 A at 76-95 A) moves the nearly cancelling
        # Coulomb terms of excluded pairs as far as the kernel's own gap
        # from its plain version (TOL), so f64 alone is gated
        if dtype == torch.float64 and not rowless <= TOL[dtype]:
            raise AssertionError(f"B5-rows over every atom {rowless} of "
                                 f"max|f| from the rowless launch")
        gate = (f"tol {TOL[dtype]:g}" if dtype == torch.float64
                else "not gated in f32")
        worst["gap_rowless"] = max(worst["gap_rowless"], rowless)
        bit, rel = True, 0.0
        for pz, py in DECOMP_LAYOUTS:
            for rank in range(pz * py):
                lay = GridLayout(cfg, pz, py, rank)
                sl, vl = assemble_slots(lay, sd, valid)
                gslot, _, own = (torch.as_tensor(a, device=s.x.device)
                                 for a in lay.slot_maps)
                owned = vl & own
                rows = torch.nonzero(owned).reshape(-1)
                lbox = lay.list_box(sd.box)
                pairs, npairs, _, over = cellgrid_pairlist(
                    sl.x, vl, sl.tag, sl.special_tags, sl.special_codes,
                    lbox, lay.local_cfg, K)
                if bool(over):
                    raise AssertionError("local list overflow")
                largs = (sl.x, sl.q, sl.type, pairs, npairs, sd.box,
                         lay.local_cfg, c)
                f = charmm_cellgrid(*largs, 0, 0, rows=rows)[0]
                fp = charmm_rows_plain(*largs[:6], c, 0, 0, rows)[0]
                what = f"water_shake30k {pz}x{py} rank {rank} " \
                       f"{str(dtype)[6:]} B5-rows"
                err, r = plain_gap(what, f, fp, rows, TOL_LIST[dtype])
                rel = max(rel, r)
                worst["rel_f"] = max(worst["rel_f"], r)
                _, same = owned_gap(what, f, fg, (pairs, npairs, rows), gslot,
                                    gn, DECOMP_TOL[dtype])
                if bool(f[~owned].any()):
                    raise AssertionError(f"{what}: forces off the rows")
                bit = bit and same
                if dtype == torch.float64:
                    worst["bonded"] = max(worst["bonded"], bonded_gap(
                        sim, ctx, sd, sl, lay, owned, gslot))
                    worst["shake"] = max(worst["shake"], shake_gap(
                        sim, ctx, sd, sl, lay, owned, gslot))
                if rank == 0 and (pz, py) == DECOMP_LAYOUTS[0]:
                    kept[dtype] = (lay, sl, vl, owned, rows, largs, gargs)
        if not bit:
            raise AssertionError(f"water_shake30k {str(dtype)[6:]}: owned "
                                 "rows' B5-rows forces not bit-equal to the "
                                 "global B5-rows launch")
        phase("decomp", f"water_shake30k {str(dtype)[6:]} ({smi}): grid "
                        f"{cfg.nx}x{cfg.ny}x{cfg.nz} cap {cfg.cap} K {K}, "
                        f"local grids as 4x1 and 2x2: every owned row's "
                        f"B5-rows forces bit-equal to the global B5-rows "
                        f"launch (which is {rowless:.3g} of max|f| from the "
                        f"rowless launch, the image rounded otherwise, "
                        f"{gate}), "
                        f"{rel:.3g} of max|f| from the plain version on the "
                        f"same local grid (tol {TOL_LIST[dtype]:g}), the "
                        f"other slots 0")
    phase("decomp", f"water_shake30k f64 local grids: tag-matched bonded "
                    f"forces = the tag-order view's to {worst['bonded']:.3g} "
                    f"of max|f|, SHAKE's tag-matched deltas = the slot-map "
                    f"path's to {worst['shake']:.3g} (tol 1e-12), per "
                    f"owned atom")
    lay, sl, vl, owned, rows, largs, gargs = kept[torch.float32]
    c = largs[7]
    lc = lay.local_cfg
    ms = min(cuda_ms(lambda: charmm_cellgrid(*largs, 0, 0, rows=rows), 100)
             for _ in range(2))
    g_ms = min(cuda_ms(lambda: charmm_cellgrid(*gargs, 0, 0), 100)
               for _ in range(2))
    plain_ms = cuda_ms(lambda: charmm_rows_plain(*largs[:6], c, 0, 0, rows),
                       3, ahead=False)
    live = torch.where(owned, largs[4], 0)
    ncoul, nlj, nsw, nall = list_charmm_counts(largs[0], largs[5], largs[3],
                                               live, c)
    nbytes = lc.capacity * (12 + 4 + 4) + rows.numel() * 12 \
        + c.lj.numel() * 4 + 12
    ops = (nall * OPS_CHARMM_PAIR + ncoul * OPS_CHARMM_COUL
           + nlj * OPS_CHARMM_LJ + nsw * OPS_CHARMM_SWITCH)
    b_ms, b_by = roof(ops, nbytes)
    phase("kernel", f"charmm_cellgrid B5-rows on water_shake30k's 4-slab "
                    f"local grid (rank 0: {lc.nx}x{lc.ny}x{lc.nz} cap "
                    f"{lc.cap}, {rows.numel()} owned atoms), f32 forces "
                    f"({smi}): kernel {ms:.4f} ms (the global rowless "
                    f"launch {g_ms:.4f} ms in this call), plain {plain_ms:.4f}"
                    f" ms, bound {b_ms:.6f} ms ({b_by}: {nall} pairs in range"
                    f", {ncoul} in Coulomb range, {nbytes} bytes)")
    out = {"b5": {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                  "bound_by": b_by, "max_abs_err": worst["rel_f"],
                  "global_ms": g_ms}}
    out["build"] = time_build(
        "water_shake30k 4-slab local grid (rank 0)",
        (largs[0], vl, sl.tag, sl.special_tags, sl.special_codes,
         lay.list_box(largs[5]), lc, K), plain_reps=1)
    # match_members: ms and bytes a call on the global grid and rank 0's
    fx = sim.shake_fixes()[0]
    tab = fx.grid_tables(sim.natoms)[0]
    for what, st, copies in (("global grid", gargs, 1),
                             ("rank 0's 4-slab grid", largs, lay.copies)):
        x, q, type_ = st[:3]
        tag = s.tag if st is gargs else sl.tag
        want = torch.as_tensor(tab, device=s.x.device)[
            torch.clamp(tag.long() - 1, min=0)] * (tag > 0)[:, None]
        ct.match_members(x, tag, type_, q, want, copies=copies)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ct.match_members(x, tag, type_, q, want, copies=copies)
        torch.cuda.synchronize()
        nb_ = torch.cuda.max_memory_allocated() - base
        m_ms = cuda_ms(lambda: ct.match_members(x, tag, type_, q, want,
                                                copies=copies), 50)
        phase("kernel", f"match_members (SHAKE's 4 member tags a slot) on "
                        f"water_shake30k's {what} ({x.shape[0]} slots, f32, "
                        f"{smi}): {m_ms:.4f} ms a call, {nb_} bytes of "
                        f"device memory at its peak")
        out[f"match_{'global' if st is gargs else 'local'}"] = m_ms
    return out


def bonded_gap(sim, ctx, sd, sl, lay, owned, gslot) -> float:
    """The tag-matched bonded forces of the deck's bonds and angles (every
    tuple; SHAKE takes them out of the run) on the local grid sl, against
    the tag-order view's on the global grid sd, per owned atom, of their
    largest."""
    from tpumd_torch.models.bonded import compute_tuples, tag_view
    from tpumd_torch.ops import cellgrid_tuples as ct
    styles = [st for st in sim.bonded.values()]
    arities = {st.kind: st.arity for st in styles}
    topo = {k: sim.topology[k] for k in arities}
    tables = ct.build_tuple_tables(sim.natoms, topo, arities)
    gtag = sd.tag.long()
    rows_l = sl.tag.long()

    def by_slot(tag, a):
        t = torch.as_tensor(a, device=sd.x.device)
        return t[torch.clamp(tag - 1, min=0)] * (tag > 0).view(
            (-1,) + (1,) * (t.dim() - 1))

    loc = sl.replace(peratom={k: by_slot(rows_l, v) * owned.view(
        (-1,) + (1,) * (v.ndim - 1)) for k, v in tables.items()})
    lctx = dataclasses.replace(ctx, decomp=LocalGrid(lay), bonded_grid=True)
    f = ct.compute_bonded_grid(loc, lctx, styles, False, False)[0]
    row2slot = sim._carry[1].row2slot
    _, view, take = tag_view(sd, ctx, row2slot)
    ftag = None
    for st in styles:
        t = torch.as_tensor(np.asarray(topo[st.kind]), dtype=torch.int64,
                            device=sd.x.device)
        t = torch.cat([t[:, :1], t[:, 1:] - 1], dim=1)
        fb = compute_tuples(st, view, t, sd.box, ctx, False, False, take)[0]
        ftag = fb if ftag is None else ftag + fb
    want = ftag[sl.tag.long()[owned] - 1]
    got = f[owned]
    return float((got - want).abs().max()) / float(ftag.abs().max())


def shake_gap(sim, ctx, sd, sl, lay, owned, gslot) -> float:
    """SHAKE's tag-matched constraint deltas on the local grid sl (its
    halo slots' v and f by index from the global grid) against the
    slot-map path's on the global grid sd, per owned atom, of their
    largest."""
    from tpumd_torch.md.fix_shake import GRID_KEYS
    fx = sim.shake_fixes()[0]
    dtfsq = ctx.dt * ctx.dt * ctx.units.ftm2v
    ref = fx._apply_slots(sd, ctx, dtfsq)[0].f - sd.f
    tag = sl.tag.long()
    tabs = [torch.as_tensor(a, device=sd.x.device)[
        torch.clamp(tag - 1, min=0)] for a in fx.grid_tables(sim.natoms)]
    tabs = [t * owned.view((-1,) + (1,) * (t.dim() - 1)).to(t.dtype)
            for t in tabs]
    valid = sl.tag > 0
    full = valid[:, None]
    loc = sl.replace(v=torch.where(full, sd.v[gslot], 0.0),
                     f=torch.where(full, sd.f[gslot], 0.0),
                     peratom={**(sl.peratom or {}),
                              **dict(zip(GRID_KEYS, tabs))})
    lctx = dataclasses.replace(ctx, decomp=LocalGrid(lay), bonded_grid=True)
    out, flags = fx._apply_grid(loc, lctx, dtfsq)
    if float(flags[6]):
        raise AssertionError("SHAKE's tag-matched path lost a member")
    got = (out.f - loc.f)[owned]
    want = ref[gslot[owned]]
    return float((got - want).abs().max()) / float(ref.abs().max())


def molecular_one_card(smi: str) -> dict:
    """Part 2: IN_WATER_SHAKE30K on one card with ``bonded_grid`` on and
    off: f64 rows at steps 0 and 20 equal to 1e-10; f32 100 steps each,
    then 100 timed steps each, timesteps/s in this call; the f64 run (off)
    goes on to step 100 for part 1.  Returns the rows and the f64 script."""
    rows = {}
    for on in (False, True):
        script = water_shake30k(torch.float64, on)
        script.run_string("run 20")
        rows[("f64", on)] = list(script.sim.thermo_rows)
        if not on:
            f64 = script
    bad = [f"step {a['step']} {k}: {a[k]!r} vs {b[k]!r}"
           for a, b in zip(rows[("f64", True)], rows[("f64", False)])
           for k in ("temp", "epair", "etotal", "press")
           if not abs(a[k] - b[k]) <= 1e-10 * abs(b[k])]
    if bad or len(rows[("f64", True)]) != 2:
        raise AssertionError("water_shake30k bonded_grid f64: " + "; ".join(
            bad))
    sps = {}
    for on in (False, True):
        script = water_shake30k(torch.float32, on)
        script.run_string("run 100")
        rows[("f32", on)] = list(script.sim.thermo_rows)
        t0 = script.sim.loop_time
        script.run_string("run 100")
        sps[on] = 100 / (script.sim.loop_time - t0)
        assert script.sim._ctx.bonded_grid == on
        del script
        torch.cuda.empty_cache()
    phase("main", f"water_shake30k on one card ({smi}): bonded_grid on = off "
                  f"in f64 to 1e-10 at steps 0 and 20; f32, 100 steps timed "
                  f"after 100: {sps[False]:.2f} timesteps/s off, "
                  f"{sps[True]:.2f} on, in this call")
    f64.run_string("run 80")
    return {"rows": rows, "f64": f64, "sps": sps}


def molecular_decomposed(tmp: Path, smi: str, one: dict) -> dict:
    """Part 3: P = min(4, the card count) workers over NCCL, one card each,
    run IN_WATER_SHAKE30K decomposed: f64 20 steps, its rows at steps 0 and
    20 against the one-card run's to 1e-10; f32 100 steps (step 0 against
    the one-card f32 row, rtol 1e-4; SHAKE's bond and angle residuals at
    step 100 under its tolerance 1e-4), then 50 timed and 10 counted steps:
    B5-rows launches = force evaluations with no plain call, the
    collectives a step by kind between output steps (no all-gather),
    pppm's mesh all-reduce bytes, the exchange's ms and bytes a step."""
    from tpumd_torch import bench_targets as bt
    from tpumd_torch.parallel.launch import run_decks, spawn_world
    ncards = torch.cuda.device_count()
    nprocs = min(4, ncards)
    deck = bt.IN_WATER_SHAKE30K.format(golden=GOLDEN.parent / "water_shake")
    specs = [{"setup": deck, "dtype": "f64", "mode": "cellgrid",
              "runs": ["run 20"]},
             {"setup": deck, "dtype": "f32", "mode": "cellgrid",
              "runs": ["run 100"], "timed": 50, "steady": 10}]
    t0 = time.perf_counter()
    ranks = spawn_world(run_decks, nprocs, "nccl", tmp / "pg_molecular",
                        (specs,), timeout=500)
    wall = time.perf_counter() - t0
    f64 = one["f64"].sim
    fx = f64.shake_fixes()[0]
    mesh = f64.kspace.nx * f64.kspace.ny * f64.kspace.nz
    lengths = f64.state.box.lengths.double()
    bad = []
    evals = 1 + force_evals(100, 50)
    for rank, (d64, d32) in enumerate(ranks):
        for got, want in zip(d64["rows"], one["rows"][("f64", False)]):
            for k in ("temp", "epair", "etotal", "press"):
                if not abs(got[k] - want[k]) <= 1e-10 * abs(want[k]):
                    bad.append(f"rank {rank} f64 step {got['step']} {k} "
                               f"{got[k]!r} vs one card {want[k]!r}")
        if [r["step"] for r in d64["rows"]] != [0, 20]:
            bad.append(f"rank {rank} f64 rows {len(d64['rows'])}")
        a, b = d32["rows"][0], one["rows"][("f32", False)][0]
        for k in ("temp", "epair", "etotal", "press"):
            if not abs(a[k] - b[k]) <= 1e-4 * abs(b[k]):
                bad.append(f"rank {rank} f32 step 0 {k} {a[k]!r} vs one "
                           f"card {b[k]!r}")
        bond, angle = shake_residuals(fx, torch.as_tensor(d32["x"]),
                                      lengths.cpu())
        if not (bond < 1e-4 and angle < 1e-4):
            bad.append(f"rank {rank} SHAKE residuals {bond}, {angle}")
        b5 = d32["counts"]["b5"]
        if b5 != (evals, evals, 0) or d32["timed"]["counts"]["b5"] != (
                51, 51, 0):
            bad.append(f"rank {rank} B5 {b5}, timed "
                       f"{d32['timed']['counts']['b5']} (force evaluations "
                       f"{evals}, 51)")
        st = d32["steady"]
        if st["calls"]["all_gather"]:
            bad.append(f"rank {rank}: an all-gather between output steps "
                       f"{st['calls']}")
        ranks[rank] = (d64, d32, bond, angle)
    if bad:
        raise AssertionError("decomp_molecular_path: " + "; ".join(bad))
    d32 = ranks[0][1]
    for rank, (d64, d32r, bond, angle) in enumerate(ranks):
        t, st = d32r["timed"], d32r["steady"]
        sps = t["steps"] / t["seconds"]
        phase("decomp", f"water_shake30k rank {rank} of {nprocs} over NCCL "
                        f"({smi}; world {wall:.1f} s with its start), "
                        f"{d32r['layout']}: f64 rows at steps 0 and 20 = the "
                        f"one-card run's to 1e-10; f32 step 0 etotal "
                        f"{d32r['rows'][0]['etotal']!r} (one card "
                        f"{one['rows'][('f32', False)][0]['etotal']!r}); "
                        f"SHAKE residuals at step 100 {bond:.3g} (bonds), "
                        f"{angle:.3g} (the angle's 1-2); timed 50 steps "
                        f"{sps:.2f} timesteps/s; exchange "
                        f"{t['exchange_ms'] / t['steps']:.4f} ms a step; "
                        f"collectives a step between output steps "
                        f"{ {k: v / 10 for k, v in st['calls'].items()} }, "
                        f"bytes {st['bytes']}; pppm's mesh {mesh} values, "
                        f"{mesh * d32r['itemsize']} bytes an all-reduce; "
                        f"B5-rows {d32r['counts']['b5'][1]} + "
                        f"{t['counts']['b5'][1]} launches = force "
                        f"evaluations; list builds "
                        f"{d32r['counts']['build'][0]}")
    return {"b5": d32["counts"]["b5"][1] + d32["timed"]["counts"]["b5"][1],
            "build": d32["counts"]["build"][0]
            + d32["timed"]["counts"]["build"][0]}


def decomp_molecular_path(smi: str) -> tuple[dict, dict]:
    """The molecular stack decomposed (ROADMAP item 14b): part 2 on one
    card, bonded_grid on against off (``molecular_one_card``); part 1 the
    local grids at the f64 run's state at step 100
    (``molecular_local_grids``); part 3 the decomposed runs
    (``molecular_decomposed``).  Returns (the kernels' figures, the
    launches of the decomposed runs)."""
    t0 = time.perf_counter()
    one = molecular_one_card(smi)
    k = molecular_local_grids(one["f64"], smi)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmpdir:
        m = molecular_decomposed(Path(tmpdir), smi, one)
    phase("decomp", f"decomp_molecular_path {time.perf_counter() - t0:.1f} s")
    return k, m



# ------------------------------- the thermostats and barostats decomposed
# the f64 rows of the decomposed runs against one card's: every 10 steps
# over THERMO_STEPS
THERMO_STEPS = 20
# rhodo_class's f32 run on one card and decomposed: steps timed after the
# step-100 gate, and the steps whose collectives are counted
THERMO_TIMED = 30
THERMO_STEADY = 10
LJ_THERMOSTATS = {"nvt": "fix 1 all nvt temp 1.44 1.44 0.5",
                  "langevin": "fix 1 all nve\n"
                              "fix 2 all langevin 1.44 1.44 1.0 48279"}


def lj32k_thermostat(which: str) -> str:
    """IN_LJ at 32,000 atoms with fix nve replaced by the thermostat
    LJ_THERMOSTATS[which], a thermo row every 10 steps."""
    from tpumd_torch.bench_targets import IN_LJ
    return IN_LJ.format(n=20).replace("fix             1 all nve",
                                      LJ_THERMOSTATS[which]) + "thermo 10\n"


def rhodo_deck(thermo: int = 0) -> str:
    from tpumd_torch.bench_targets import IN_RHODO_CLASS
    return IN_RHODO_CLASS.format(golden=GOLDEN) + (
        f"thermo          {thermo}\n" if thermo else "")


def rows_gaps(what, got, want, keys, rtol) -> list[str]:
    """The thermo keys of rows got that differ from want's by more than
    rtol, or the steps where they differ."""
    if [a["step"] for a in got] != [b["step"] for b in want]:
        return [f"{what}: steps {[a['step'] for a in got]} vs "
                f"{[b['step'] for b in want]}"]
    return [f"{what} step {a['step']} {k} {a[k]!r} vs {b[k]!r}"
            for a, b in zip(got, want) for k in keys
            if not abs(a[k] - b[k]) <= rtol * abs(b[k])]


def thermostat_one_card(smi: str) -> dict:
    """One card: rhodo_class in f64 THERMO_STEPS steps with ``bonded_grid``
    off (the tag-order view) and on (SHAKE's mixed cluster sizes on the
    tag-matched path, ROADMAP C43), rows equal to 1e-10; rhodo_class in
    f32 behind its step-0 and step-100 gates, then THERMO_TIMED timed
    steps; the two in.lj 32k thermostat decks in f64.  Returns the rows,
    the timesteps/s and the f32 rhodo_class and f64 nvt scripts (at their
    final states)."""
    from tpumd_torch.bench_targets import RHODO_STEP0, RHODO_STEP100, \
        STEP0_RTOL, gate_failures
    from tpumd_torch.script.parser import LammpsScript
    out = {}
    for on in (False, True):
        script = rhodo_setup("2 2 4", "cuda", torch.float64, thermo=10)
        script.sim.neighbor_mode = "cellgrid"
        script.sim.bonded_grid = on
        script.run_string(f"run {THERMO_STEPS}")
        if script.sim._ctx.bonded_grid != on:
            raise AssertionError(f"rhodo_class bonded_grid {on} not taken")
        out[("rhodo", on)] = list(script.sim.thermo_rows)
        del script
        torch.cuda.empty_cache()
    bad = rows_gaps("rhodo_class f64 bonded_grid on", out[("rhodo", True)],
                    out[("rhodo", False)], ("temp", "epair", "emol",
                                            "etotal", "press", "vol"), 1e-10)
    script = rhodo_setup("2 2 4", "cuda", torch.float32)
    script.sim.neighbor_mode = "cellgrid"
    script.run_string("run 0")
    bad += gate_failures(script.sim.last_thermo, {
        k: (v, STEP0_RTOL) for k, v in RHODO_STEP0.items()})
    script.run_string("run 100")
    bad += gate_failures(script.sim.last_thermo, RHODO_STEP100)
    out["rhodo_f32"] = list(script.sim.thermo_rows)
    t0 = script.sim.loop_time
    script.run_string(f"run {THERMO_TIMED}")
    out["sps"] = THERMO_TIMED / (script.sim.loop_time - t0)
    out["f32"] = script
    for which in LJ_THERMOSTATS:
        lj = LammpsScript(device="cuda", dtype=torch.float64)
        lj.run_string(lj32k_thermostat(which))
        lj.sim.verbose = False
        lj.run_string(f"run {THERMO_STEPS}")
        rngs = [fx.rng for fx in lj.sim.fixes if hasattr(fx, "rng")]
        if which == "langevin" and rngs != ["device"]:
            raise AssertionError(f"langevin rng on the card: {rngs}")
        out[which] = list(lj.sim.thermo_rows)
        if which == "nvt":
            out["nvt_script"] = lj
    if bad:
        raise AssertionError("thermostat_one_card: " + "; ".join(bad))
    phase("decomp", f"rhodo_class on one card ({smi}): f64 bonded_grid on "
                    f"(SHAKE's clusters of 2, 3 and 4 atoms and the water "
                    f"angles matched by tag) = off to 1e-10 at steps "
                    f"{[r['step'] for r in out[('rhodo', True)]]}; f32 step "
                    f"0 and step 100 pass the reference binary's gates "
                    f"(etotal {out['rhodo_f32'][-1]['etotal']!r} at 100), "
                    f"{THERMO_TIMED} steps timed after: {out['sps']:.2f} "
                    f"timesteps/s")
    return out


def thermostat_local_kernels(script, nprocs: int, smi: str) -> dict:
    """At rhodo_class's f32 state (one card, the step-0 and step-100 runs
    and the timed steps behind it), rank 0's local grid of the layout that
    nprocs ranks take (``processor_grid``; on one card the whole grid,
    every slot owned): its list built by the kernel (the split axes not
    periodic), B5-rows over it against its plain version on the same local
    inputs (TOL_LIST), timed beside its bound, and the build
    (time_build).  Returns the kernels line's figures."""
    from tpumd_torch.ops.cellgrid_pairlist import cellgrid_pairlist
    from tpumd_torch.ops.charmm_cellgrid import charmm_cellgrid, \
        charmm_rows_plain
    from tpumd_torch.parallel.decomp import GridLayout, assemble_slots, \
        processor_grid
    sim = script.sim
    s, neigh, _ = sim._carry
    cfg, K = sim._neigh_cfg, sim._ctx.pairlist_k
    lay = GridLayout(cfg, *processor_grid(cfg.nz, cfg.ny, nprocs), 0)
    lc = lay.local_cfg
    sl, vl = assemble_slots(lay, s, neigh.valid)
    own = torch.as_tensor(lay.slot_maps[2], device=s.x.device)
    owned = vl & own
    rows = torch.nonzero(owned).reshape(-1)
    lbox = lay.list_box(s.box)
    pairs, npairs, _, over = cellgrid_pairlist(
        sl.x, vl, sl.tag, sl.special_tags, sl.special_codes, lbox, lc, K)
    if bool(over):
        raise AssertionError(f"rhodo_class local list overflow at K {K}")
    c = sim.pair.kernel_coeffs(s.x, *sim._special_weights())
    largs = (sl.x, sl.q, sl.type, pairs, npairs, s.box, lc, c)
    what = f"rhodo_class {lay.pz}x{lay.py} rank 0 f32 B5-rows"
    f = charmm_cellgrid(*largs, 0, 0, rows=rows)[0]
    fp = charmm_rows_plain(*largs[:6], c, 0, 0, rows)[0]
    err, rel = plain_gap(what, f, fp, rows, TOL_LIST[torch.float32])
    if bool(f[~owned].any()):
        raise AssertionError(f"{what}: forces off the rows")
    ms = min(cuda_ms(lambda: charmm_cellgrid(*largs, 0, 0, rows=rows), 100)
             for _ in range(2))
    plain_ms = cuda_ms(lambda: charmm_rows_plain(*largs[:6], c, 0, 0, rows),
                       3, ahead=False)
    live = torch.where(owned, npairs, 0)
    ncoul, nlj, nsw, nall = list_charmm_counts(sl.x, s.box, pairs, live, c)
    nbytes = lc.capacity * (12 + 4 + 4) + rows.numel() * 12 \
        + c.lj.numel() * 4 + 12
    ops = (nall * OPS_CHARMM_PAIR + ncoul * OPS_CHARMM_COUL
           + nlj * OPS_CHARMM_LJ + nsw * OPS_CHARMM_SWITCH)
    b_ms, b_by = roof(ops, nbytes)
    phase("kernel", f"charmm_cellgrid B5-rows on rhodo_class's {lay.pz}x"
                    f"{lay.py} local grid (rank 0 of {nprocs}: {lc.nx}x"
                    f"{lc.ny}x{lc.nz} cap {lc.cap}, {rows.numel()} owned "
                    f"atoms), f32 forces at step {sim.step} ({smi}): "
                    f"{rel:.3g} of max|f| from the plain version on the "
                    f"same local grid (tol {TOL_LIST[torch.float32]:g}); "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                    f"{b_ms:.6f} ms ({b_by}: {nall} pairs in range, {ncoul} "
                    f"in Coulomb range, {nbytes} bytes)")
    return {"b5": {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                   "bound_by": b_by, "max_abs_err": err},
            "build": time_build(
                f"rhodo_class {lay.pz}x{lay.py} local grid (rank 0)",
                (sl.x, vl, sl.tag, sl.special_tags, sl.special_codes, lbox,
                 lc, K), plain_reps=1)}


def thermostat_lj_b1(script, nprocs: int, smi: str) -> dict:
    """B1 in f64 at the in.lj 32k nvt deck's state after THERMO_STEPS
    steps on one card (script), on rank 0's local grid of the layout
    nprocs ranks take (``decomp_local``): against its plain list sweep on
    the same local inputs (TOL_LIST), timed beside its bound at the f64
    rate."""
    from tpumd_torch.ops.lj_cellgrid import lj_cellgrid, lj_pairlist_plain
    from tpumd_torch.parallel.decomp import GridLayout, processor_grid
    sim = script.sim
    s, neigh, _ = sim._carry
    cfg, K, c = sim._neigh_cfg, sim._ctx.pairlist_k, sim.pair.kernel_coeffs()
    lay = GridLayout(cfg, *processor_grid(cfg.nz, cfg.ny, nprocs), 0)
    sl, vl, owned, _, plist = decomp_local(lay, s, neigh.valid, K)
    lc = lay.local_cfg
    what = f"in.lj 32k nvt {lay.pz}x{lay.py} rank 0 f64 B1"
    f = lj_cellgrid(sl.x, owned, s.box, lc, c, 0, 0, plist)[0]
    fp = lj_pairlist_plain(sl.x, s.box, c, 0, 0, plist[0], plist[1],
                           rows=plist[2])[0]
    err, rel = plain_gap(what, f, fp, plist[2], TOL_LIST[torch.float64])
    ms = min(cuda_ms(lambda: lj_cellgrid(sl.x, owned, s.box, lc, c, 0, 0,
                                         plist), 100) for _ in range(2))
    plain_ms = cuda_ms(lambda: lj_pairlist_plain(
        sl.x, s.box, c, 0, 0, plist[0], plist[1], rows=plist[2]), 3,
        ahead=False)
    nlj = owned_pairs(sl.x, s.box, plist, c.cutsq)
    nbytes = lc.capacity * (24 + 1 + 24) + 24
    b_ms, b_by = bound(nlj, 0, nbytes, PEAK_F64_FLOPS)
    phase("kernel", f"lj_cellgrid on in.lj 32k nvt's {lay.pz}x{lay.py} local"
                    f" grid (rank 0 of {nprocs}: {lc.nx}x{lc.ny}x{lc.nz} cap "
                    f"{lc.cap}, {plist[2].numel()} owned atoms), f64 forces "
                    f"at step {THERMO_STEPS} ({smi}): {rel:.3g} of max|f| "
                    f"from the plain list sweep (tol "
                    f"{TOL_LIST[torch.float64]:g}); kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by} at the "
                    f"f64 rate: {nlj} pairs, {nbytes} bytes)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": err}


def thermostat_decomposed(tmp: Path, smi: str, one: dict) -> dict:
    """P = min(4, the card count) workers over NCCL, one card each:
    rhodo_class (fix npt z, SHAKE m 1.0 a 31 on the tag-matched path) in
    f64 THERMO_STEPS steps and in f32 (step 0, step 100, THERMO_TIMED timed
    steps, THERMO_STEADY counted ones), the in.lj 32k decks under fix nvt
    and under fix nve + langevin (the "device" stream, drawn by tag) in
    f64.  The f64 rows equal one card's to 1e-10; the f32 rows pass the
    step-0 and step-100 gates; SHAKE's residuals at step 100 under its
    tolerance; B5-rows (B1) launches = force evaluations, no plain call;
    between output steps no all-gather; timesteps/s beside one card's."""
    from tpumd_torch.bench_targets import RHODO_STEP0, RHODO_STEP100, \
        STEP0_RTOL, gate_failures
    from tpumd_torch.parallel.launch import run_decks, spawn_world
    nprocs = min(4, torch.cuda.device_count())
    specs = [{"setup": rhodo_deck(10), "dtype": "f64", "mode": "cellgrid",
              "runs": [f"run {THERMO_STEPS}"]},
             {"setup": rhodo_deck(), "dtype": "f32", "mode": "cellgrid",
              "runs": ["run 0", "run 100"], "timed": THERMO_TIMED,
              "steady": THERMO_STEADY},
             *[{"setup": lj32k_thermostat(w), "dtype": "f64",
                "runs": [f"run {THERMO_STEPS}"]} for w in LJ_THERMOSTATS]]
    t0 = time.perf_counter()
    ranks = spawn_world(run_decks, nprocs, "nccl", tmp / "pg_thermostat",
                        (specs,), timeout=600)
    wall = time.perf_counter() - t0
    fx = one["f32"].sim.shake_fixes()[0]
    keys = ("temp", "epair", "etotal", "press")
    evals64 = 1 + force_evals(THERMO_STEPS, 10)
    evals32 = 1 + force_evals(100, 0)
    bad = []
    for rank, (r64, r32, nvt, lang) in enumerate(ranks):
        bad += rows_gaps(f"rank {rank} rhodo_class f64", r64["rows"],
                         one[("rhodo", False)], keys + ("vol",), 1e-10)
        bad += rows_gaps(f"rank {rank} in.lj 32k nvt f64", nvt["rows"],
                         one["nvt"], keys, 1e-10)
        bad += rows_gaps(f"rank {rank} in.lj 32k langevin f64",
                         lang["rows"], one["langevin"], keys, 1e-10)
        bad += gate_failures(r32["rows"][0], {
            k: (v, STEP0_RTOL) for k, v in RHODO_STEP0.items()})
        bad += gate_failures(r32["rows"][-1], RHODO_STEP100)
        bond, angle = shake_residuals(fx, torch.as_tensor(r32["x"]),
                                      torch.as_tensor(r32["box"]))
        if not (bond < 1e-4 and angle < 1e-4):
            bad.append(f"rank {rank} SHAKE residuals {bond}, {angle}")
        for name, r, evals in (("f64", r64, evals64), ("f32", r32, evals32)):
            if r["counts"]["b5"] != (evals, evals, 0):
                bad.append(f"rank {rank} rhodo_class {name} B5 "
                           f"{r['counts']['b5']} (force evaluations "
                           f"{evals})")
        if r32["timed"]["counts"]["b5"] != (THERMO_TIMED + 1,) * 2 + (0,):
            bad.append(f"rank {rank} timed B5 {r32['timed']['counts']['b5']}")
        for name, r in (("nvt", nvt), ("langevin", lang)):
            if r["counts"]["b1"] != (evals64, 0):
                bad.append(f"rank {rank} in.lj {name} B1 {r['counts']['b1']}"
                           f" (force evaluations {evals64})")
        st = r32["steady"]
        if st["calls"]["all_gather"]:
            bad.append(f"rank {rank}: an all-gather between output steps "
                       f"{st['calls']}")
        ranks[rank] = (r64, r32, nvt, lang, bond, angle)
    if bad:
        raise AssertionError("decomp_thermostat_path: " + "; ".join(bad))
    if nprocs == 1:
        phase("decomp", "1 card: a world of one over NCCL (the decomposed "
                        "path: the tag-matched bonded styles and SHAKE, "
                        "B5-rows, the fixes' all-reduces), no axis split; "
                        "the exchange is held on the CPU by the gloo tests")
    for rank, (r64, r32, nvt, lang, bond, angle) in enumerate(ranks):
        t, st = r32["timed"], r32["steady"]
        sps = t["steps"] / t["seconds"]
        per = {k: v / THERMO_STEADY for k, v in st["calls"].items()}
        per_bytes = {k: v / THERMO_STEADY for k, v in st["bytes"].items()}
        phase("decomp", f"rhodo_class rank {rank} of {nprocs} over NCCL "
                        f"({smi}; world {wall:.1f} s with its start), "
                        f"{r32['layout']}: f64 rows at steps "
                        f"{[r['step'] for r in r64['rows']]} = one card's "
                        f"to 1e-10; f32 step 0 etotal "
                        f"{r32['rows'][0]['etotal']!r}, step 100 "
                        f"{r32['rows'][-1]['etotal']!r} (lz "
                        f"{r32['rows'][-1]['lz']!r}) pass the gates; SHAKE "
                        f"residuals at step 100 {bond:.3g} (bonds), "
                        f"{angle:.3g} (the angle's 1-2); timed "
                        f"{THERMO_TIMED} steps {sps:.2f} timesteps/s (one "
                        f"card {one['sps']:.2f} in this call); collectives a "
                        f"step between output steps {per}, bytes a step "
                        f"{per_bytes}; exchange {t['exchange_ms'] / t['steps']:.4f} ms a "
                        f"step; B5-rows {r64['counts']['b5'][1]} + "
                        f"{r32['counts']['b5'][1]} + {t['counts']['b5'][1]} "
                        f"launches = force evaluations; in.lj 32k nvt and "
                        f"langevin (device stream) f64 rows = one card's to "
                        f"1e-10, B1 {nvt['counts']['b1'][0]} + "
                        f"{lang['counts']['b1'][0]}")
    r64, r32, nvt, lang = ranks[0][:4]
    runs = (r64, r32, r32["timed"], nvt, lang)
    return {"b5": sum(r["counts"]["b5"][1] for r in runs[:3]),
            "b1": nvt["counts"]["b1"][0] + lang["counts"]["b1"][0],
            "build": sum(r["counts"]["build"][0] for r in runs),
            "gates": sum(r["counts"]["refresh"][0] for r in runs),
            "refreshes": sum(r["refreshes"] for r in (r64, r32, nvt, lang)),
            "nprocs": nprocs}


def decomp_thermostat_path(smi: str) -> tuple[dict, dict]:
    """The thermostats and barostats decomposed (ROADMAP item 14d): one
    card's runs (``thermostat_one_card``), the kernels at the local grids
    the run lays out (``thermostat_local_kernels``, ``thermostat_lj_b1``),
    then the decomposed runs (``thermostat_decomposed``).  Returns (the
    kernels' figures, the launches of the decomposed runs)."""
    t0 = time.perf_counter()
    nprocs = min(4, torch.cuda.device_count())
    one = thermostat_one_card(smi)
    k = thermostat_local_kernels(one["f32"], nprocs, smi)
    k["upkeep"] = time_upkeep("decomp_thermostat rhodo_class",
                              one["f32"].sim, build=False)
    k["b1"] = thermostat_lj_b1(one.pop("nvt_script"), nprocs, smi)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmpdir:
        m = thermostat_decomposed(Path(tmpdir), smi, one)
    del one
    torch.cuda.empty_cache()
    phase("decomp", f"decomp_thermostat_path {time.perf_counter() - t0:.1f}"
                    " s")
    return k, m


def main():
    t_start = time.perf_counter()
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
        analysis_goldens_phase()
        m_an = analysis_path(smi, m_lj["sps"])
        m_864 = script_lj864_path(smi)
        script_cli_phase(tmp)
        drift_phase()
        small_chain_card_vs_cpu(tmp)
        m_fene = chain_main_path(tmp, smi)
        k_rho, k_force = eam_kernels_vs_plain(tmp)
        small_eam_card_vs_cpu(tmp)
        m_rho, m_force, m_eam_list = eam_main_path(tmp, smi)
    k_charmm, k_list = charmm_kernel_vs_plain(log)
    small_rhodo_card_vs_cpu()
    m_charmm = rhodo_main_path(smi)
    water_phase()
    tri_npt_phase()
    m_water = water30k_phase(smi)
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        k_gran = gran_kernel_vs_plain(tmp, log)
        small_chute_card_vs_cpu(tmp)
        m_gran = chute_main_path(tmp, smi)
        granular_goldens()
        k_hertz, m_hertz = granhertz32k_path(smi, log)
        pour20k_path(smi)
        k_gather = gather_kernel_vs_plain()
        small_matrix_card_vs_cpu(tmp)
        golden_matrix_decks()
        m_gather = matrix_main_path(tmp, smi, {"in.lj": m_lj["sps"],
                                               "chute": m_gran["sps"]})
    pair_goldens_phase()
    k_salt, m_salt = salt_path(smi)
    bonded_goldens_phase()
    k_hyb, m_hyb = hyb32k_path(smi)
    k_hgrid, m_hgrid = hyb32k_grid_path(smi, m_hyb)
    host_goldens_phase()
    m_min = min_path(smi)
    m_pb = pressber_path(smi)
    m_df = deform_path(smi)
    manybody_phase()
    k_sw, m_sw = sw32k_path(smi)
    k_ters, m_ters = tersoff32k_path(smi)
    k_eama, m_eama = eamalloy32k_path(smi)
    kspace_goldens_phase()
    k_tip4p, m_tip4p = tip4p30k_path(smi)
    k_dpd, m_dpd = dpd32k_path(smi)
    remainder_goldens_phase()
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        m_kappa = kappa32k_path(tmp, smi)
        k_bcr, m_bcr = bondcreate32k_path(tmp, smi)
        k_respa, m_respa = respa32k_path(tmp, smi)
        t_replica = time.perf_counter()
        replica_small_card_vs_cpu(tmp)
        m_temper = temper32k_path(smi)
        m_neb = neb32k_path(tmp, smi)
        m_prd = prd32k_path(smi)
        m_tad = tad32k_path(tmp, smi)
        m_hyper = hyper32k_path(smi)
        m_ext = external32k_path(smi)
        replica_s = time.perf_counter() - t_replica
    # B1 and the list build at the replica paths' final states (f64 for
    # neb32k and tad32k, f32 for the others), timed
    replicas = (("temper32k", m_temper), ("neb32k", m_neb),
                ("prd32k", m_prd), ("tad32k", m_tad), ("hyper32k", m_hyper),
                ("external32k", m_ext))
    for name, m in replicas:
        sim = m.pop("sim")
        # each path's B1 flags: the steps' forces only (temper, prd, hyper
        # and the API's melt), with the energy in the band's (neb, and
        # tad's quenches and band)
        m["b1"] = b1_at_state(name, sim, int(name in ("neb32k", "tad32k")),
                              0)
        m["build"] = build_figures(name, sim)
    del sim
    torch.cuda.empty_cache()
    phase("replica", f"the replica and library phases {replica_s:.1f} s")
    t_parallel = time.perf_counter()
    k_bal, m_bal = balance32k_phase()
    rk_split_phase(smi)
    ellipsoid_card_vs_cpu()
    phase("parallel", f"the parallel and ellipsoid phases "
                      f"{time.perf_counter() - t_parallel:.1f} s")
    k_dec, m_dec = decomp_path(smi, m_864)
    k_mol, m_mol = decomp_molecular_path(smi)
    k_th, m_th = decomp_thermostat_path(smi)
    m_th["upkeep"] = k_th["upkeep"]
    # the list kernels' launches on the main paths: builds at set-up and
    # re-bins, and refresh calls, most of which pass the gate and return
    # (those that rebuild are the refreshes taken); an entry each
    list_src = "tpumd_torch/csrc/cellgrid_pairlist.cu"
    builds = [("rhodo_class", k_list, m_charmm["build_launches"]),
              *[(name, m["build"], m["build_launches"])
                for name, m in m_water.items()],
              ("chain", k_fene["list"], m_fene["build_launches"]),
              ("chute", k_gran["list"], m_gran["build_launches"]),
              ("in.lj", m_lj["upkeep"]["build"], m_lj["build_launches"]),
              ("analysis32k", m_an["k_build"], m_an["build_launches"]),
              ("eam", m_eam_list["upkeep"]["build"],
               m_eam_list["build_launches"]),
              *[(name, m["build"], m["build_launches"])
                for name, m in (("min32k", m_min), ("pressber32k", m_pb),
                                ("deform32k", m_df), ("kappa32k", m_kappa),
                                ("hyb32k_grid", m_hgrid), *replicas)],
              ("decomp", k_dec["build"], m_dec["build"]),
              ("decomp_molecular", k_mol["build"], m_mol["build"]),
              ("decomp_thermostat", k_th["build"], m_th["build"])]
    searched = {"in.lj": "tpumd/ops/pallas_lj.py:25",
                "analysis32k": "tpumd/ops/pallas_lj.py:25",
                "chain": "tpumd/ops/pallas_lj.py:146",
                "eam": "tpumd/ops/pallas_eam.py:128",
                "min32k": "tpumd/ops/pallas_lj.py:25",
                "pressber32k": "tpumd/ops/pallas_lj.py:25",
                "deform32k": "tpumd/ops/pallas_lj.py:25",
                "kappa32k": "tpumd/ops/pallas_lj.py:25",
                "hyb32k_grid": "tpumd/ops/pallas_lj.py:25",
                **{name: "tpumd/ops/pallas_lj.py:25" for name, _ in replicas},
                "rhodo_class": "tpumd/ops/pallas_charmm.py:43",
                "water_npt30k": "tpumd/ops/pallas_charmm.py:43",
                "rigid_npt30k": "tpumd/ops/pallas_charmm.py:43",
                "chute": "tpumd/ops/pallas_gran.py:42",
                "decomp": "tpumd/ops/pallas_lj.py:25",
                "decomp_molecular": "tpumd/ops/pallas_charmm.py:43",
                "decomp_thermostat": "tpumd/ops/pallas_charmm.py:43"}
    upkeep = [(f"cellgrid_pairlist build {name}", list_src, searched[name],
               k, {"launches": nb}) for name, k, nb in builds]
    calls = list(builds)
    for name, m in (("in.lj", m_lj), ("eam", m_eam_list),
                    ("rhodo_class", m_charmm), ("min32k", m_min),
                    ("deform32k", m_df), ("kappa32k", m_kappa),
                    ("hyb32k_grid", m_hgrid), ("decomp_thermostat", m_th)):
        if "upkeep" not in m:
            continue
        u = m["upkeep"]
        shapes = [(f"{name} gate", u["gate"], m["gates"] - m["refreshes"])]
        if m["refreshes"]:
            shapes.append((f"{name} refresh", u["refresh"], m["refreshes"]))
        calls += shapes
        upkeep.append((f"cellgrid_pairlist refresh {name}", list_src,
                       searched[name],
                       build_entry(shapes, f"{name}'s refresh calls"),
                       {"launches": m["gates"]}))
    build_entry(calls, "the main paths' builds and refresh calls")
    kernels = []
    eam_src = "tpumd_torch/csrc/eam_cellgrid.cu"
    for name, src, replaces, k, m in (
            ("lj_cellgrid", "tpumd_torch/csrc/lj_fene_cellgrid.cu",
             "tpumd/ops/pallas_lj.py:25", k_lj, m_lj),
            ("lj_cellgrid analysis32k", "tpumd_torch/csrc/lj_fene_cellgrid.cu",
             "tpumd/ops/pallas_lj.py:25", k_lj, m_an),
            *[(f"lj_cellgrid {name}", "tpumd_torch/csrc/lj_fene_cellgrid.cu",
               "tpumd/ops/pallas_lj.py:25", m["b1"], m)
              for name, m in (("min32k", m_min), ("pressber32k", m_pb),
                              ("deform32k", m_df), ("kappa32k", m_kappa),
                              *replicas)],
            ("lj_cellgrid special hyb32k",
             "tpumd_torch/csrc/lj_fene_cellgrid.cu",
             "tpumd/ops/pallas_lj.py:25", k_hgrid, m_hgrid),
            ("lj_fene_cellgrid", "tpumd_torch/csrc/lj_fene_cellgrid.cu",
             "tpumd/ops/pallas_lj.py:146", k_fene, m_fene),
            ("eam_rho_cellgrid", eam_src, "tpumd/ops/pallas_eam.py:99",
             k_rho, m_rho),
            ("eam_force_cellgrid", eam_src, "tpumd/ops/pallas_eam.py:128",
             k_force, m_force),
            ("lj_cellgrid decomp", "tpumd_torch/csrc/lj_fene_cellgrid.cu",
             "tpumd/ops/pallas_lj.py:25", k_dec["b1"],
             {"launches": m_dec["b1"]}),
            ("eam_rho_cellgrid decomp", eam_src,
             "tpumd/ops/pallas_eam.py:99", k_dec["rho"],
             {"launches": m_dec["rho"]}),
            ("eam_force_cellgrid decomp", eam_src,
             "tpumd/ops/pallas_eam.py:128", k_dec["force"],
             {"launches": m_dec["force"]}),
            ("charmm_cellgrid", "tpumd_torch/csrc/charmm_cellgrid.cu",
             "tpumd/ops/pallas_charmm.py:43", k_charmm, m_charmm),
            *[(f"charmm_cellgrid {name}",
               "tpumd_torch/csrc/charmm_cellgrid.cu",
               "tpumd/ops/pallas_charmm.py:43", m["b5"], m)
              for name, m in m_water.items()],
            ("charmm_cellgrid rows decomp_molecular",
             "tpumd_torch/csrc/charmm_cellgrid.cu",
             "tpumd/ops/pallas_charmm.py:43", k_mol["b5"],
             {"launches": m_mol["b5"]}),
            ("charmm_cellgrid rows decomp_thermostat",
             "tpumd_torch/csrc/charmm_cellgrid.cu",
             "tpumd/ops/pallas_charmm.py:43", k_th["b5"],
             {"launches": m_th["b5"]}),
            ("lj_cellgrid decomp_thermostat",
             "tpumd_torch/csrc/lj_fene_cellgrid.cu",
             "tpumd/ops/pallas_lj.py:25", k_th["b1"],
             {"launches": m_th["b1"]}),
            *upkeep,
            ("gran_cellgrid", "tpumd_torch/csrc/gran_cellgrid.cu",
             "tpumd/ops/pallas_gran.py:42", k_gran, m_gran),
            ("gran_cellgrid HERTZ", "tpumd_torch/csrc/gran_cellgrid.cu",
             "tpumd/ops/pallas_gran.py:42", k_hertz, m_hertz),
            ("row_gather", "tpumd_torch/csrc/row_gather.cu",
             "tools/probes/gather_probe.py:37", k_gather, m_gather),
            ("row_gather salt32k", "tpumd_torch/csrc/row_gather.cu",
             "tools/probes/gather_probe.py:37", k_salt, m_salt),
            ("row_gather hyb32k", "tpumd_torch/csrc/row_gather.cu",
             "tools/probes/gather_probe.py:37", k_hyb, m_hyb),
            ("row_gather balance32k", "tpumd_torch/csrc/row_gather.cu",
             "tools/probes/gather_probe.py:37", k_bal, m_bal),
            ("row_gather decomp", "tpumd_torch/csrc/row_gather.cu",
             "tools/probes/gather_probe.py:37", k_dec["p1"],
             {"launches": m_dec["p1"]}),
            *[(f"row_gather {name}", "tpumd_torch/csrc/row_gather.cu",
               "tools/probes/gather_probe.py:37", k, m)
              for name, k, m in (("sw32k", k_sw, m_sw),
                                 ("tersoff32k", k_ters, m_ters),
                                 ("eamalloy32k", k_eama, m_eama),
                                 ("tip4p30k", k_tip4p, m_tip4p),
                                 ("dpd32k", k_dpd, m_dpd),
                                 ("bondcreate32k", k_bcr, m_bcr),
                                 ("respa32k", k_respa, m_respa))]):
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": m["launches"],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            "library_ms": k.get("library_ms"),
            # the decomposed path's local grids: their gap from the global
            # launch (of max|f|) and the global launch's ms in this call
            **{key: k[key] for key in ("global_gap", "global_ms")
               if key in k}})
    phase("time", f"chip_smoke {time.perf_counter() - t_start:.1f} s, the "
                  "build included")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

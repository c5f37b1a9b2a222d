"""Parallel tempering: the temper command (src/REPLICA/temper.cpp).

The port of tpumd/md/temper.py.  R replicas run the same deck at the
thermostat targets of a world variable, each its own ``Simulation`` on the
one device.  Every ``nevery`` steps the replicas run their window in turn,
and a Metropolis sweep over adjacent pairs (alternating parity, drawn from
RanPark) decides the swaps: boltz_factor = (pe_lo - pe_hi) *
(1/(kB T_lo) - 1/(kB T_hi)).  An accepted swap exchanges the
configurations: each replica's state and its neighbour structure move
together, v scaled by sqrt(T_new/T_old); the thermostat's fix state stays
with its replica, which is the reference's swap of the thermostat targets
seen from the other side.  Where the two replicas' neighbour configs differ
(a regrow in one of them), both re-bin at the swap, so that no replica ever
sweeps a list built for another configuration.

tpumd stacks the replicas on a lane axis for one ``vmap`` (an XLA device
program); the port runs them one after another, which its own test shows
gives the same decisions (tests/test_temper.py).
"""

from __future__ import annotations

import time

import numpy as np

from tpumd_torch.utils.ranpark import RanPark


def _same_structure(sim_a, sim_b) -> bool:
    """Whether the two replicas' neighbour structures fit each other's
    step context: the same config and the same pair-list width."""
    ca, cb = sim_a._ctx, sim_b._ctx
    return ca.neigh_cfg == cb.neigh_cfg and ca.pairlist_k == cb.pairlist_k


def swap_configurations(sim_a, sim_b, t_a, t_b):
    """Exchange the two replicas' configurations (state with its neighbour
    structure), the velocities rescaled to the receiving temperature: v *
    sqrt(t_a/t_b) for the one moving to a, v / sqrt(t_a/t_b) for the other
    (the same two operations as tpumd's)."""
    sa, na, fa = sim_a._carry
    sb, nb_, fb = sim_b._carry
    fac = float(np.sqrt(t_a / t_b))
    sim_a._carry = (sb.replace(v=sb.v * fac), nb_, fa)
    sim_b._carry = (sa.replace(v=sa.v / fac), na, fb)
    rebin = not _same_structure(sim_a, sim_b)
    for sim in (sim_a, sim_b):
        if rebin:
            sim.rebin_grown(sim._carry)
        sim.state = sim._carry[0]
        sim._energies_of = None


def _metropolis(pes, temps, ranboltz, boltz, which_parity, do_swap):
    """One sweep over the adjacent pairs of the given parity; the Boltzmann
    draw only where bf < 0, as the reference short-circuits it.  Returns
    (accepted, attempted)."""
    nacc = natt = 0
    for lo in range(which_parity, len(pes) - 1, 2):
        hi = lo + 1
        natt += 1
        bf = (pes[lo] - pes[hi]) * (1.0 / (boltz * temps[lo])
                                    - 1.0 / (boltz * temps[hi]))
        if bf >= 0.0 or ranboltz.uniform() < np.exp(bf):
            do_swap(lo, hi)
            nacc += 1
    return nacc, natt


def temper(sims, temps, nsteps: int, nevery: int, seed_swap: int,
           seed_boltz: int, boltz: float, log=print, stats=None):
    """Run parallel tempering over the replicas ``sims`` at ``temps``;
    returns the (accepted, attempted) swaps of each window.  ``stats``, a
    dict where given, gets the host seconds of the swap decisions and
    exchanges (``swap_s``) and the windows' count."""
    for sim in sims:
        if sim._ctx is None:
            sim.setup()
    ranswap = RanPark(seed_swap)
    ranboltz = RanPark(seed_boltz)
    accepts = []
    swap_s = 0.0
    for w in range(1, nsteps // nevery + 1):
        for sim in sims:
            sim.run(nevery)
        t0 = time.perf_counter()
        pes = [sim.last_thermo["pe"] * (sim.natoms if sim.thermo_norm else 1)
               for sim in sims]
        which = int(ranswap.uniform() < 0.5)
        nacc, natt = _metropolis(
            pes, temps, ranboltz, boltz, which,
            lambda lo, hi: swap_configurations(
                sims[lo], sims[hi], temps[lo], temps[hi]))
        swap_s += time.perf_counter() - t0
        accepts.append((nacc, natt))
        log(f"temper window {w}: {nacc}/{natt} swaps accepted, "
            f"pe = {[round(p, 3) for p in pes]}")
    if stats is not None:
        stats.update(swap_s=swap_s, windows=len(accepts))
    return accepts

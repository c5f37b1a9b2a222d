"""Thermo gates of the benchmark decks.

The in.lj gates are copied from tools/bench_all.py (which imports jax) so
that the port's chip check needs no JAX.  The chain deck's published data
file is not in the repository, so ``chain_data`` makes a system of its
published size and density from a seed, and its gates are tpumd's own
results on that system.
"""

import numpy as np

# tools/bench_all.py:70 -- step-0 rows hold to |value - target| <
# STEP0_RTOL * |target|
STEP0_RTOL = 1e-4

# tools/bench_all.py:72 -- step-0 row of the reference log of in.lj
STEP0 = {
    "lj": {"temp": 1.44, "epair": -6.7733681, "etotal": -4.6134356},
}

# tools/bench_all.py:85-86 -- step-100 row of the reference log of in.lj:
# {key: (target, relative tolerance)}
SANITY = {
    "lj": {"temp": (0.7574531, 3e-3), "epair": (-5.7585055, 1e-3),
           "etotal": (-4.6223613, 1e-3)},
}

# tools/bench_all.py:37-51 -- in.lj with a region of {n}^3 fcc cells
# (n = 20: 32,000 atoms)
IN_LJ = """
units           lj
atom_style      atomic
lattice         fcc 0.8442
region          box block 0 {n} 0 {n} 0 {n}
create_box      1 box
create_atoms    1 box
mass            1 1.0
velocity        all create 1.44 87287 loop geom
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
neigh_modify    delay 0 every 20 check no
fix             1 all nve
"""


# LAMMPS bench/in.chain (tests/test_replicate.py:10-26 plus its thermostat
# and output lines); {data} is the data file, made by chain_data below
IN_CHAIN = """
units           lj
atom_style      bond
special_bonds   fene
read_data       {data}
neighbor        0.4 bin
neigh_modify    every 1 delay 1
bond_style      fene
bond_coeff      1 30.0 1.5 1.0 1.0
pair_style      lj/cut 1.12
pair_modify     shift yes
pair_coeff      1 1 1.0 1.0 1.12
fix             1 all nve
fix             2 all langevin 1.0 1.0 10.0 904297
thermo          100
timestep        0.012
"""

# Targets of IN_CHAIN on chain_data() at its defaults (32,000 atoms, seed
# 2026), computed by tpumd on the CPU in float64 with the cell grid forced
# and the bit-exact RanMars langevin stream
# (tests/test_torch_chain_slice.py::test_chain_targets_from_tpumd
# regenerates them).  Step 0 holds to STEP0_RTOL; step 100 to the ensemble
# tolerances of tools/bench_all.py:87-88, set there for a device RNG
# against a serial stream.
CHAIN_STEP0 = {"temp": 0.9700000000000001, "epair": 0.20955607799061018,
               "emol": 20.49308653720123, "etotal": 22.157597146441844,
               "press": -2.5156896680788488}
CHAIN_SANITY = {"temp": (0.9108331706758678, 2e-2),
                "emol": (20.4285124075559, 5e-3),
                "etotal": (22.216617784609813, 5e-3)}

# the serpentine lattice's spacing across the chains' rows: near the
# FENE+WCA bond length, and inside R0 = 1.5
_ROW_SPACING = 1.084


def chain_data(path, natoms: int = 32000, chain_len: int = 100,
               seed: int = 2026, density: float = 0.85,
               temp: float = 0.97, jitter: float = 0.02):
    """Write a LAMMPS data file (atom_style bond) of natoms // chain_len
    bead-spring chains of chain_len beads, one molecule ID per chain, one
    bond type, mass 1, at the reduced density of bench/data.chain in a
    cubic box.

    The beads follow one serpentine path through an nx * m * m lattice
    (m = round(L / 1.084), nx = ceil(natoms / m^2)), taking its first
    natoms sites, so every bond is one lattice step (L/nx along x, L/m
    across) and no two beads overlap; random walks would put beads of
    different chains on top of each other, whose WCA forces blow up at dt
    = 0.012.  Each bead is moved by up to +-jitter per axis.  Velocities
    are Gaussian with zero total momentum, scaled to temp over 3N - 3
    degrees of freedom.  Everything random comes from
    numpy.random.default_rng(seed).  Returns the box length."""
    if natoms % chain_len:
        raise ValueError(f"natoms {natoms} is not a multiple of chain_len "
                         f"{chain_len}")
    rng = np.random.default_rng(seed)
    L = (natoms / density) ** (1.0 / 3.0)
    m = max(1, round(L / _ROW_SPACING))
    nx = -(-natoms // (m * m))
    # serpentine order: z planes in turn, rows back and forth in y within
    # a plane, beads back and forth in x along a row
    rows = []
    for r in range(m * m):
        kz, jy = divmod(r, m)
        if kz % 2:
            jy = m - 1 - jy
        ix = np.arange(nx) if r % 2 == 0 else np.arange(nx - 1, -1, -1)
        rows.append(np.stack([ix, np.full(nx, jy), np.full(nx, kz)], 1))
    sites = np.concatenate(rows)[:natoms]
    spacing = np.array([L / nx, L / m, L / m])
    x = (sites + 0.5) * spacing + rng.uniform(-jitter, jitter, (natoms, 3))
    v = rng.normal(size=(natoms, 3))
    v -= v.mean(axis=0)
    v *= np.sqrt(temp * (3 * natoms - 3) / np.sum(v * v))
    tags = np.arange(1, natoms + 1)
    first = tags[tags % chain_len != 0]   # each bead but a chain's last
    nbonds = len(first)
    lines = [f"LAMMPS data file: {natoms // chain_len} FENE chains of "
             f"{chain_len} beads, seed {seed}", "",
             f"{natoms} atoms", f"{nbonds} bonds", "1 atom types",
             "1 bond types", ""]
    lines += [f"0.0 {L!r} {ax}lo {ax}hi" for ax in "xyz"]
    lines += ["", "Masses", "", "1 1.0", "", "Atoms", ""]
    lines += [f"{t} {(t - 1) // chain_len + 1} 1 {a!r} {b!r} {c!r}"
              for t, (a, b, c) in zip(tags, x.tolist())]
    lines += ["", "Velocities", ""]
    lines += [f"{t} {a!r} {b!r} {c!r}" for t, (a, b, c) in
              zip(tags, v.tolist())]
    lines += ["", "Bonds", ""]
    lines += [f"{n + 1} 1 {a} {a + 1}" for n, a in enumerate(first)]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return L


def gate_failures(vals: dict, targets: dict) -> list[str]:
    """Keys whose value misses its (target, rtol) gate."""
    return [f"{k}={vals[k]!r} vs {t!r} (rtol {r})"
            for k, (t, r) in targets.items()
            if not abs(vals[k] - t) < r * abs(t)]

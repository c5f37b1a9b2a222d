"""Thermo gates of the benchmark decks.

The in.lj gates are copied from tools/bench_all.py (which imports jax) so
that the port's chip check needs no JAX.  The chain deck's published data
file is not in the repository, so ``chain_data`` makes a system of its
published size and density from a seed, and its gates are tpumd's own
results on that system.  Likewise the eam deck's published potential
(Cu_u3.eam): ``eam_funcfl`` writes a Cu-like one from analytic functions.
The rhodo_class deck's inputs are in the repository (the peptide example),
and its gates are the reference binary's rows.  The chute deck's data file
is not in the repository either: ``chute_data`` writes a layered pack of
its published size from a seed, and its gates are tpumd's results there.
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


# LAMMPS bench/in.eam with its x/y/z index variables expanded: a region of
# {n}^3 fcc cells (n = 20: 32,000 atoms); {potential} is the potential file,
# written by eam_funcfl below because bench/Cu_u3.eam is not in the
# repository
IN_EAM = """
units           metal
atom_style      atomic
lattice         fcc 3.615
region          box block 0 {n} 0 {n} 0 {n}
create_box      1 box
create_atoms    1 box
pair_style      eam
pair_coeff      1 1 {potential}
velocity        all create 1600.0 376847 loop geom
neighbor        1.0 bin
neigh_modify    every 1 delay 5 check yes
fix             1 all nve
timestep        0.005
thermo          50
"""

# Targets of IN_EAM at n = 20 on eam_funcfl() at its defaults, computed by
# tpumd on the CPU in float64 on its matrix engine, the exact spline tables
# (tests/test_torch_eam_slice.py::test_eam_targets_from_tpumd regenerates
# them).  Step 0 holds to STEP0_RTOL; step 100 to the eam tolerances of
# tools/bench_all.py:89-90.
EAM_STEP0 = {"temp": 1599.9999999999998, "epair": -113280.00003086543,
             "etotal": -106662.08742309743, "press": 18703.582071837904}
EAM_SANITY = {"temp": (804.7411100430563, 1e-2),
              "epair": (-109971.35746949984, 1e-3),
              "etotal": (-106642.79100816036, 1e-3)}

# The generated potential: a Cu-like element at bench/in.eam's lattice
# constant, on the grid of the published Cu_u3.eam (500 r points at 0.01 A,
# cutoff 4.95 A).  rho(r) and phi(r) are the exponentials of Johnson's
# analytic EAM (Phys. Rev. B 37, 3924 (1988)), rho ~ exp(-beta (r/re - 1)),
# phi = phi_e exp(-gamma (r/re - 1)), with re the nearest-neighbour distance;
# each is tapered to zero value and zero slope at the cutoff by subtracting
# its tangent line there, so phi stays repulsive.  F(rho) is fixed by
# making the static fcc crystal follow Rose's universal binding curve (Phys.
# Rev. B 29, 2963 (1984)) for the cohesive energy and bulk modulus of Cu:
# E(a) = -Ec (1 + s) exp(-s), s = (a/a0 - 1) / sqrt(Ec / (9 B a0^3 / 4)), so
# fcc at a0 = 3.615 A sits at zero static pressure at -3.54 eV/atom.
EAM_A0 = 3.615
EAM_MASS = 63.55
_EAM_EC = 3.54                    # eV
_EAM_BULK = 142.0 / 160.21766208  # 142 GPa in eV/A^3
_EAM_BETA, _EAM_GAMMA, _EAM_PHIE = 5.85, 8.0, 0.59
# 27.2 * 0.529: the funcfl unit of Z^2 (Hartree Bohr) in eV A
_EAM_Z2 = 27.2 * 0.529


def _tapered_exp(r, amp, k, re, cut):
    """amp exp(-k (r - re)) minus its tangent line at the cutoff: zero
    value and zero slope at cut, and zero beyond."""
    ec = np.exp(-k * (cut - re))
    out = amp * (np.exp(-k * (r - re)) - ec * (1.0 - k * (r - cut)))
    return np.where(r < cut, out, 0.0)


def _eam_functions(cut):
    """(rho(r), phi(r), F(rho)) of the generated potential, vectorised."""
    re = EAM_A0 / np.sqrt(2.0)

    def phi(r):
        return _tapered_exp(r, _EAM_PHIE, _EAM_GAMMA / re, re, cut)

    def rho_raw(r):
        return _tapered_exp(r, 1.0, _EAM_BETA / re, re, cut)

    # fcc shells in units of a/2: sites (i, j, k) with i + j + k even, up
    # to where the densest lattice searched (a = 2 A) leaves the cutoff
    m = np.arange(-5, 6)
    n2 = (m[:, None, None] ** 2 + m[None, :, None] ** 2
          + m[None, None, :] ** 2)
    even = ((m[:, None, None] + m[None, :, None] + m[None, None, :]) % 2
            == 0) & (n2 > 0) & (n2 < 25)
    shell, mult = np.unique(n2[even], return_counts=True)
    shell_r = 0.5 * np.sqrt(shell)

    def lattice_sums(a, fn):
        return np.sum(mult * fn(np.multiply.outer(a, shell_r)), axis=-1)

    norm = lattice_sums(np.float64(EAM_A0), rho_raw)   # rho-bar(a0) = 1

    def rho(r):
        return rho_raw(r) / norm

    lam = np.sqrt(_EAM_EC / (9.0 * _EAM_BULK * EAM_A0 ** 3 / 4.0))

    def embed(rhobar):
        # the lattice constant whose host density is rhobar, by bisection
        # (rho-bar falls with a, and is 0 once a / sqrt(2) >= cut)
        lo = np.full_like(rhobar, 2.0)
        hi = np.full_like(rhobar, cut * np.sqrt(2.0))
        for _ in range(100):
            mid = 0.5 * (lo + hi)
            denser = lattice_sums(mid, rho) > rhobar
            lo, hi = np.where(denser, mid, lo), np.where(denser, hi, mid)
        a = 0.5 * (lo + hi)
        s = (a / EAM_A0 - 1.0) / lam
        return (-_EAM_EC * (1.0 + s) * np.exp(-s)
                - 0.5 * lattice_sums(a, phi))

    return rho, phi, embed


def _eam_tables(nrho, drho, nr, dr, cut):
    rho, phi, embed = _eam_functions(cut)
    r = np.arange(nr) * dr
    return embed(np.arange(nrho) * drho), rho(r), r * phi(r)


def _write_values(fh, vals):
    for k in range(0, len(vals), 5):
        fh.write(" ".join(f"{v:.16e}" for v in vals[k:k + 5]) + "\n")


def eam_funcfl(path, nrho: int = 500, drho: float = 0.005, nr: int = 500,
               dr: float = 0.01, cut: float = 4.95):
    """Write the generated Cu-like potential as a funcfl file (pair_style
    eam): the element line, the grid line, then F(rho) at rho = k drho,
    Z(r) and rho(r) at r = k dr, with r phi(r) = 27.2 * 0.529 Z(r)^2.
    The F grid reaches 2.5 times the host density of the fcc crystal."""
    frho, rhor, z2r = _eam_tables(nrho, drho, nr, dr, cut)
    with open(path, "w") as fh:
        fh.write("Cu-like analytic EAM: Johnson exponentials, Rose "
                 "universal binding curve\n")
        fh.write(f"29 {EAM_MASS} {EAM_A0} FCC\n")
        fh.write(f"{nrho} {drho!r} {nr} {dr!r} {cut!r}\n")
        for vals in (frho, np.sqrt(z2r / _EAM_Z2), rhor):
            _write_values(fh, vals)


def eam_setfl(path, nrho: int = 500, drho: float = 0.005, nr: int = 500,
              dr: float = 0.01, cut: float = 4.95, fs: bool = False):
    """Write the same potential as a one-element setfl file (pair_style
    eam/alloy, element Cu) or, with fs, an eam/fs file: three comment
    lines, the element line, the grid line, the element's line, F(rho),
    rho(r), then r phi(r).  With one element the two formats hold the same
    numbers."""
    frho, rhor, z2r = _eam_tables(nrho, drho, nr, dr, cut)
    kind = "eam/fs" if fs else "eam/alloy setfl"
    with open(path, "w") as fh:
        fh.write(f"Cu-like analytic EAM ({kind}): Johnson exponentials,\n"
                 "Rose universal binding curve\n\n")
        fh.write("1 Cu\n")
        fh.write(f"{nrho} {drho!r} {nr} {dr!r} {cut!r}\n")
        fh.write(f"29 {EAM_MASS} {EAM_A0} fcc\n")
        for vals in (frho, rhor, z2r):
            _write_values(fh, vals)


# tools/bench_all.py:108-125 -- the rhodo_class deck: LAMMPS's solvated
# peptide example (tests/golden/peptide/data.peptide; {golden} is that
# directory) replicated 2x2x4 into 32,064 atoms, with bench/in.rhodo's
# force stack: lj/charmm/coul/long 8/10, harmonic bonds, CHARMM angles and
# dihedrals (1-4 pairs), harmonic impropers, PPPM 1e-4, SHAKE of the
# hydrogen bonds and the water angle, z-coupled NPT
IN_RHODO_CLASS = """
units           real
neigh_modify    delay 5 every 1
atom_style      full
bond_style      harmonic
angle_style     charmm
dihedral_style  charmm
improper_style  harmonic
pair_style      lj/charmm/coul/long 8.0 10.0
pair_modify     mix arithmetic
kspace_style    pppm 1e-4
read_data       {golden}/data.peptide
replicate       2 2 4
fix             1 all shake 0.0001 5 0 m 1.0 a 31
fix             2 all npt temp 300.0 300.0 100.0 z 0.0 0.0 1000.0 mtk no pchain 0 tchain 1
special_bonds   charmm
timestep        2.0
"""

# tools/bench_all.py:80-81 -- the reference binary's step-0 row of
# IN_RHODO_CLASS (initial velocities come from the data file); hold to
# STEP0_RTOL
RHODO_STEP0 = {"temp": 281.9047, "epair": -103081.45, "etotal": -83796.488}
# tools/bench_all.py:94-95 -- its step-100 row, at the tolerances set there
# for f32 through the deck's first 100 steps of heating
RHODO_STEP100 = {"temp": (302.90763, 2e-2), "epair": (-100551.94, 1e-2),
                 "etotal": (-79735.321, 1e-2)}


# LAMMPS bench/in.chute, with {data} for the data file, made by chute_data
# below because bench/data.chute is not in the repository.  dampflag 0
# (the last pair_style argument) zeroes gammat.
IN_CHUTE = """
units           lj
atom_style      sphere
boundary        p p fs
newton          off
comm_modify     vel yes
read_data       {data}
pair_style      gran/hooke/history 2000.0 NULL 50.0 NULL 0.5 0
pair_coeff      * *
neighbor        0.1 bin
neigh_modify    every 1 delay 0
timestep        0.0001
group           bottom type 2
group           active subtract all bottom
neigh_modify    exclude group bottom bottom
fix             1 all gravity 1.0 chute 26.0
fix             2 bottom freeze
fix             3 active nve/sphere
compute         1 all erotate/sphere
thermo_style    custom step atoms ke c_1 vol
thermo          100
thermo_modify   norm no
"""

# chute_data's square grids have a spacing of 1.02 and its layers sit
# _CHUTE_LAYER apart, so each sphere of diameter 1 overlaps the four of the
# (0.51, 0.51)-offset layer below and the four above by _CHUTE_OVERLAP,
# and spheres of one layer start 0.02 apart.  At a spacing of exactly 1
# the in-layer gaps (~5e-5, from the z jitter alone) close within a few
# steps, and a sphere with 12 contacts fills tpumd's history rows (KH = 12),
# which tpumd reports as a cell overflow.
_CHUTE_SPACING = 1.02
_CHUTE_OVERLAP = 0.005
_CHUTE_LAYER = float(np.sqrt((1.0 - _CHUTE_OVERLAP) ** 2
                             - 0.5 * _CHUTE_SPACING ** 2))
# the downslope speed of the top layer: the shear profile's mean kinetic
# energy is then ~24 per sphere, near the published step-0 ke / 32,000
_CHUTE_U = 16.8
# the width of the Gaussian noise on each velocity and angular-velocity
# component, and the bound of each sphere's uniform z jitter; the chute
# targets below hold only at these values
_CHUTE_NOISE = 0.1
_CHUTE_JITTER = 0.01


def chute_data(path, nx: int = 40, ny: int = 20, layers: int = 40,
               seed: int = 2026):
    """Write a LAMMPS data file (atom_style sphere) of a layered granular
    pack on a frozen base: nx * ny * layers spheres of diameter 1 and
    density 1 in a box of x [0, 1.02 nx), y [0, 1.02 ny), z [0, zhi).

    Layer 0 is the base: type 2 on a square grid of spacing 1.02 at
    z = 0.5.  Layers 1 .. layers-1 are type 1 on the same grid, odd layers
    offset by (0.51, 0.51), at z = 0.5 + k h with h = 0.6854, so each
    sphere overlaps the four below it and the four above it by about
    0.005, and a sphere starts with at most 8 contacts.  Each sphere's z
    moves by up to +-0.01.  Type-1 spheres flow downslope with the shear
    profile v_x = 16.8 (z - 0.5) / ((layers - 1) h), plus Gaussian noise of
    width 0.1 on each velocity and angular-velocity component; the
    base is at rest.  Everything random comes from
    numpy.random.default_rng(seed).  zhi is 1 above the top layer (the
    deck shrink-wraps it).

    The published data.chute is a dilated flowing pack (packing fraction
    ~0.56 from its step-0 volume); this one is denser (~0.75), with more
    contacts per sphere.  Returns the number of spheres."""
    rng = np.random.default_rng(seed)
    a, h = _CHUTE_SPACING, _CHUTE_LAYER
    gx, gy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
    grid = a * np.stack([gx.ravel(), gy.ravel()], 1).astype(np.float64)
    xs, types = [], []
    for k in range(layers):
        off = a * (0.75 if k % 2 else 0.25)
        z = np.full((len(grid), 1), 0.5 + k * h)
        xs.append(np.concatenate([grid + off, z], 1))
        types.append(np.full(len(grid), 2 if k == 0 else 1))
    x = np.concatenate(xs)
    t = np.concatenate(types)
    n = len(x)
    x[:, 2] += rng.uniform(-_CHUTE_JITTER, _CHUTE_JITTER, n)
    v = rng.normal(0.0, _CHUTE_NOISE, (n, 3))
    w = rng.normal(0.0, _CHUTE_NOISE, (n, 3))
    v[:, 0] += _CHUTE_U * (x[:, 2] - 0.5) / ((layers - 1) * h)
    base = t == 2
    v[base] = 0.0
    w[base] = 0.0
    zhi = 0.5 + (layers - 1) * h + 1.0
    tags = np.arange(1, n + 1)
    lines = [f"LAMMPS data file: layered granular chute pack, "
             f"{nx}x{ny}x{layers} spheres, seed {seed}", "",
             f"{n} atoms", "2 atom types", "",
             f"0.0 {a * nx!r} xlo xhi", f"0.0 {a * ny!r} ylo yhi",
             f"0.0 {zhi!r} zlo zhi", "", "Atoms # sphere", ""]
    lines += [f"{i} {ty} 1.0 1.0 {p!r} {q!r} {r!r}"
              for i, ty, (p, q, r) in zip(tags, t.tolist(), x.tolist())]
    lines += ["", "Velocities", ""]
    lines += [f"{i} {p!r} {q!r} {r!r} {d!r} {e!r} {f!r}"
              for i, (p, q, r), (d, e, f) in zip(tags, v.tolist(),
                                                 w.tolist())]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return n

# Targets of IN_CHUTE on chute_data() at its defaults (32,000 spheres, seed
# 2026), computed by tpumd on the CPU in float64 with the cell grid forced
# (tests/test_torch_chute_slice.py::test_chute_targets_from_tpumd
# regenerates them; 3 rebuilds to step 100).  Step 0 holds to STEP0_RTOL.
# At step 100 ke holds to tools/bench_all.py:91's 1.5e-3, and c_1 and vol
# to three times the gap that the port's own f32 run on the CPU showed
# against these rows: c_1 130.8181610107422 (4.43e-6 relative), vol
# 22678.0546875 (2.73e-7).
GAP_C1, GAP_VOL = 4.43e-6, 2.73e-7
CHUTE_STEP0 = {"ke": 798534.4215513401, "c_1": 24.50185665372077,
               "vol": 22676.43431118536, "atoms": 32000}
CHUTE_STEP100 = {"ke": (798568.0653316998, 1.5e-3),
                 "c_1": (130.817581189062, 3 * GAP_C1),
                 "vol": (22678.04850514572, 3 * GAP_VOL),
                 "atoms": (32000, 1e-12)}


def gate_failures(vals: dict, targets: dict) -> list[str]:
    """Keys whose value misses its (target, rtol) gate."""
    return [f"{k}={vals[k]!r} vs {t!r} (rtol {r})"
            for k, (t, r) in targets.items()
            if not abs(vals[k] - t) < r * abs(t)]

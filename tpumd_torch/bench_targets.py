"""Thermo gates of the benchmark decks.

The in.lj and lj864 gates and the drift protocol are copied from
tools/bench_all.py (which imports jax) so that the port's chip check needs
no JAX; ``IN_LJ_BENCH`` is LAMMPS's bench/in.lj as published.  The chain
deck's published data file is not in the repository, so ``chain_data``
makes a system of its published size and density from a seed, and its
gates are tpumd's own results on that system.  Likewise the eam deck's published potential
(Cu_u3.eam): ``eam_funcfl`` writes a Cu-like one from analytic functions.
The rhodo_class deck's inputs are in the repository (the peptide example),
and its gates are the reference binary's rows.  So are the water decks'
(tests/golden/water_npt and rigid_npt_water, replicated 4x4x5): their
step-0 gates scale the reference binary's rows, and the port's own f64
rows on the CPU hold them tighter.  The chute deck's data file
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
    "lj864": {"temp": 1.44, "epair": -6.7733681, "etotal": -4.6133706},
}

# tools/bench_all.py:85-86,97-98 -- step-100 rows of the reference logs
# of in.lj and of the 864k melt: {key: (target, relative tolerance)}
SANITY = {
    "lj": {"temp": (0.7574531, 3e-3), "epair": (-5.7585055, 1e-3),
           "etotal": (-4.6223613, 1e-3)},
    "lj864": {"temp": (0.75926567, 3e-3), "epair": (-5.7611846, 1e-3),
              "etotal": (-4.6222874, 1e-3)},
}

# LAMMPS bench/in.lj, verbatim: x, y and z are index variables, so that
# -var x 3 -var y 3 -var z 3 makes the 864,000-atom melt (lj864) and the
# defaults the 32,000-atom one
IN_LJ_BENCH = """# 3d Lennard-Jones melt

variable\tx index 1
variable\ty index 1
variable\tz index 1

variable\txx equal 20*$x
variable\tyy equal 20*$y
variable\tzz equal 20*$z

units\t\tlj
atom_style\tatomic

lattice\t\tfcc 0.8442
region\t\tbox block 0 ${xx} 0 ${yy} 0 ${zz}
create_box\t1 box
create_atoms\t1 box
mass\t\t1 1.0

velocity\tall create 1.44 87287 loop geom

pair_style\tlj/cut 2.5
pair_coeff\t1 1 1.0 1.0 2.5

neighbor\t0.3 bin
neigh_modify\tdelay 0 every 20 check no

fix\t\t1 all nve

run\t\t100
"""

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


# in.lj with the analysis layer on (IN_LJ_ANALYSIS32K): the user watching
# the fcc start melt.  Per-atom energy and stress summed (the pe and press
# identities), msd and vacf averaged every 10 steps, rdf averaged into a
# file every 100, and a dump every 250 steps of pe/atom, coord/atom,
# cna/atom (cutoff 1.43 sigma = 0.854 a at rho* 0.8442, between fcc's
# first and second shells) and centro/atom.  {n} is in.lj's box (20: 32,000
# atoms), {steps} the run.
ANALYSIS_LINES = """compute         pea all pe/atom
compute         kea all ke/atom
compute         str all stress/atom NULL
compute         pesum all reduce sum c_pea
compute         ssum all reduce sum c_str[1] c_str[2] c_str[3]
compute         msd all msd
compute         vacf all vacf
compute         rdf all rdf 100
compute         crd all coord/atom cutoff 1.5
compute         cna all cna/atom 1.43
compute         cen all centro/atom fcc
fix             rdfav all ave/time 100 1 100 c_rdf[*] file rdf.lj32k mode vector
fix             msdav all ave/time 10 10 100 c_msd[4] c_vacf[4]
thermo          100
thermo_style    custom step temp epair press c_pesum c_ssum[1] c_ssum[2] c_ssum[3] c_msd[4] f_msdav[1]
dump            d all custom 250 dump.lj32k id c_pea c_crd c_cna c_cen
"""
IN_LJ_ANALYSIS32K = IN_LJ + ANALYSIS_LINES + "run             {steps}\n"


def analysis_identities(vals: dict, natoms: int) -> dict:
    """The analysis deck's two identities on a thermo row, as relative
    gaps: sum of pe/atom against thermo's pe, and -trace(sum of
    stress/atom)/(3V) against press.  lj units print the extensive reduce
    sums per atom (thermo_modify norm yes), so both are multiplied back by
    the atoms first."""
    pe = vals["epair"] * natoms
    press = -natoms * (vals["c_ssum[1]"] + vals["c_ssum[2]"]
                       + vals["c_ssum[3]"]) / (3.0 * vals["vol"])
    return {"pe": abs(vals["c_pesum"] * natoms - pe) / abs(pe),
            "press": abs(press - vals["press"]) / abs(vals["press"])}


# The drift deck: in.lj with pair_modify shift yes and timestep 0.001,
# run under the protocol of tools/bench_all.py:183-205 (measure_drift).
# Of the in.lj variants the re-anchor measured (ROADMAP A3), only this
# one holds BASELINE.md's 1e-6 in f64; its 1,000 steps cover 1 tau (in.lj's
# 1,000 steps cover 5).
IN_LJ_DRIFT = IN_LJ + """pair_modify     shift yes
timestep        0.001
"""
DRIFT_WARMUP, DRIFT_STEPS, DRIFT_EVERY = 500, 1000, 100
# BASELINE.md's target (f64), and tools/bench_all.py:200's bound for an
# accelerator's f32
DRIFT_TOL = {"f64": 1e-6, "f32": 2e-4}


def measure_drift(script) -> float:
    """max|E(t) - E0| / |E0| of etotal over DRIFT_STEPS steps, sampled
    every DRIFT_EVERY, after DRIFT_WARMUP steps (tools/bench_all.py:
    183-205); script is a LammpsScript that has read a deck with no
    run."""
    script.run_string(f"run {DRIFT_WARMUP}\nrun 0")
    e0 = float(script.sim.last_thermo["etotal"])
    emax = 0.0
    for _ in range(DRIFT_STEPS // DRIFT_EVERY):
        script.run_string(f"run {DRIFT_EVERY}")
        emax = max(emax, abs(float(script.sim.last_thermo["etotal"]) - e0))
    return emax / abs(e0)


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


# tests/golden/gran/in.granhertz with its geometry widened to a silo of
# 32,474 spheres (sc 0.9 lattice, spacing 1.0357; a fill cylinder of radius
# 20 lattice units, 1,249 sites a layer, layers 1-26), everything else as
# in the golden: velocity set, gran/hertz/history, nve/sphere, gravity 1
# down, a frictional zcylinder wall with the golden's margin over the
# fill's radius (0.857 box units; the golden's 5.0 against 4.0 lattice
# units), a zplane floor, skin 0.3 every step, dt 0.002, boundary f f f;
# the box is widened around and above.  The caller adds the run lines.
IN_GRANHERTZ32K = """
comm_modify     vel yes
units           lj
atom_style      sphere
boundary        f f f
region          box block -24 24 -24 24 0 36
create_box      1 box
lattice         sc 0.9
region          fill cylinder z 0 0 20.0 0.5 26.2
create_atoms    1 region fill
velocity        all set 0.6 -0.3 -1.0
pair_style      gran/hertz/history 2000.0 NULL 50.0 NULL 0.5 1
pair_coeff      * *
fix             1 all nve/sphere
fix             2 all gravity 1.0 vector 0 0 -1
fix             3 all wall/gran hertz/history 2000.0 NULL 50.0 NULL 0.5 1 zcylinder 21.57
fix             4 all wall/gran hertz/history 2000.0 NULL 50.0 NULL 0.5 1 zplane 0.0 NULL
neighbor        0.3 bin
neigh_modify    delay 0 every 1
compute         rot all erotate/sphere
timestep        0.002
thermo          100
thermo_style    custom step ke c_rot
thermo_modify   norm no
"""
GRANHERTZ32K_N = 32474


def granhertz32k_ke0(spacing: float = 0.9 ** (-1.0 / 3.0)) -> float:
    """Step-0 ke of IN_GRANHERTZ32K: every sphere (mass pi/6) at velocity
    set's vector in lattice units, (0.6, -0.3, -1.0) times the spacing."""
    v2 = (0.6 ** 2 + 0.3 ** 2 + 1.0 ** 2) * spacing ** 2
    return 0.5 * GRANHERTZ32K_N * (np.pi / 6.0) * v2


# tpumd's rows of IN_GRANHERTZ32K on the CPU in float64 (its matrix engine;
# tests/test_torch_granular_decks.py::test_granhertz32k_targets_from_tpumd
# regenerates them).  Step 100 is free flight (no sphere touches the floor
# or the wall until step ~240); contacts are live by step 500.
GRANHERTZ32K_TPUMD = {
    100: {"ke": 17086.73396386564, "c_rot": 0.0},
    500: {"ke": 27972.628932843916, "c_rot": 529.433720669162}}
# the relative gap of the port's own f64 run on the CPU to those rows (ke
# 17086.73396386567 and 27972.628932843938, c_rot 529.4337206691627); a
# card run in f64 holds to three times it, and to at least four ulps (the
# card sums in another order)
GRANHERTZ32K_GAP_F64 = {100: {"ke": 1.76e-15}, 500: {"ke": 7.8e-16,
                                                    "c_rot": 1.3e-15}}
# an f32 run against the f64 run at step 100 and 500 (relative): the port's
# own f32 run on the CPU sat at ke 1.16e-5 (step 100: free flight, the f32
# rounding of ~100 velocity-Verlet kicks) and 2.3e-5 (step 500), c_rot
# 1.1e-4 (step 500: contact forces amplify it); the gates are about four
# times those
GRANHERTZ32K_F32_F64 = {100: {"ke": 5e-5}, 500: {"ke": 1e-4,
                                                  "c_rot": 5e-4}}


def granhertz32k_gate(vals: dict, step: int, f64=None) -> list[str]:
    """The keys of a row of IN_GRANHERTZ32K that miss its gate: step 0
    against the analytic ke (rel 1e-12 in f64, STEP0_RTOL in f32) and c_rot
    0; with f64 (the f64 run's row) the f32 gates, else tpumd's row at
    three times the port's CPU gap."""
    if step == 0:
        rtol = 1e-12 if f64 is None else STEP0_RTOL
        want = {"ke": (granhertz32k_ke0(), rtol), "c_rot": (0.0, 0.0)}
    elif f64 is not None:
        want = {k: (f64[k], r) for k, r in GRANHERTZ32K_F32_F64[step].items()}
    else:
        want = {k: (t, 3.0 * max(GRANHERTZ32K_GAP_F64[step].get(k, 0.0),
                                 4 * 2.0 ** -52))
                for k, t in GRANHERTZ32K_TPUMD[step].items()}
    bad = []
    for k, (t, r) in want.items():
        if (t == 0.0 and vals[k] != 0.0) or (
                t != 0.0 and not abs(vals[k] - t) <= r * abs(t)):
            bad.append(f"{k}={vals[k]!r} vs {t!r} (rtol {r:.3g})")
    return bad


# tests/golden/gran/in.pour with the box, the floor and the insertion
# cylinder widened: a floor layer of 1,600 spheres (sc 1.0, 40 x 40), an
# insertion cylinder of radius 20 from z 10 to 30, fix pour 20000 with the
# golden's seed, coefficients and velocity (12,000 spheres an insertion at
# the default volume fraction 0.25, so two insertions), the box widened to
# +-30 around the cylinder so that spheres splashing off the floor stay
# inside its fixed faces.  As in the golden, the fix comes before the
# timestep command, so nfreq takes the default dt 0.005: 416 steps (the
# golden's 107).  The caller adds the run lines (POUR20K_STEPS: about 300
# steps past the second insertion).
IN_POUR20K = """
units           lj
atom_style      sphere
comm_modify     vel yes
boundary        f f f
region          box block -30 30 -30 30 0 32
create_box      1 box
lattice         sc 1.0
region          floor block -20 19.5 -20 19.5 0.9 1.1 units box
create_atoms    1 region floor
pair_style      gran/hooke/history 2000.0 NULL 50.0 NULL 0.5 1
pair_coeff      * *
region          ins cylinder z 0 0 20 10 30 units box
fix             g all gravity 10.0 vector 0 0 -1
fix             i all nve/sphere
fix             w all wall/gran hooke/history 2000.0 NULL 50.0 NULL 0.5 1 zplane 0.0 NULL
fix             p all pour 20000 1 123457 region ins diam one 1.0 vel 0 0 0 0 0.8
neighbor        0.3 bin
neigh_modify    delay 0 every 1
timestep        0.002
thermo          100
thermo_style    custom step atoms ke
thermo_modify   norm no
"""
POUR20K_STEPS = 720
# The atom count of each thermo row of IN_POUR20K: the 1,600 floor spheres,
# 4,869 inserted at the start and 4,774 at step 416 (fix pour draws a
# sphere's height first, biased to the top, and tries points at that height
# only, so its 50 attempts a sphere run out as the top fills: about 4,800
# an insertion, not 12,000).  From the port's run on the CPU in float64.
# tpumd's attempt loop tests each point against the near atoms one by one
# in Python, hours for these ~1.2 million attempts (ROADMAP C14), so the
# counts rest on the port's insertions equalling tpumd's bit for bit: on
# in.pour, where every attempt finds room (tests/test_torch_pour.py), and
# on a crowded pour whose insertion runs out of attempts after ~11,000,
# most of them failed, as here (tests/test_torch_pour_crowded.py).
# tests/test_torch_granular_decks.py::test_pour20k_targets_from_the_port
# regenerates them.  The f32 run gave the same counts.
POUR20K_ATOMS = {0: 6469, 100: 6469, 200: 6469, 300: 6469, 400: 6469,
                 500: 11243, 600: 11243, 700: 11243, 720: 11243}
# The f32 run's last ke against the f64 run's: the spheres landing on the
# floor amplify f32 rounding, so the two runs part after step 600 (the
# port's own runs on the CPU: 2.7e-5 at step 600, 7.4e-4 at step 720, ke
# 479451.83 against 479807.04); the gate holds the f32 run to the same pour
# (its insertions equal, its energy within 1 %), not to one trajectory.
POUR20K_KE_F32 = 1e-2


# tests/golden/water_npt/in.test replicated 4x4x5 right after read_data:
# 10,000 waters (30,000 atoms) in 76 x 76 x 95 A, harmonic bonds, CHARMM
# angles, lj/charmm/coul/long 6/7 with PPPM 1e-4, SHAKE of the bonds and
# the angle, and the fix line in LAMMPS's default form (tchain 3, pchain 3,
# mtk yes); the dump lines dropped, thermo 50; {golden} is the golden's
# directory, the run lines the caller's
IN_WATER_NPT30K = """
units           real
atom_style      full
bond_style      harmonic
angle_style     charmm
pair_style      lj/charmm/coul/long 6.0 7.0
kspace_style    pppm 1e-4
special_bonds   charmm

read_data       {golden}/data.water
replicate       4 4 5

bond_coeff      1 450.0 0.9572
angle_coeff     1 55.0 104.52 0.0 0.0
pair_coeff      1 1 0.1521 3.1507
pair_coeff      2 2 0.0460 0.4000

neighbor        2.0 bin
neigh_modify    every 1 delay 0 check yes

fix             0 all shake 0.0001 20 0 b 1 a 1
fix             1 all npt temp 300.0 300.0 100.0 iso 0.0 0.0 1000.0

velocity        all create 300.0 48291 loop geom

timestep        1.0
thermo          50
thermo_style    custom step temp epair emol etotal press vol
"""

# tests/golden/water_shake/in.test replicated 4x4x5 right after read_data
# (30,000 atoms, 10,000 SHAKE angle clusters, a 76 x 76 x 95 A box):
# fix shake and fix nve, the dump and run lines dropped, thermo 50; the
# molecular stack of a decomposed run (ROADMAP item 14b); {golden} is the
# golden's directory, the run lines the caller's
IN_WATER_SHAKE30K = """
units           real
atom_style      full
bond_style      harmonic
angle_style     charmm
pair_style      lj/charmm/coul/long 6.0 7.0
kspace_style    pppm 1e-4
special_bonds   charmm

read_data       {golden}/data.water
replicate       4 4 5

bond_coeff      1 450.0 0.9572
angle_coeff     1 55.0 104.52 0.0 0.0
pair_coeff      1 1 0.1521 3.1507
pair_coeff      2 2 0.0460 0.4000

neighbor        2.0 bin
neigh_modify    every 1 delay 0 check yes

fix             0 all shake 0.0001 20 0 b 1 a 1
fix             1 all nve

velocity        all create 300.0 48291 loop geom

timestep        1.0
thermo          50
thermo_style    custom step temp epair emol etotal press vol
"""

# tests/golden/rigid_npt_water/in.test as it stands (thermo 5 included),
# replicated 4x4x5 right after read_data: 10,000 rigid bodies under
# fix rigid/npt molecule ... iso; the run lines the caller's
IN_RIGID_NPT30K = """
units           real
atom_style      full
bond_style      harmonic
angle_style     charmm
pair_style      lj/charmm/coul/long 6.0 7.0
kspace_style    pppm 1e-4
special_bonds   charmm

read_data       {golden}/data.water
replicate       4 4 5

bond_coeff      1 450.0 0.9572
angle_coeff     1 55.0 104.52 0.0 0.0
pair_coeff      1 1 0.1521 3.1507
pair_coeff      2 2 0.0460 0.4000

neighbor        2.0 bin
neigh_modify    every 1 delay 0 check yes

fix             1 all rigid/npt molecule temp 300.0 300.0 100.0 iso 1.0 1.0 1000.0

velocity        all create 300.0 48291 loop geom

timestep        1.0
thermo          5
thermo_style    custom step temp epair emol etotal press vol
"""

# the step-0 epair of the 4x4x5 decks against 80 times the golden's (both
# goldens' step-0 epair is -79.002521): PPPM sizes g_ewald and the mesh
# from the atom count and the box, so the split between the real-space and
# the mesh sums, and its error, differs at 80x.  tpumd and the port (CPU,
# f64) both miss 8 x -79.002521 by 2.1686e-2 at 2x2x2 and the port misses
# 80 x by 2.1985e-2 at 4x4x5 (tests/test_torch_water_golden.py)
WATER30K_EPAIR_RTOL = 2.5e-2
_WATER_EPAIR0 = -79.002521
# step-0 gates: {key: (target, relative tolerance)}; the rigid deck's
# temperature counts the bodies' dof against velocities made for the
# atoms' (LAMMPS's velocity command runs before the bodies exist)
WATER30K_STEP0 = {
    "water_npt30k": {"vol": (548720.0, 1e-6), "temp": (300.0, 1e-5),
                     "epair": (80 * _WATER_EPAIR0, WATER30K_EPAIR_RTOL)},
    "rigid_npt30k": {"vol": (548720.0, 1e-6),
                     "temp": (300.6010952629935, 1e-5),
                     "epair": (80 * _WATER_EPAIR0, WATER30K_EPAIR_RTOL)}}
# the same rows from the port on the CPU in f64 (tests/
# test_torch_water_golden.py::test_water30k_step0_targets), held to
# STEP0_RTOL; not the pressure, whose constraint virial f32 resolves to a
# few percent only (SHAKE's set-up solve: -345.70 against -363.11 atm on
# the card)
WATER30K_STEP0_F64 = {
    "water_npt30k": {"epair": -6181.251467047492,
                     "etotal": 11702.714589937506},
    "rigid_npt30k": {"epair": -6181.251467047492,
                     "etotal": 11738.547814205664}}
# the step-100 row of an f32 run against an f64 run of the same deck on the
# card (rhodo_class's gates, the volume at 1e-3)
WATER30K_F32_F64 = {"temp": 2e-2, "epair": 1e-2, "etotal": 1e-2,
                    "vol": 1e-3}


def shake_geometry(sim) -> tuple[float, float]:
    """(the largest |d - d0| / d0 of the SHAKE and RATTLE bonds, the
    largest |theta - theta0| / theta0 of their angle clusters) at the
    state of sim, at the minimum image, in f64."""
    import torch
    from tpumd_torch.core.state import minimum_image
    s, neigh, _ = sim._carry
    x = s.x.double()[neigh.row2slot]
    box = s.box
    box = box.replace(lo=box.lo.double(), hi=box.hi.double())
    bond, angle = 0.0, 0.0
    for fx in sim.shake_fixes():
        for members, dists in fx._tables(x).values():
            if members.shape[0] == 0:
                continue
            r = [minimum_image(x[members[:, k]] - x[members[:, 0]], box)
                 for k in range(1, members.shape[1])]
            d = [torch.linalg.vector_norm(rk, dim=1) for rk in r]
            for dk, d0 in zip(d, dists):
                bond = max(bond, float(torch.max(torch.abs(dk - d0) / d0)))
            if members.shape[1] == 3 and len(dists) == 3:
                d01, d02, d12 = dists
                th0 = torch.arccos((d01 ** 2 + d02 ** 2 - d12 ** 2)
                                   / (2.0 * d01 * d02))
                th = torch.arccos(torch.sum(r[0] * r[1], dim=1)
                                  / (d[0] * d[1]))
                angle = max(angle, float(torch.max(torch.abs(th - th0)
                                                   / th0)))
    return bond, angle


def rigid_geometry(sim) -> float:
    """The largest |d - d0| / d0 over every pair of atoms within each
    rigid body at the state of sim, d0 from the bodies' set-up frames, in
    f64; bodies of one size only (water)."""
    import torch
    s, neigh, fstates = sim._carry
    (fx, fst), = [(f, st) for f, st in zip(sim.fixes, fstates)
                  if f.name.startswith("rigid")]
    r2s = neigh.row2slot
    u = (s.x.double() + type(fx)._shift(s).double())[r2s]
    order = torch.argsort(fst.body_tag, stable=True)
    size = torch.bincount(fst.body_tag[fst.body_tag >= 0])
    n = int(size[0])
    if not bool(torch.all(size == n)) or int((fst.body_tag < 0).sum()):
        raise NotImplementedError("rigid_geometry: bodies of one size, "
                                  "every atom in a body")
    ub = u[order].reshape(-1, n, 3)
    db = fst.disp_tag.double()[order].reshape(-1, n, 3)
    d = torch.linalg.vector_norm(ub[:, :, None] - ub[:, None], dim=-1)
    d0 = torch.linalg.vector_norm(db[:, :, None] - db[:, None], dim=-1)
    off = d0 > 0
    return float(torch.max(torch.abs(d - d0)[off] / d0[off]))


def gate_failures(vals: dict, targets: dict) -> list[str]:
    """Keys whose value misses its (target, rtol) gate."""
    return [f"{k}={vals[k]!r} vs {t!r} (rtol {r})"
            for k, (t, r) in targets.items()
            if not abs(vals[k] - t) < r * abs(t)]


# the molten-salt decks (the pair-style slice): tests/golden/wolfdsf's
# 64-ion rocksalt cell (lattice constant 4 sigma, units lj, atom_style
# charge) replicated 8x8x8, 32,768 ions in a 64 sigma box, with in.borndsf's
# Born-Mayer-Huggins coefficients; {golden} is the directory that holds
# data.salt.  IN_SALT32K runs born/coul/long under PPPM, IN_SALT32K_DSF
# in.borndsf's born/coul/dsf without kspace; both run on the matrix engine
# (no grid kernel takes these styles)
_SALT_HEAD = """units           lj
atom_style      charge
read_data       {golden}/data.salt
replicate       8 8 8
"""
_SALT_TAIL = """velocity        all create 1.0 87287 loop geom
neighbor        0.3 bin
neigh_modify    delay 0 every 1
fix             1 all nve
timestep        0.004
thermo          100
"""
IN_SALT32K = _SALT_HEAD + """pair_style      born/coul/long 3.2
pair_coeff      * * 1.5 0.4 1.2 1.0 0.5
kspace_style    pppm 1e-4
""" + _SALT_TAIL + """thermo_style    custom step temp epair ecoul elong etotal press
"""
IN_SALT32K_DSF = _SALT_HEAD + """pair_style      born/coul/dsf 0.5 2.8 3.2
pair_coeff      * * 1.5 0.4 1.2 1.0 0.5
""" + _SALT_TAIL + """thermo_style    custom step temp epair ecoul etotal press
"""
SALT32K_N = 32768
SALT32K_STEPS = 1000

# the reference binary's step-0 row of tests/golden/wolfdsf/log.borndsf
# (64 ions): a perfect lattice replicated has the same energies per ion,
# and its virial pressure (press less the kinetic (N - 1) T / V) is the
# same
BORNDSF_STEP0 = {"temp": 1.0, "epair": 0.11694416, "ecoul": -0.45104898,
                 "press": 0.22020709}
BORNDSF_N, BORNDSF_VOLUME = 64, 512.0

# IN_SALT32K's step 0 per ion (thermo normalizes by N in units lj),
# float64 on the CPU through the port (tests/test_torch_kspace_matrix.py
# derives them again): the 64-ion cell under kspace_style ewald 1e-10
# (the exact lattice sum to ~1e-10), and the 512-ion cell (2x2x2) under
# the deck's pppm 1e-4, whose g_ewald and mesh spacing are those of every
# larger replica, so that 32k's rows equal it to round-off
SALT_EWALD_STEP0 = {"epair": 0.2736481093544745,
                    "coul": -4.881786450259125e-05 - 0.4368423594383234}
SALT_PPPM_STEP0 = {"epair": 0.2736574522866313,
                   "ecoul": -0.014724051224735211,
                   "elong": -0.4221577831459341}
# PPPM 1e-4's distance from the Ewald sum per ion on the 512-ion cell
# (3.41e-5 on epair, 2.14e-5 on ecoul + elong), and the gate on it
SALT_PPPM_EWALD_RTOL = 5e-5
# the f32 run against the f64 one: forces at step 0 (the lattice's vanish
# but for round-off, so the bound is 2e-5 of the f64 step-100 max|f|) and
# the step-100 row
SALT_F32_FORCE_TOL = 2e-5
SALT_F32_ROW_RTOL = 1e-4
# the energy drift over the 1,000 steps (max|E(t) - E0| / |E0| at the
# thermo rows, as measure_drift): the deck itself drifts 4.4585e-3 in f64
# at 512 ions, tpumd's and the port's run alike (velocity Verlet at
# dt 0.004 on this lattice; 6.9e-4 at dt 0.001), so the gate is 1e-2
SALT_DRIFT_TOL = 1e-2


def salt_step0_failures(vals: dict, dsf: bool, natoms: int,
                        volume: float, tol: float) -> list[str]:
    """What of a salt deck's step-0 row misses its gate: IN_SALT32K_DSF
    log.borndsf's row (epair, ecoul and the virial pressure, to tol
    absolute: the log's last printed digit); IN_SALT32K the Ewald sum per
    ion (epair and ecoul + elong to SALT_PPPM_EWALD_RTOL) and the 512-ion
    PPPM row (epair, ecoul, elong to tol relative)."""
    bad = []
    if dsf:
        want = dict(BORNDSF_STEP0)
        want["press"] = (want["press"] - (BORNDSF_N - 1) / BORNDSF_VOLUME
                         + (natoms - 1) * vals["temp"] / volume)
        for key in ("epair", "ecoul", "press"):
            if not abs(vals[key] - want[key]) <= tol:
                bad.append(f"{key} {vals[key]!r} vs {want[key]!r}")
        return bad
    coul = vals["ecoul"] + vals["elong"]
    for key, got, w in (("epair", vals["epair"], SALT_EWALD_STEP0["epair"]),
                        ("ecoul + elong", coul, SALT_EWALD_STEP0["coul"])):
        if not abs(got - w) <= SALT_PPPM_EWALD_RTOL * abs(w):
            bad.append(f"{key} {got!r} vs Ewald {w!r}")
    for key, w in SALT_PPPM_STEP0.items():
        if not abs(vals[key] - w) <= tol * abs(w):
            bad.append(f"{key} {vals[key]!r} vs the 512-ion PPPM {w!r}")
    return bad


# ------------------------------------------------------------- hyb32k
# an OPLS-style united-atom liquid of butane-like molecules under the
# styles and coefficients of tests/golden/bonded2/in.hyb, verbatim: a
# hybrid of two sub-styles for every bonded kind, lj/cut 8.0 with the
# 1-4 pairs at 0.5.  hyb_cell writes the 256-atom cell, the deck
# replicates it 5x5x5 (32,000 atoms, 8,000 molecules, a 103 A box).
IN_HYB32K = """units           real
atom_style      full
bond_style      hybrid harmonic morse
angle_style     hybrid harmonic cosine/squared
dihedral_style  hybrid opls multi/harmonic
improper_style  hybrid harmonic cvff
special_bonds   lj/coul 0.0 0.0 0.5
pair_style      lj/cut 8.0
read_data       {data}
replicate       {n} {n} {n}
bond_coeff      1 harmonic 300.0 1.54
bond_coeff      2 morse 100.0 2.0 1.54
angle_coeff     1 harmonic 60.0 110.0
angle_coeff     2 cosine/squared 50.0 110.0
dihedral_coeff  1 opls 1.5 0.8 -0.5 0.3
dihedral_coeff  2 multi/harmonic 1.2 0.8 -0.6 0.4 -0.2
improper_coeff  1 harmonic 8.0 0.0
improper_coeff  2 cvff 8.0 -1 2
pair_coeff      1 1 0.1 3.2
neighbor        2.0 bin
velocity        all create 300.0 9817 loop geom
fix             1 all nve
timestep        0.5
thermo          {thermo}
thermo_style    custom step temp epair ebond eangle edihed eimp etotal press
"""
HYB32K_REPLICAS = 5
HYB_CELL_SEED = 2026
HYB_MOLECULES = 4                 # a side of the lattice of molecules
HYB_DENSITY = 0.58                # g/cm^3, liquid butane
HYB_DRAWS = 2000
HYB_CLEARANCE = 2.8               # A between atoms of two molecules
_AVOGADRO = 6.02214076e23


def _di2_molecules(path):
    """tests/golden/bonded2/data.di2's 27 molecules: (4, 3) positions
    about each centroid, the mass, and each molecule's bonds, angles,
    dihedrals and impropers as (type, members 0..3) rows."""
    with open(path) as fh:
        lines = [ln.split("#")[0].split() for ln in fh]
    sections, name = {}, None
    for toks in lines:
        if len(toks) == 1 or (len(toks) == 2 and toks[1] == "Coeffs"):
            name = " ".join(toks)
            sections[name] = []
        elif toks and name is not None:
            sections[name].append([float(t) for t in toks])
    atoms = np.array(sections["Atoms"])
    atoms = atoms[np.argsort(atoms[:, 0])]
    x = atoms[:, 4:7].reshape(-1, 4, 3)
    mass = float(sections["Masses"][0][1])
    topo = {}
    for kind, sect in (("bond", "Bonds"), ("angle", "Angles"),
                       ("dihedral", "Dihedrals"),
                       ("improper", "Impropers")):
        rows = np.array(sections[sect], dtype=np.int64)[:, 1:]
        mol = (rows[:, 1] - 1) // 4
        local = rows.copy()
        local[:, 1:] = (rows[:, 1:] - 1) % 4
        topo[kind] = [local[mol == k] for k in range(x.shape[0])]
    return x - x.mean(axis=1, keepdims=True), mass, topo


def _random_rotation(rng):
    q = rng.normal(size=4)
    a, b, c, d = q / np.linalg.norm(q)
    return np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d),
         2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a - b * b + c * c - d * d,
         2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b),
         a * a - b * b - c * c + d * d]])


def hyb_cell(path, seed: int = HYB_CELL_SEED) -> None:
    """Write the hyb32k cell as an atom_style full data file at path.
    Molecule k copies data.di2's molecule k mod 27 (its atoms' internal
    geometry and its bonded types), centred on a 4x4x4 lattice in a cube
    of the density HYB_DENSITY, turned at random (numpy
    default_rng(seed)); a turn is drawn again while an atom comes within
    HYB_CLEARANCE of another molecule's, HYB_DRAWS times at most."""
    import os
    shapes, mass, topo = _di2_molecules(os.path.join(
        os.path.dirname(__file__), os.pardir, "tests", "golden", "bonded2",
        "data.di2"))
    m = HYB_MOLECULES
    nmol = m ** 3
    edge = (nmol * 4 * mass / _AVOGADRO / HYB_DENSITY) ** (1.0 / 3.0) * 1e8
    rng = np.random.default_rng(seed)
    grid = (np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                     -1).reshape(-1, 3) + 0.5) * edge / m
    placed = np.zeros((0, 3))
    for k in range(nmol):
        for _ in range(HYB_DRAWS):
            xk = grid[k] + shapes[k % 27] @ _random_rotation(rng).T
            d = xk[:, None, :] - placed[None, :, :]
            d -= edge * np.round(d / edge)
            if placed.shape[0] == 0 \
                    or np.sqrt((d * d).sum(-1)).min() >= HYB_CLEARANCE:
                break
        else:
            raise RuntimeError(f"hyb_cell: molecule {k} finds no place in "
                               f"{HYB_DRAWS} draws at {HYB_DENSITY} g/cm^3")
        placed = np.concatenate([placed, xk])
    x = np.mod(placed, edge)
    counts = {kind: sum(len(topo[kind][k % 27]) for k in range(nmol))
              for kind in topo}
    with open(path, "w") as fh:
        fh.write(f"hyb32k cell: {nmol} molecules of data.di2, seed {seed}"
                 f"\n\n{4 * nmol} atoms\n")
        for kind in topo:
            fh.write(f"{counts[kind]} {kind}s\n")
        fh.write("\n1 atom types\n")
        for kind in topo:
            fh.write(f"2 {kind} types\n")
        fh.write("\n" + "".join(f"0.0 {edge!r} {a}lo {a}hi\n"
                                for a in "xyz"))
        fh.write(f"\nMasses\n\n1 {mass!r}\n\nAtoms\n\n")
        for i, xi in enumerate(x):
            fh.write(f"{i + 1} {i // 4 + 1} 1 0.0 "
                     + " ".join(repr(float(v)) for v in xi) + "\n")
        for kind, sect in (("bond", "Bonds"), ("angle", "Angles"),
                           ("dihedral", "Dihedrals"),
                           ("improper", "Impropers")):
            fh.write(f"\n{sect}\n\n")
            n = 0
            for k in range(nmol):
                for row in topo[kind][k % 27]:
                    n += 1
                    fh.write(f"{n} {row[0]} "
                             + " ".join(str(4 * k + a + 1) for a in row[1:])
                             + "\n")


HYB_KEYS = ("temp", "epair", "ebond", "eangle", "edihed", "eimp", "etotal",
            "press")
# the cell's rows (hyb_cell at HYB_CELL_SEED, 256 atoms), tpumd's own in
# float64 on the CPU at steps 0 and 100 (tests/test_torch_bonded_engines.py
# derives them again).  in.hyb's harmonic improper (chi0 = 0) on a chain
# puts 2,567 kcal/mol in at step 0; the liquid runs at ~2,000-3,000 K.
HYB_CELL_STEP0 = {
    "temp": 299.99999999999994, "epair": -87.0048222518732,
    "ebond": 1.0553977652959929e-12, "eangle": 42.493979070080385,
    "edihed": -24.708302541569978, "eimp": 2566.776793147028,
    "etotal": 2725.5896162486665, "press": 1369.9564974374157}
HYB_CELL_STEP100 = {
    "temp": 3099.528239413181, "epair": -23.17454906388106,
    "ebond": 282.45179692237184, "eangle": 46.76804234821598,
    "edihed": 19.36371421865666, "eimp": 43.92028761675979,
    "etotal": 2725.301048249033, "press": -5348.327002837375}
# 32k's step-0 energies are 125 x the cell's to HYB_STEP0_RTOL of
# max(|value|, 125 kcal/mol): the bonds sit at r0 (ebond ~1e-12 is
# round-off), so each key takes a floor of 1 kcal/mol a cell
HYB_STEP0_RTOL = 1e-10
HYB_STEP0_FLOOR = 1.0
# the f32 run against the f64 one.  The port's f32 gap on the CPU is
# larger than 1e-5 (step-0 forces) and 1e-4 (rows): in.hyb's harmonic
# improper (chi0 = 0) sits at chi 176.5-179.8 deg at step 0, where its
# force divides by sin(chi) (floored at 0.001) after an arccos, so it is
# ill-conditioned, and more so the larger the coordinates (an f32 ulp at
# 100 A is 5x one at 20 A); the worst atom's improper is at 179.80 deg.
# So each gate is 3x the 32k deck's own gap, f32 against f64 on the CPU
# (tests/test_torch_bonded_engines.py measures them again): step-0 forces
# 1.7104e-2 of max|f| (the cell's 6.6668e-3), step-100 rows 2.0320e-4
# (epair; the cell's 1.0283e-4, eimp).  Each term alone (the pair and
# the eight bonded sub-styles, hyb_term_forces) on the f64 run's step-100
# positions, where no improper is near 180 deg and the bonds are
# stretched: its gap over its own max|f|, each gated at 3x.
HYB_F32_FORCE_GAP_CELL = 6.6668e-3
HYB_F32_ROW_GAP_CELL = 1.0283e-4
HYB_F32_FORCE_GAP_32K = 1.7104e-2
HYB_F32_ROW_GAP_32K = 2.0320e-4
HYB_F32_FORCE_TOL = 3 * HYB_F32_FORCE_GAP_32K
HYB_F32_ROW_RTOL = 3 * HYB_F32_ROW_GAP_32K
HYB_F32_TERM_GAP_CELL = {
    "pair": 5.0627e-6, "bond harmonic": 1.1633e-5, "bond morse": 9.2448e-6,
    "angle harmonic": 4.6932e-6, "angle cosine/squared": 8.2569e-6,
    "dihedral opls": 3.5977e-6, "dihedral multi/harmonic": 5.8672e-6,
    "improper harmonic": 3.4099e-6, "improper cvff": 6.0830e-6}
HYB_F32_TERM_GAP_32K = {
    "pair": 2.0533e-5, "bond harmonic": 4.4986e-5, "bond morse": 7.1520e-5,
    "angle harmonic": 3.3420e-5, "angle cosine/squared": 2.6489e-5,
    "dihedral opls": 8.8987e-5, "dihedral multi/harmonic": 2.0886e-5,
    "improper harmonic": 1.5602e-4, "improper cvff": 1.9536e-5}
HYB_F32_TERM_TOL = {k: 3 * v for k, v in HYB_F32_TERM_GAP_32K.items()}
# the energy drift over 1,000 steps (max|E(t) - E0| / |E0| at the thermo
# rows every 100 steps): the cell drifts 1.1486594585787193e-3 in tpumd in
# float64 on the CPU (the port's f32 cell 1.150e-3); the gate is 3x that
HYB_CELL_DRIFT_F64 = 1.1486594585787193e-3
HYB_DRIFT_TOL = 3 * HYB_CELL_DRIFT_F64
HYB32K_STEPS = 1000


def hyb_virial_press(vals: dict, natoms: int, volume: float, units) -> float:
    """The virial part of a row's pressure: press less the kinetic
    (3N - 3) kB T / (3 V) (compute pressure, src/compute_pressure.cpp)."""
    return vals["press"] - ((3 * natoms - 3) * units.boltz * vals["temp"]
                            / (3.0 * volume) * units.nktv2p)


def hyb_step0_failures(vals: dict, cell: dict, copies: int, natoms: int,
                       volume: float, cell_natoms: int, cell_volume: float,
                       units) -> list[str]:
    """What of a replicated deck's step-0 row misses copies x the cell's
    energies (HYB_STEP0_RTOL, floor HYB_STEP0_FLOOR a cell) and the cell's
    virial pressure."""
    bad = []
    for key in ("epair", "ebond", "eangle", "edihed", "eimp"):
        want = copies * cell[key]
        lim = HYB_STEP0_RTOL * max(abs(want), copies * HYB_STEP0_FLOOR)
        if not abs(vals[key] - want) <= lim:
            bad.append(f"{key} {vals[key]!r} vs {copies} x {cell[key]!r}")
    pv = hyb_virial_press(vals, natoms, volume, units)
    pc = hyb_virial_press(cell, cell_natoms, cell_volume, units)
    if not abs(pv - pc) <= HYB_STEP0_RTOL * max(abs(pc), 1.0):
        bad.append(f"virial pressure {pv!r} vs the cell's {pc!r}")
    return bad


def hyb_term_forces(sim) -> dict:
    """sim's forces on its state split by term, per tag (numpy float64):
    each bonded sub-style's alone ("improper harmonic", ...), evaluated
    as verlet.compute_forces does, and "pair", the forces less their sum
    (fix nve adds none)."""
    import torch

    from tpumd_torch.models.bonded import compute_tuples, tag_view
    s, neigh, _ = sim._carry
    ctx = sim._ctx
    _, view, take = tag_view(s, ctx,
                             neigh.row2slot if ctx.is_cellgrid else None)
    live = s.tag > 0
    out = {"pair": s.f[live][torch.argsort(s.tag[live])].double()}
    for style, tuples in ctx.bonded:
        f = compute_tuples(style, view, tuples, s.box, ctx, False, False,
                           take)[0].double()
        out[f"{style.kind} {style.name}"] = f
        out["pair"] = out["pair"] - f
    return {k: v.cpu().numpy() for k, v in out.items()}


def hyb_term_gaps(f32: dict, f64: dict) -> dict:
    """Per term, max|f32 - f64| over the term's own max|f| in f64."""
    return {k: float(np.abs(f32[k] - v).max() / np.abs(v).max())
            for k, v in f64.items()}


# ------------------------------------------------------------------------
# Energy minimization and the host fixes at full width (32,000 atoms).

# in.lj's box (fcc at 0.8442, {n}^3 cells, lj/cut 2.5, neighbor 0.3 bin)
# with every atom displaced at random by up to 0.08 sigma per axis, then
# min_style cg to the minimum; displaced again (another seed) and min_style
# fire.  Both end at the perfect lattice, whose energy per atom is the same
# for every lattice of at least 4 cells (tests/test_breadth_golden.py:
# 163-187, the reference binary's hftn run there)
IN_LJ_MIN32K = """units           lj
atom_style      atomic
lattice         fcc 0.8442
region          box block 0 {n} 0 {n} 0 {n}
create_box      1 box
create_atoms    1 box
mass            1 1.0
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
displace_atoms  all random 0.08 0.08 0.08 76543
min_style       cg
minimize        0.0 1.0e-8 1000 10000
displace_atoms  all random 0.08 0.08 0.08 12345
min_style       fire
minimize        0.0 1.0e-8 1000 10000
"""
LATTICE_PE = -6.77336805325271
MIN32K_F64_RTOL = 1e-9


def lattice_pe(lengths, ncells: int, rc: float = 2.5) -> float:
    """The lj/cut (epsilon = sigma = 1, unshifted) energy per atom of a
    perfect fcc lattice of ncells^3 cells filling a periodic box of these
    lengths, summed in f64 over the lattice vectors within rc (at least
    4 cells: rc under half the box).  At in.lj's box in f64 it is
    LATTICE_PE; at the box rounded to f32 it is the minimum an f32 run
    aims at, since that box holds a lattice of another density."""
    half = np.asarray(lengths, dtype=np.float64) / (2 * ncells)
    m = int(np.ceil(rc / half.min()))
    r = np.arange(-m, m + 1)
    i, j, k = np.meshgrid(r, r, r, indexing="ij")
    r2 = (half[0] * i) ** 2 + (half[1] * j) ** 2 + (half[2] * k) ** 2
    r2 = r2[((i + j + k) % 2 == 0) & (r2 > 0) & (r2 < rc * rc)]
    ir6 = 1.0 / r2 ** 3
    return float(2.0 * np.sum(ir6 * ir6 - ir6))


# the largest |pe/atom - lattice_pe(the run's box)| / |that| of the port's
# f32 run of IN_LJ_MIN32K at n = 4 on the CPU, over both minimizations
# (tests/test_torch_minimize.py::test_min_deck_f32_gap measures it, 3.64e-8
# for cg and for fire); the card's f32 run ends at the energy of its
# second minimization, which is held to F32_GAP_FACTOR times it
MIN32K_F32_CPU_GAP = 3.7e-8


# tests/golden/press_ber/in.test with ``replicate 4 4 4`` right after its
# velocity command: 64 copies of the 500-atom cell, 32,000 atoms.  The
# copies move as the cell does, but a temperature counts 3N - 3 dof, 3
# fewer per copy than the cells' 64 (3 * 500 - 3): the thermostat reads
# temp = the cell's times R = 64 (3 * 500 - 3) / (3 * 32000 - 3).  So
# temp/berendsen's target is scaled by R, which gives every copy the
# cell's velocity scaling, and the printed temp is the cell's times R
# (``replicated_failures``); the pressure and the energies per atom are
# the cell's, the volume and the lengths 64 and 4 times its.
PRESSBER_CELL = 500
REPS = 4


def dof_ratio(reps: int, cell: int = PRESSBER_CELL) -> float:
    """R of reps^3 copies of a cell of ``cell`` atoms."""
    n = reps ** 3
    return (3 * cell - 3) * n / (3 * cell * n - 3)


def _replicated(deck: str) -> str:
    after = "velocity        all create 1.44 87287 loop geom\n"
    assert after in deck
    return deck.replace(after, after + f"replicate       {REPS} {REPS} "
                        f"{REPS}\n")


def pressber32k_deck(golden_deck: str) -> str:
    """IN_PRESSBER32K from tests/golden/press_ber/in.test."""
    deck = _replicated(golden_deck)
    old = "fix             2 all temp/berendsen 1.0 1.0 0.5"
    assert old in deck
    r = dof_ratio(REPS)
    return deck.replace(old, f"fix             2 all temp/berendsen {r!r} "
                        f"{r!r} 0.5")


def deform32k_deck(golden_deck: str, steps: int = 20) -> str:
    """IN_DEFORM32K from tests/golden/deform/in.test (run ``steps``)."""
    old = "run             20"
    assert old in golden_deck
    return _replicated(golden_deck).replace(old, f"run             {steps}")


def golden_rows(log_lines, ncol: int) -> dict:
    """The first thermo row of each step in a run's log, {step: [step,
    values]} (rows of ncol columns): where a run starts, the set-up's row
    after an end-of-step box move is the second (tests/test_press_ber.py)."""
    rows = {}
    for ln in log_lines:
        p = ln.split()
        if p and p[0].isdigit() and len(p) == ncol:
            rows.setdefault(int(p[0]), [float(v) for v in p])
    return rows


def golden_columns(log_lines, cols) -> dict:
    """golden_rows as {step: {col: value}} for thermo columns cols (the
    step's column left out)."""
    return {k: dict(zip(cols, v[1:]))
            for k, v in golden_rows(log_lines, len(cols) + 1).items()}


def replicated_scale(reps: int) -> dict:
    """What a column of reps^3 copies of a golden's cell is divided by to
    compare with the golden: temp by dof_ratio, vol by reps^3, lx, ly and
    lz by reps; the rest as they are (all 1 at reps 1)."""
    return {"temp": dof_ratio(reps), "vol": reps ** 3, "lx": reps,
            "ly": reps, "lz": reps}


def replicated_failures(rows: dict, ref_rows, cols, rtol: float) -> list:
    """The golden's rows (thermo.csv: step then cols) that a replicated
    deck's rows ({step: {col: value}}) miss beyond rtol (plus 1e-8), scaled
    by replicated_scale(REPS)."""
    scale = replicated_scale(REPS)
    bad = []
    for ref in np.atleast_2d(ref_rows):
        step = int(ref[0])
        if step not in rows:
            bad.append(f"step {step} missing")
            continue
        for col, want in zip(cols, ref[1:]):
            got = rows[step][col] / scale.get(col, 1)
            if abs(got - want) > rtol * abs(want) + 1e-8:
                bad.append(f"step {step} {col} {got!r} vs {want!r}")
    return bad


def replicated_gaps(rows: dict, ref_rows, cols, reps: int = 1) -> dict:
    """{col: the largest |value - golden| over the rows, over the
    column's largest |golden|}, the values scaled by replicated_scale
    (reps 1: the golden deck itself)."""
    scale = replicated_scale(reps)
    ref = np.atleast_2d(ref_rows)
    out = {}
    for k, col in enumerate(cols):
        top = max(float(np.abs(ref[:, 1 + k]).max()), 1e-300)
        out[col] = max(abs(rows[int(r[0])][col] / scale.get(col, 1)
                           - r[1 + k]) for r in ref) / top
    return out


# the port's f32 gaps (``replicated_gaps``) of the 500-atom press_ber and
# deform goldens on the CPU, rounded up (tests/test_torch_fix_misc.py and
# tests/test_torch_fix_move_deform.py measure them): an f32 run starts
# from another microstate (``velocity ... loop geom`` hashes the positions
# in the run's dtype), so its rows part from the golden's as a liquid's
# do.  The card's f32 runs
# of the 32k decks are held to F32_GAP_FACTOR times each, or F32_GAP_FLOOR
# (a few f32 roundings of an 8-digit row) where that is larger
PRESSBER_F32_CPU_GAP = {"temp": 0.0376, "epair": 0.0155, "etotal": 0.00505,
                        "press": 0.0771, "vol": 5.82e-4}
DEFORM_F32_CPU_GAP = {"temp": 0.0216, "epair": 0.00575, "emol": 0.0,
                      "etotal": 0.00165, "press": 0.0105, "vol": 1.62e-7,
                      "lx": 4.34e-8, "ly": 3.58e-8, "lz": 3.58e-8}
F32_GAP_FACTOR = 3.0
F32_GAP_FLOOR = 3e-7


def f32_gap_failures(gaps: dict, cpu: dict) -> list:
    """The columns whose f32 gap on the card passes its gate."""
    return [f"{c} {g:.3g} > {max(F32_GAP_FACTOR * cpu[c], F32_GAP_FLOOR):.3g}"
            for c, g in gaps.items()
            if g > max(F32_GAP_FACTOR * cpu[c], F32_GAP_FLOOR)]


# ---------------------------------------------------------------- many-body
# Potential files of the many-body decks.  The parameter files hold the
# published parameters of their papers, as LAMMPS's potentials directory
# carries them (Stillinger-Weber Si, Tersoff Si(B) of PRB 37, 6991 (1988),
# Kumagai's tersoff/mod Si, Tersoff's SiC with a ZBL core, Vashishta's
# SiC, Justo's EDIP Si), written out here because no input is fetched.
# The tabulated files (two-element eam/alloy, eam/fs, eam/he, adp) and the
# EIM ffield are generated from smooth functions.
SI_SW = """# Stillinger-Weber Si (Phys. Rev. B 31, 5262 (1985))
# e1 e2 e3 epsilon sigma a lambda gamma costheta0 A B p q tol
Si Si Si 2.1683 2.0951 1.80 21.0 1.20 -0.333333333333
         7.049556277 0.6022245584 4.0 0.0 0.0
"""

SI_TERSOFF = """# Tersoff Si(B) (Phys. Rev. B 37, 6991 (1988))
# e1 e2 e3 m gamma lambda3 c d costheta0 n beta lambda2 B R D lambda1 A
Si Si Si 3.0 1.0 1.3258 4.8381 2.0417 0.0000 22.956
         0.33675 1.3258 95.373 3.0 0.2 3.2394 3264.7
"""

# Kumagai et al., Comp. Mater. Sci. 39, 457 (2007); n is 1/(2 delta)
SI_TERSOFF_MOD = """# tersoff/mod Si (Kumagai, Izumi, Hara, Sakai 2007)
# e1 e2 e3 beta alpha h eta beta_ters lambda2 B R D lambda1 A n c1 c2 c3 c4 c5
Si Si Si 1.0 2.3890327 -0.365 1.0 1.0 1.345797 121.00047 3.0 0.3
         3.2300135 3281.5905 0.9381055 0.20173476 730418.72 1000000.0
         1.0 26.0
"""

_SIC_TERSOFF_ROWS = [
    # e1 e2 e3 m gamma lambda3 c d h n beta lambda2 B R D lambda1 A
    "C C C 3.0 1.0 0.0 38049 4.3484 -0.57058 0.72751 1.5724e-7 2.2119 "
    "346.74 1.95 0.15 3.4879 1393.6",
    "Si Si Si 3.0 1.0 0.0 100390 16.217 -0.59825 0.78734 1.1e-6 1.73222 "
    "471.18 2.85 0.15 2.4799 1830.8",
    "Si Si C 3.0 1.0 0.0 100390 16.217 -0.59825 0.0 0.0 0.0 0.0 2.36 0.15 "
    "0.0 0.0",
    "Si C C 3.0 1.0 0.0 100390 16.217 -0.59825 0.78734 1.1e-6 1.97205 "
    "395.1451 2.36 0.15 2.9839 1597.3111",
    "C Si Si 3.0 1.0 0.0 38049 4.3484 -0.57058 0.72751 1.5724e-7 1.97205 "
    "395.1451 2.36 0.15 2.9839 1597.3111",
    "C Si C 3.0 1.0 0.0 38049 4.3484 -0.57058 0.0 0.0 0.0 0.0 1.95 0.15 "
    "0.0 0.0",
    "C C Si 3.0 1.0 0.0 38049 4.3484 -0.57058 0.0 0.0 0.0 0.0 2.36 0.15 "
    "0.0 0.0",
    "Si C Si 3.0 1.0 0.0 100390 16.217 -0.59825 0.0 0.0 0.0 0.0 2.85 0.15 "
    "0.0 0.0",
]
_ZNUM = {"C": 6.0, "Si": 14.0}


def _sic_tersoff_zbl():
    rows = []
    for row in _SIC_TERSOFF_ROWS:
        e1, e2 = row.split()[:2]
        rows.append(f"{row} {_ZNUM[e1]} {_ZNUM[e2]} 0.95 14.0")
    return ("# Tersoff SiC (Phys. Rev. B 39, 5566 (1989)) with a ZBL core\n"
            "# tersoff's 14 values, then Z_i Z_j ZBLcut ZBLexpscale\n"
            + "\n".join(rows) + "\n")


SIC_TERSOFF_ZBL = _sic_tersoff_zbl()

SIC_VASHISHTA = """# Vashishta SiC (J. Appl. Phys. 101, 103515 (2007))
# e1 e2 e3 H eta Zi Zj lambda1 D lambda4 W rc B gamma r0 C costheta
C  C  C  471.74538 7 -1.201 -1.201 5.0 0.0 3.0 0.0 7.35 0.0 0.0 0.0 0.0 0.0
Si Si Si 23.67291 7 1.201 1.201 5.0 15.575 3.0 0.0 7.35 0.0 0.0 0.0 0.0 0.0
C  Si Si 447.09026 9 -1.201 1.201 5.0 7.7874 3.0 61.4694 7.35 9.003 1.0
         2.90 5.0 -0.333333333333
Si C  C  447.09026 9 1.201 -1.201 5.0 7.7874 3.0 61.4694 7.35 9.003 1.0
         2.90 5.0 -0.333333333333
C  C  Si 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0
C  Si C  0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0
Si Si C  0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0
Si C  Si 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0
"""

SI_EDIP = """# EDIP Si (Justo et al., Phys. Rev. B 58, 2539 (1998))
# e1 e2 e3 A B cutoffA cutoffC alpha beta eta gamma lambda mu rho sigma Q0
#          u1 u2 u3 u4
Si Si Si 7.9821730 1.5075463 3.1213820 2.5609104 3.1083847 0.0070975
         0.2523244 1.1247945 1.4533108 0.6966326 1.2085196 0.5774108
         312.1341346 -0.165799 32.557 0.286198 0.66
"""

POTENTIALS = {"Si.sw": SI_SW, "Si.tersoff": SI_TERSOFF,
              "Si.tersoff.mod": SI_TERSOFF_MOD,
              "SiC.tersoff.zbl": SIC_TERSOFF_ZBL,
              "SiC.vashishta": SIC_VASHISHTA, "Si.edip": SI_EDIP}


def write_potential(directory, name) -> str:
    """Write one of POTENTIALS into directory; its path."""
    import os
    path = os.path.join(str(directory), name)
    with open(path, "w") as fh:
        fh.write(POTENTIALS[name])
    return path


ALLOY_A0 = 4.05


def _alloy_functions(cut):
    """Two elements from the generated Cu-like functions stretched so that
    fcc sits at its zero-pressure point at ALLOY_A0 (the lattice of
    tests/test_manybody.py's ALCU_DECK): (F, rho, phi) per element and the
    cross phi.  Element 2 ("Al") has 0.85 of the density, 0.8 of the pair
    term and 0.9 of the embedding; the cross pair term is 0.9 of the
    geometric mean of the like ones, so that it differs from both."""
    k = EAM_A0 / ALLOY_A0
    rho0, phi0, embed = _eam_functions(cut * k)

    def rho(r):
        return rho0(r * k)

    def phi(r):
        return phi0(r * k)

    F = [embed, lambda x: 0.9 * embed(x)]
    rhos = [rho, lambda r: 0.85 * rho(r)]

    def phi2(r):
        return 0.8 * phi(r)

    def phi12(r):
        return 0.9 * np.sqrt(phi(r) * phi2(r))
    return F, rhos, [[phi, phi12], [phi12, phi2]]


def alloy_setfl(path, fs: bool = False, he_rhomin: float | None = None,
                adp: bool = False, nrho: int = 500, drho: float = 0.005,
                nr: int = 600, dr: float = 0.01, cut: float = 5.5):
    """Write a two-element (Cu, Al) setfl file from ``_alloy_functions``:
    eam/alloy; with fs an eam/fs file (density functions per element pair:
    element i's in an element-j host, 1.1 times where they differ); with
    he_rhomin an eam/he file (eam/fs tables over rho in [he_rhomin,
    he_rhomin + (nrho-1) drho], the nrho line ending in that rhomax); with
    adp an adp file (u(r) and w(r) for each element pair after phi)."""
    F, rhos, phis = _alloy_functions(cut)
    r = np.arange(nr) * dr
    rho0 = 0.0 if he_rhomin is None else he_rhomin
    rgrid = rho0 + np.arange(nrho) * drho
    znum, mass = [29, 13], [EAM_MASS, 26.98]
    fs = fs or he_rhomin is not None
    with open(path, "w") as fh:
        fh.write("Two-element Cu/Al-like analytic EAM generated from "
                 "Johnson exponentials\nand Rose's universal binding "
                 "curve\n\n")
        fh.write("2 Cu Al\n")
        line = f"{nrho} {drho!r} {nr} {dr!r} {cut!r}"
        if he_rhomin is not None:
            line += f" {rho0 + (nrho - 1) * drho!r}"
        fh.write(line + "\n")
        for i in range(2):
            fh.write(f"{znum[i]} {mass[i]} {ALLOY_A0} fcc\n")
            _write_values(fh, F[i](np.maximum(rgrid, 0.0)))
            if fs:
                for j in range(2):
                    _write_values(fh, rhos[i](r) * (1.0 if i == j else 1.1))
            else:
                _write_values(fh, rhos[i](r))
        for i in range(2):
            for j in range(i + 1):
                _write_values(fh, r * phis[i][j](r))
        if adp:
            for amp, k in ((0.05, 2.0), (0.02, 1.5)):     # u(r), then w(r)
                for i in range(2):
                    for j in range(i + 1):
                        _write_values(fh, _tapered_exp(
                            r, amp * (1.0 + 0.3 * (i + j)), k, 2.5, cut))


# Two-element EIM ffield (rock salt Na/Cl-like), generated: the global
# erfc window, each element's electronegativity and q0, and per pair the
# type-1 phi, the charge-transfer sigma and the coupling coul
FFIELD_EIM = """# generated embedded-ion ffield: two ions of a rock-salt crystal
global: 0.5 -1.8 1.8
element: Na 11 22.98977 0.90 1.5 1.5 5.0 0.0
element: Cl 17 35.453 3.00 1.5 1.5 5.0 0.0
pair: Na Na 7.0 7.0 0.1 3.5 5.5 3.0 6.0 0.25 4.5 6.0 0.6 0.7 4.5 1
pair: Cl Cl 7.0 7.0 0.2 3.9 5.5 3.0 6.0 0.25 4.5 6.0 0.6 0.7 4.5 1
pair: Na Cl 7.0 7.0 0.8 2.8 6.0 3.5 6.0 0.45 4.0 6.0 0.9 0.8 4.0 1
"""


_FCC = np.array([[0.0, 0.0, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5],
                 [0.5, 0.5, 0.0]])
# zinc blende: Si on the fcc sites, C a quarter along the diagonal; rock
# salt: Na on the fcc sites, Cl half along x
TWO_TYPE_CELLS = {"zincblende": (_FCC, _FCC + 0.25, 4.3596, (28.0855,
                                                              12.0107)),
                  "rocksalt": (_FCC, _FCC + [0.5, 0.0, 0.0], 5.64,
                               (22.98977, 35.453))}


def two_type_data(path, kind: str, n: int, box_cells: float | None = None,
                  displace: float = 0.0, seed: int = 2026):
    """Write a data file of n^3 cubic cells of a two-type crystal
    (TWO_TYPE_CELLS: zincblende SiC or rock-salt NaCl), each atom moved by
    a uniform random displacement of up to +-displace (A) per axis from
    the seed; the box is box_cells cells on a side (n by default), so a
    larger box leaves vacuum around the crystal.  Returns the atom count."""
    b1, b2, a, masses = TWO_TYPE_CELLS[kind]
    cells = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"),
                     -1).reshape(-1, 1, 3)
    x = np.concatenate([(cells + b1).reshape(-1, 3),
                        (cells + b2).reshape(-1, 3)]) * a
    types = np.repeat([1, 2], len(x) // 2)
    x = x + np.random.default_rng(seed).uniform(-displace, displace, x.shape)
    side = float((n if box_cells is None else box_cells) * a)
    off = 0.5 * (side - n * a) + 0.125 * a
    x = np.mod(x + off, side)
    with open(path, "w") as fh:
        fh.write(f"{kind} crystal, {n}^3 cells\n\n{len(x)} atoms\n"
                 f"2 atom types\n\n0.0 {side!r} xlo xhi\n0.0 {side!r} ylo "
                 f"yhi\n0.0 {side!r} zlo zhi\n\nMasses\n\n1 {masses[0]}\n"
                 f"2 {masses[1]}\n\nAtoms # atomic\n\n")
        for i, (t, p) in enumerate(zip(types, x), start=1):
            fh.write(f"{i} {t} {float(p[0])!r} {float(p[1])!r} "
                     f"{float(p[2])!r}\n")
    return len(x)


# The many-body decks on the card.  IN_MB32K follows LAMMPS's
# bench/POTENTIALS/in.sw: diamond Si at 5.431 A, 20x20x10 cells (32,000
# atoms) for IN_SW32K and IN_TERSOFF32K, 1000 K, neighbor 1.0 bin,
# delay 5 every 1, NVE at 1 fs; {potential} is the written file
IN_MB32K = """units           metal
atom_style      atomic
lattice         diamond 5.431
region          box block 0 {nx} 0 {ny} 0 {nz}
create_box      1 box
create_atoms    1 box
mass            1 28.06
velocity        all create 1000.0 376847 loop geom
pair_style      {style}
pair_coeff      * * {potential} Si
neighbor        1.0 bin
neigh_modify    delay 5 every 1
fix             1 all nve
timestep        0.001
thermo          100
"""
MB32K_POTENTIAL = {"sw": "Si.sw", "tersoff": "Si.tersoff"}
MB32K_CELLS = (20, 20, 10)


def in_mb32k(style: str, potential: str, cells=MB32K_CELLS) -> str:
    return IN_MB32K.format(style=style, potential=potential, nx=cells[0],
                           ny=cells[1], nz=cells[2])


# metal units (tpumd_torch/utils/units.py)
_BOLTZ_METAL, _NKTV2P_METAL = 8.617343e-5, 1.6021765e6


def mb32k_step0(vals: dict, natoms: int, volume: float) -> dict:
    """The size-free step-0 numbers of a perfect lattice: the pe per atom
    and the virial pressure (press less its kinetic part over 3 natoms - 3
    degrees of freedom, "press_kinetic")."""
    kin = ((3 * natoms - 3) * _BOLTZ_METAL * vals["temp"] / (3.0 * volume)
           * _NKTV2P_METAL)
    return {"pe_atom": vals["epair"] / natoms,
            "press_virial": vals["press"] - kin, "press_kinetic": kin}


def mb32k_step0_failures(got: dict, want: dict, rtol: float) -> list:
    """pe per atom to rtol of itself; the virial pressure, a residual of
    terms of the kinetic pressure's size, to rtol of the kinetic
    pressure."""
    bad = []
    if abs(got["pe_atom"] - want["pe_atom"]) > rtol * abs(want["pe_atom"]):
        bad.append(f"pe_atom {got['pe_atom']!r} vs {want['pe_atom']!r}")
    if abs(got["press_virial"] - want["press_virial"]) \
            > rtol * abs(got["press_kinetic"]):
        bad.append(f"press_virial {got['press_virial']!r} vs "
                   f"{want['press_virial']!r}")
    return bad


# mb32k_step0 of the 3x3x3 deck computed by tpumd on the CPU in float64
# (tests/test_torch_manybody.py::test_32k_step0_gate_values regenerates
# them); the card's f64 step 0 holds to MB32K_STEP0_RTOL
# (mb32k_step0_failures)
MB32K_STEP0 = {"sw": {"pe_atom": -4.336599995039766,
                      "press_virial": -28.13534741152762},
               "tersoff": {"pe_atom": -4.630412064213376,
                           "press_virial": 124.65819666095831}}
MB32K_STEP0_RTOL = 1e-12


def mb32k_f32_gaps(make_script, steps: int = 100) -> dict:
    """{"force": the largest f32 force error over the largest f64 force at
    the f64 run's step-`steps` positions, and per row column the
    |f32 - f64| / |f64| at that step}: the deck made by make_script(dtype)
    in f64 and in f32, the f32 one started from the f64 one's velocities
    (``velocity ... loop geom`` hashes the positions in the run's dtype)
    and types (a region's test of a lattice site on its face may fall the
    other way in f32).  A perfect lattice's step-0 forces vanish, so the
    forces are compared where they do not."""
    import torch
    s64, s32 = make_script(torch.float64), make_script(torch.float32)
    s32.sim.state = s32.sim.state.replace(v=s64.sim.state.v.to(torch.float32),
                                          type=s64.sim.state.type)
    for s in (s64, s32):
        s.run_string("run 0")
        s.run_string(f"run {steps}")
    out = {k: abs(s32.sim.last_thermo[k] - s64.sim.last_thermo[k])
           / abs(s64.sim.last_thermo[k])
           for k in ("temp", "epair", "etotal", "press")}
    # the run's carried state holds the positions: drop it before the edit
    s32.sim.invalidate_ctx()
    a = s64.sim.state
    s32.sim.state = s32.sim.state.replace(
        x=a.x.to(torch.float32), v=a.v.to(torch.float32), tag=a.tag,
        type=a.type, image=a.image)
    s32.run_string("run 0")

    def by_tag(st):
        return st.f.double()[torch.argsort(st.tag)]
    f64 = by_tag(s64.sim.state)
    out["force"] = float((by_tag(s32.sim.state) - f64).abs().max()
                         / f64.abs().max())
    return out


# the port's f32 gaps (mb32k_f32_gaps) on the CPU, per column the larger of
# the small deck's (3x3x3 cells; the alloy's 256-atom cell) and the 32k
# deck's, rounded up (probes/mb32k_cpu_gaps.py prints both;
# tests/test_torch_manybody.py and tests/test_torch_eam_matrix.py hold the
# small decks' under them).  f32's rounding of a position grows with the
# coordinate: at the 32k box the forces' gap is 4x the small deck's, so a
# gate on the small deck's alone would hold the card to less than the CPU's
# own f32 error there.  The card's 32k f32 runs hold to F32_GAP_FACTOR
# times each, or F32_GAP_FLOOR
MB32K_F32_CPU_GAP = {
    "sw": {"temp": 1.7e-6, "epair": 9.8e-8, "etotal": 8.5e-8,
           "press": 2.8e-5, "force": 3.6e-5},
    "tersoff": {"temp": 5.3e-7, "epair": 1.1e-7, "etotal": 1.1e-7,
                "press": 2.1e-5, "force": 4.3e-5}}

# the step-20 rows of tests/golden/meam/log.test (the SiC deck, in.meam run
# 20 steps with thermo 10, as tests/test_meam.py runs it: meam_golden_deck)
# and log.ni (in.ni): the reference binary's
MEAM_GOLDEN_ROWS = {
    "in.meam": {"temp": 1932.4467, "epair": -668.2581, "etotal": -636.53498,
                "press": -120223.52},
    "in.ni": {"temp": 630.48749, "epair": -1113.8207, "etotal": -1093.039,
              "press": 28492.191}}


def meam_golden_deck(text: str) -> str:
    """A MEAM golden deck as the rows of MEAM_GOLDEN_ROWS were printed."""
    return text.replace("run\t\t100", "thermo 10\nrun 20")


# tests/test_manybody.py::test_atm_golden's step-10 row (the reference
# binary on examples/atm/in.atm at 6^3 cells)
ATM_GOLDEN_ROW = {"temp": 1.0356248, "epair": -4.8425038,
                  "etotal": -3.2908645, "press": -4.0872055}

# The two-element eam/alloy deck: tests/test_manybody.py's ALCU_DECK cell
# (4^3 fcc at 4.05 A, the half with x < 2 cells type 2) replicated
# {n}^3 times (n = 5: 32,000 atoms) on alloy_setfl()'s file
IN_EAMALLOY = """units           metal
atom_style      atomic
lattice         fcc 4.05
region          box block 0 4 0 4 0 4
create_box      2 box
create_atoms    1 box
region          half block 0 2 0 4 0 4
group           cu region half
set             group cu type 2
replicate       {n} {n} {n}
pair_style      eam/alloy
pair_coeff      * * {potential} Al Cu
velocity        all create 600.0 376847 loop geom
neighbor        1.0 bin
neigh_modify    every 1 delay 5 check yes
fix             1 all nve
timestep        0.001
thermo          100
"""
EAMALLOY32K_REPS = 5

# the 256-atom cell's step-0 numbers (mb32k_step0 at 600 K), tpumd's on
# the CPU in float64 (tests/test_torch_eam_matrix.py regenerates them); the
# f32 gaps as MB32K_F32_CPU_GAP's, the small deck the cell
EAMALLOY_CELL_STEP0 = {"pe_atom": -3.3538278265606745,
                       "press_virial": -12215.344536227862}
EAMALLOY_F32_CPU_GAP = {"temp": 1.1e-6, "epair": 8.0e-8, "etotal": 6.7e-8,
                        "press": 1.8e-5, "force": 3.1e-5}

# tests/test_manybody.py::test_atm_golden's deck: the reference's
# examples/atm/in.atm at 6^3 cells, atm beside lj/cut under hybrid/overlay
IN_ATM_GOLDEN = """units           lj
atom_style      atomic
lattice         fcc 0.65
region          box block 0 6 0 6 0 6
create_box      1 box
create_atoms    1 box
pair_style      hybrid/overlay lj/cut 4.5 atm 4.5 2.5
pair_coeff      * * lj/cut 1.0 1.0
pair_coeff      * * atm * 0.072
mass            * 1.0
velocity        all create 1.033 12345678 loop geom
neighbor        0.3 bin
neigh_modify    every 1 delay 5 check yes
fix             1 all nve
timestep        0.002
run             10
"""


# ------------------------------------------------------------- DPD, TIP4P
# IN_TIP4P30K: tests/golden/tip4p's deck (lj/cut/tip4p/long with
# pppm/tip4p 1e-4, flexible water at 0.5 fs, NVE) on its 375-atom cell
# replicated 4x4x5: 30,000 atoms in a 76 x 76 x 95 A box, the velocities
# created after the replicate; {golden} is tests/golden/tip4p
IN_TIP4P30K = """units           real
atom_style      full
bond_style      harmonic
angle_style     harmonic
pair_style      lj/cut/tip4p/long 1 2 1 1 0.15 6.0 7.0
kspace_style    pppm/tip4p 1e-4
special_bonds   lj/coul 0.0 0.0 0.5
read_data       {golden}/data.water
replicate       4 4 5
bond_coeff      1 450.0 0.9572
angle_coeff     1 55.0 104.52
pair_coeff      1 1 0.1521 3.1507
pair_coeff      2 2 0.0 1.0
velocity        all create 300.0 48291 loop geom
neighbor        2.0 bin
neigh_modify    every 1 delay 0 check yes
timestep        0.5
fix             1 all nve
thermo          {thermo}
thermo_style    custom step temp epair evdwl ecoul elong emol etotal press
"""
TIP4P30K_REPLICAS = 80

# IN_DPD32K: LAMMPS's bench/POTENTIALS/in.dpd, fcc 3.0 over {n}^3 cells
# (n = 20: 32,000 particles); tests/golden/dpd/in.dpd_cons is the same
# lattice at 4^3 cells with gamma = 0
IN_DPD32K = """units           lj
atom_style      atomic
comm_modify     mode single vel yes
lattice         fcc 3.0
region          box block 0 {n} 0 {n} 0 {n}
create_box      1 box
create_atoms    1 box
mass            1 1.0
velocity        all create 1.0 87287 loop geom
pair_style      dpd 1.0 1.0 34387
pair_coeff      1 1 25.0 4.5
neighbor        0.5 bin
neigh_modify    delay 0 every 4 check no
fix             1 all nve
timestep        0.04
thermo          {thermo}
thermo_style    custom step temp epair etotal press
"""
DPD32K_CELLS = 20

# the columns of the f32 gates of IN_TIP4P30K and IN_DPD32K
KSPACE32K_GAP_KEYS = ("temp", "epair", "etotal", "press")


def tag_ordered(t, tag):
    """Rows of t in tag order."""
    import torch
    return t[torch.argsort(tag)]


def f32_gaps_at(script64, deck: str, device) -> tuple[dict, object]:
    """({column: relative gap, "force": gap of max|f|}, the f32 script): the
    deck in float32 on device with the positions and velocities of the f64
    script's current state (by tag), against that state's row and forces,
    both from a set-up's evaluation (a new set-up and ``run 0``: DPD's
    random kick of step 0 in both); tpumd's way of holding f32 to f64 on
    one state."""
    import torch

    from tpumd_torch.script.parser import LammpsScript
    script64.sim.invalidate_ctx()
    script64.run_string("run 0")
    s64 = script64.sim.state
    x = tag_ordered(s64.x, s64.tag)
    v = tag_ordered(s64.v, s64.tag)
    f64 = tag_ordered(s64.f, s64.tag).double()
    row64 = script64.sim.last_thermo
    script = LammpsScript(device=device, dtype=torch.float32)
    script.run_string(deck)
    script.sim.verbose = False
    st = script.sim.state
    idx = (st.tag.long() - 1).to(x.device)
    script.sim.state = st.replace(x=x[idx].to(device, torch.float32),
                                  v=v[idx].to(device, torch.float32))
    script.run_string("run 0")
    s = script.sim.state
    f32 = tag_ordered(s.f, s.tag).double().to(f64.device)
    gaps = {k: abs(script.sim.last_thermo[k] - row64[k]) / abs(row64[k])
            for k in KSPACE32K_GAP_KEYS}
    gaps["force"] = float((f32 - f64).abs().max() / f64.abs().max())
    return gaps, script

# The port's step-0 rows of the two decks on the CPU in float64
# (probes/kspace32k_cpu_gaps.py; tests/test_torch_tip4p.py and
# test_torch_dpd.py regenerate them under -m slow): the card's f64 step-0
# targets.  IN_TIP4P30K's evdwl and emol are 80x tpumd's cell's; its ecoul
# + elong is 80x the cell's within TIP4P30K_COUL_RTOL of 80 ecoul (1.96e-4
# measured: the 54 x 54 x 64 mesh and g_ewald 0.36993 against the cell's
# 15^3 and 0.38489).  IN_DPD32K's epair is the 4^3 golden cell's per
# particle (tpumd); its press holds step 0's random kick, deterministic.
TIP4P30K_STEP0_F64 = {
    "temp": 299.99999999999994, "epair": -5372.808886203216,
    "evdwl": -5394.76218994354, "ecoul": 715343.2515878329,
    "elong": -715321.2982840926, "etotal": 21453.587320781964,
    "press": 1453.643234154722}
TIP4P30K_COUL_RTOL = 3e-4
DPD32K_STEP0_F64 = {"temp": 1.0, "epair": 3.6872573869019094,
                    "etotal": 5.187210511901909,
                    "press": 28.866395193643474}
# the f32 gates' bases: per column the larger of the cell's gap at its
# step 100 and the full deck's at step 0 (bench_targets.f32_gaps_at on the
# CPU, probes/kspace32k_cpu_gaps.py); the card holds 3x these
TIP4P30K_F32_CPU_GAP = {"temp": 1.02e-7, "epair": 2.95e-6,
                        "etotal": 1.22e-6, "press": 2.43e-5,
                        "force": 6.89e-4}
DPD32K_F32_CPU_GAP = {"temp": 3.76e-8, "epair": 1.82e-7,
                      "etotal": 1.30e-7, "press": 1.09e-7,
                      "force": 6.00e-6}
# the mean temperature of the printed rows of steps 100-1000 of IN_DPD32K
# at 10^3 cells (4,000 particles) in f64 on the CPU; the card's f32 32k
# mean holds to it within DPD_MEAN_TEMP_RTOL (kT = 1: dt 0.04 heats DPD a
# little above it)
DPD10_MEAN_TEMP = 1.0227925399999998
DPD_MEAN_TEMP_RTOL = 0.05


# ------------------------------------------- the NEMD and reactive decks
# IN_KAPPA32K: tests/golden/nemd/in.tc (Muller-Plathe thermal
# conductivity of the LJ fluid at fcc 0.6) on 20^3 cells, 32,000 atoms,
# with fix ave/grid's 4 x 4 x 20 profile (z cells = the swap's slabs) and
# its dump grid every 100 steps; the grid's deck (B1, the list kernels)
IN_KAPPA32K = """units           lj
atom_style      atomic
lattice         fcc 0.6
region          box block 0 {n} 0 {n} 0 {n}
create_box      1 box
create_atoms    1 box
mass            1 1.0
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0
neighbor        0.3 bin
velocity        all create 1.35 87287 loop geom
fix             1 all nve
fix             2 all thermal/conductivity 10 z 20
fix             3 all ave/grid 10 10 100 4 4 20 vx density/mass temp
dump            g all grid 100 {grid} f_3:grid:data[1] f_3:grid:data[2] f_3:grid:data[3] f_3:grid:count
timestep        0.005
thermo          {thermo}
thermo_style    custom step temp epair etotal f_2
"""

# IN_BONDCREATE32K: step-growth dimerisation of 32,000 monomers at melt
# density (fcc 0.8442, 20^3 cells); the pair, bond and fix lines of
# tests/golden/bond_create/in.test verbatim, the bonds written by dump
# local every 100 steps; the matrix engine's deck (P1)
IN_BONDCREATE32K = """units           lj
atom_style      bond
special_bonds   lj/coul 0.0 0.0 0.0
lattice         fcc 0.8442
region          box block 0 {n} 0 {n} 0 {n}
create_box      1 box bond/types 1 extra/bond/per/atom 2 extra/special/per/atom 4
create_atoms    1 box
mass            1 1.0
pair_style      lj/cut 2.5
bond_style      harmonic
pair_coeff      1 1 1.0 1.0
bond_coeff      1 50.0 1.0
neighbor        0.3 bin
neigh_modify    every 1 delay 0 check yes
fix             1 all nve
fix             2 all bond/create 5 1 1 1.15 1 iparam 1 1 jparam 1 1
velocity        all create 1.5 2763 loop geom
timestep        0.005
compute         bl all bond/local dist engpot force
compute         pl all property/local batom1 batom2 btype
dump            d all local 100 {local} index c_pl[1] c_pl[2] c_pl[3] c_bl[1] c_bl[2] c_bl[3]
thermo          {thermo}
thermo_style    custom step temp ebond epair etotal press
"""

# IN_CHAIN_RESPA32K: tests/golden/respa_chain/in.test (IN_CHAIN's chains
# in NVE, FENE and the WCA pair on two respa levels) on chain_data()'s
# 32,000 beads; the matrix engine's deck (P1): respa puts the bonds and
# the pair on separate levels, which the grid's kernels cannot split
IN_CHAIN_RESPA32K = """units           lj
atom_style      bond
special_bonds   fene
read_data       {data}
neighbor        0.4 bin
neigh_modify    every 1 delay 1
bond_style      fene
bond_coeff      1 30.0 1.5 1.0 1.0
pair_style      lj/cut 1.1224620483093730
pair_coeff      1 1 1.0 1.0 1.1224620483093730
pair_modify     shift yes
fix             1 all nve
run_style       respa 2 {inner} bond 1 pair 2
timestep        0.012
thermo          {thermo}
thermo_style    custom step temp epair emol etotal press
"""

# the port's CPU f64 numbers behind the three decks' card gates
# (python3 -m tpumd_torch.remainder32k_cpu_rows, 4 CPU threads):
# IN_KAPPA32K's rows of steps 0 and 100 at full precision and etotal's largest relative move
# over steps 0-100 (the unshifted lj/cut's energy jumps at the cutoff; the
# golden's reference log moves as far, 1.16e-2 over its 100 steps); the
# card's f64 run holds 1.01x it
KAPPA32K_ROWS_F64 = {
    0: {"temp": 1.35, "epair": -4.124191666666666,
        "etotal": -2.0992549479166653, "f_2": 0.0},
    100: {"temp": 1.1429982669520484, "epair": -3.7883143184492467,
          "etotal": -2.0738704960649375, "f_2": 77.79915336391063}}
KAPPA32K_ETOTAL_DRIFT_F64 = 0.012687032928494338
KAPPA32K_DRIFT_FACTOR = 1.01
# IN_BONDCREATE32K's step-0 row and the bonds made at its first event
# (step 5): their count and the sha256 of their sorted "tag tag" lines
BONDCREATE32K_STEP0_F64 = {"temp": 1.5000000000000002, "ebond": 0.0,
                           "epair": -6.773368053252956,
                           "etotal": -4.523438365752956,
                           "press": -4.969056841960588}
BONDCREATE32K_STEP5_BONDS = (
    9024, "e242822398ccaa7731e53cf7d804725d7f915285cc54a0566a83017a341f1a50")
# IN_CHAIN_RESPA32K's step-0 row on chain_data() (32,000 beads, seed 2026)
CHAIN_RESPA32K_STEP0_F64 = {"temp": 0.9699999999999999,
                            "epair": 0.20990563750236732,
                            "emol": 20.493086537201417,
                            "etotal": 22.157946705953787,
                            "press": -2.515644437037974}
# the f32 energy bound of IN_CHAIN_RESPA32K's timed window (steps 100-600
# of respa 2 2, dt 0.012), written before its first card run: the largest
# |etotal - etotal(100)| / |etotal(100)| over the printed rows
RESPA32K_F32_DRIFT = 5e-3


# ------------------------------------------------------------------------
# The replica layer and the library interface: tpumd's tests' decks of the
# REPLICA package and of fix external widened to in.lj's 20^3 fcc cells
# (32,000 sites; the vacancy deck 31,999 atoms).  chip_smoke.py's
# temper32k_path, neb32k_path, prd32k_path, tad32k_path, hyper32k_path and
# external32k_path run them on the card; the CPU tests run the same decks
# at 3^3 and 4^3 cells.

# tests/test_temper.py's deck at in.lj's density and box: four replicas
# 0.4 % apart near T 1 (at 32,000 atoms the energy's spread over a replica
# pair, N c_v (dT/T)^2, lets about 40 % of the swaps through)
TEMPER32K_WORLDS = ("1.000", "1.004", "1.008", "1.012")
IN_TEMPER32K = """units           lj
atom_style      atomic
variable        t world """ + " ".join(TEMPER32K_WORLDS) + """
lattice         fcc 0.8442
region          box block 0 {n} 0 {n} 0 {n}
create_box      1 box
create_atoms    1 box
mass            1 1.0
velocity        all create $t 87287 loop geom
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
neigh_modify    delay 0 every 20 check no
fix             1 all nvt temp $t $t 0.5
temper          {steps} {every} $t 1 3847 58382
"""

# tests/test_neb.py's vacancy hop: the atom at (a/2, a/2, 0) hops into the
# vacancy at the origin (the final file holds that one atom, written by
# neb_final_file); 8 images
IN_NEB32K_HEAD = """units           lj
atom_style      atomic
boundary        p p p
lattice         fcc 0.85
region          box block 0 {n} 0 {n} 0 {n}
create_box      1 box
create_atoms    1 box
mass            1 1.0
region          vac sphere 0.05 0.05 0.0 0.18
delete_atoms    region vac
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
"""
IN_NEB32K = IN_NEB32K_HEAD + """fix             1 all neb 1.0
neb             0.0 1.0e-6 {n1} {n2} 100 final {final} replicas 8
"""
NEB_ALAT = (4 / 0.85) ** (1 / 3.0)


def neb_final_file(path: str, state) -> int:
    """Write the vacancy hop's final-coordinates file for a state of
    IN_NEB32K_HEAD (the hopping atom at the vacancy site); returns the
    atom's tag."""
    import torch
    x = state.x.double().cpu()
    d = (x - torch.tensor([0.5 * NEB_ALAT, 0.5 * NEB_ALAT, 0.0])).abs()
    i = int(torch.argmin(d.max(dim=1).values))
    if float(d[i].max()) > 1e-6:
        raise ValueError("no atom at the hop's start site")
    tag = int(state.tag[i])
    with open(path, "w") as fh:
        fh.write(f"1\n{tag} 0.0 0.0 0.0\n")
    return tag


# tests/test_prd.py's and tests/test_tad_hyper.py's decks: an fcc solid at
# 1.0 and T 0.1 (prd, tad) or 0.2 (hyper), every step checked
IN_EVENT32K = """units           lj
atom_style      atomic
lattice         fcc 1.0
region          box block 0 {n} 0 {n} 0 {n}
create_box      1 box
create_atoms    1 box
mass            1 1.0
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
neigh_modify    delay 0 every 1 check yes
velocity        all create {temp} 87287 loop geom
fix             1 all nve
{extra}
compute         ev all event/displace {dcut}
"""
IN_PRD32K = IN_EVENT32K.format(n="{n}", temp=0.1, extra="", dcut=0.9)
# TAD on the vacancy deck at T 0.1: the candidate event of the first
# search segment is the vacancy hop (the hopping atom set on the vacancy
# site before its quench), so that its NEB crosses a real barrier
IN_TAD32K = IN_NEB32K_HEAD + """velocity        all create 0.1 87287 loop geom
neigh_modify    delay 0 every 1 check yes
fix             1 all nve
compute         ev all event/displace 0.9
"""
IN_HYPER32K = IN_EVENT32K.format(
    n="{n}", temp=0.2, extra="fix             h all hyper/global 1.3 0.3 "
    "0.4 0.4", dcut=0.5)

# in.lj's melt under fix external (the API and the C shim drive it)
IN_EXTERNAL32K = IN_LJ + """fix             ext all external {mode}
"""
# the spring constant of the callback that stands in for fix spring/self
EXTERNAL32K_K = 0.7


# ------------------------------------------------------------------------
# atom_style ellipsoid: a liquid of ellipsoids run as points of their mass
# (tpumd has no aspherical pair style or integrator).  ellipsoid_data
# writes n^3 of them on a simple cubic lattice of spacing 1.2 sigma, each
# moved by up to +-0.1 sigma per axis, with semi-axes 0.3-0.6 sigma,
# random unit quaternions, density 1, velocities and angular momenta from
# the seed; every eighth atom has flag 0 (a point of mass 1).
IN_ELLIPSOID = """units           lj
atom_style      ellipsoid
read_data       {data}
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
fix             1 all nve
thermo          10
"""


def ellipsoid_data(path, n: int, seed: int = 2026) -> int:
    """Write IN_ELLIPSOID's data file of n^3 ellipsoids; returns the atom
    count."""
    rng = np.random.default_rng(seed)
    a = 1.2
    x = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"),
                 -1).reshape(-1, 3) * a + 0.5 * a
    x = x + rng.uniform(-0.1, 0.1, x.shape)
    m = len(x)
    flag = (np.arange(m) % 8 != 7).astype(int)
    diam = rng.uniform(0.6, 1.2, (m, 3))
    quat = rng.standard_normal((m, 4))
    v = rng.standard_normal((m, 3))
    angmom = 0.1 * rng.standard_normal((m, 3))
    side = n * a
    with open(path, "w") as fh:
        fh.write(f"ellipsoid liquid, {n}^3 sites\n\n{m} atoms\n"
                 f"{int(flag.sum())} ellipsoids\n1 atom types\n\n"
                 f"0.0 {side!r} xlo xhi\n0.0 {side!r} ylo yhi\n"
                 f"0.0 {side!r} zlo zhi\n\nMasses\n\n1 1.0\n\n"
                 "Atoms # ellipsoid\n\n")
        for i in range(m):
            fh.write(f"{i + 1} 1 {flag[i]} 1.0 " + " ".join(
                repr(float(c)) for c in x[i]) + "\n")
        fh.write("\nEllipsoids\n\n")
        for i in np.nonzero(flag)[0]:
            fh.write(f"{i + 1} " + " ".join(
                repr(float(c)) for c in (*diam[i], *quat[i])) + "\n")
        fh.write("\nVelocities\n\n")
        for i in range(m):
            fh.write(f"{i + 1} " + " ".join(
                repr(float(c)) for c in (*v[i], *angmom[i])) + "\n")
    return m


# a molecular liquid whose fix shake makes clusters of every kind: water
# (the angle cluster of `a 1`), methanol (its CH3's 4-atom cluster and its
# OH's 2-atom one, picked by `m 1.0`) and formaldehyde (its CH2's 3-atom
# cluster), one molecule to each site of an n^3 lattice of spacing A,
# turned at random (seed), at the styles of the water goldens; {data} is
# the file shake_mixture_data writes
IN_SHAKE_MIXTURE = """units           real
atom_style      full
bond_style      harmonic
angle_style     charmm
pair_style      lj/charmm/coul/long 6.0 7.0
pair_modify     mix arithmetic
kspace_style    pppm 1e-4
special_bonds   charmm
read_data       {data}
pair_coeff      1 1 0.1521 3.1507
pair_coeff      2 2 0.0460 0.4000
pair_coeff      3 3 0.0700 3.5500
pair_coeff      4 4 0.1700 3.0700
bond_coeff      1 450.0 0.9572
bond_coeff      2 340.0 1.09
bond_coeff      3 320.0 1.43
bond_coeff      4 545.0 0.96
bond_coeff      5 570.0 1.21
angle_coeff     1 55.0 104.52 0.0 0.0
angle_coeff     2 35.5 109.47 0.0 0.0
angle_coeff     3 45.9 109.47 0.0 0.0
angle_coeff     4 57.5 108.5 0.0 0.0
angle_coeff     5 35.5 116.2 0.0 0.0
angle_coeff     6 50.0 121.9 0.0 0.0
neighbor        2.0 bin
neigh_modify    every 5 delay 0 check no
fix             1 all nve
fix             2 all shake 0.0001 20 0 m 1.0 a 1
velocity        all create 300.0 4928 loop geom
timestep        1.0
thermo          5
"""


def _mixture_molecules():
    """(types, charges, local positions, bonds (type, i, j), angles (type,
    i, j, k)) of water, methanol and formaldehyde at their bond lengths
    and angles; types 1 water O, 2 H, 3 C, 4 O."""
    def unit(deg):
        a = np.radians(deg)
        return np.array([np.cos(a), np.sin(a), 0.0])
    water = ([1, 2, 2], [-0.834, 0.417, 0.417],
             [[0, 0, 0], [0.9572, 0, 0], 0.9572 * unit(104.52)],
             [(1, 0, 1), (1, 0, 2)], [(1, 1, 0, 2)])
    tet = np.arccos(-1.0 / 3.0)
    hc = [1.09 * np.array([np.cos(tet), np.sin(tet) * np.cos(p),
                           np.sin(tet) * np.sin(p)])
          for p in np.radians([0.0, 120.0, 240.0])]
    ho = np.array([1.43, 0, 0]) + 0.96 * unit(-71.5)
    methanol = ([3, 4, 2, 2, 2, 2], [0.0, -0.70, 0.58, 0.04, 0.04, 0.04],
                [[0, 0, 0], [1.43, 0, 0], ho, *hc],
                [(3, 0, 1), (4, 1, 2), (2, 0, 3), (2, 0, 4), (2, 0, 5)],
                [(4, 0, 1, 2), (3, 3, 0, 1), (3, 4, 0, 1), (3, 5, 0, 1),
                 (2, 3, 0, 4), (2, 3, 0, 5), (2, 4, 0, 5)])
    formaldehyde = ([3, 4, 2, 2], [0.5, -0.5, 0.0, 0.0],
                    [[0, 0, 0], [1.21, 0, 0], 1.10 * unit(121.9),
                     1.10 * unit(-121.9)],
                    [(5, 0, 1), (2, 0, 2), (2, 0, 3)],
                    [(6, 2, 0, 1), (6, 3, 0, 1), (5, 2, 0, 3)])
    return water, methanol, formaldehyde


def shake_mixture_data(path, n: int = 6, spacing: float = 4.5,
                       seed: int = 2026) -> int:
    """Write IN_SHAKE_MIXTURE's data file: water, methanol and
    formaldehyde in turn on the n^3 sites, each turned by a random
    rotation (redrawn until its atoms stand 2 A from every atom placed
    before); returns the atom count (936 at n = 6)."""
    rng = np.random.default_rng(seed)
    mols = _mixture_molecules()
    side = n * spacing
    atoms, bonds, angles = [], [], []
    placed = np.zeros((0, 3))
    for m in range(n ** 3):
        typ, q, xyz, bl, al = mols[m % 3]
        iz, iy, ix = np.unravel_index(m, (n, n, n))
        centre = (np.array([ix, iy, iz]) + 0.5) * spacing
        xyz = np.asarray(xyz, float)
        xyz = xyz - xyz.mean(axis=0)
        for _ in range(100):
            u = rng.normal(size=4)
            a, b, c, d = u / np.linalg.norm(u)
            rot = np.array([
                [a*a + b*b - c*c - d*d, 2*(b*c - a*d), 2*(b*d + a*c)],
                [2*(b*c + a*d), a*a - b*b + c*c - d*d, 2*(c*d - a*b)],
                [2*(b*d - a*c), 2*(c*d + a*b), a*a - b*b - c*c + d*d]])
            pos = centre + xyz @ rot.T
            gap = pos[:, None] - placed[None]
            gap -= side * np.round(gap / side)
            if not len(placed) or np.sqrt((gap * gap).sum(-1)).min() > 2.0:
                break
        else:
            raise RuntimeError(f"no room for molecule {m + 1}")
        base = len(atoms)
        atoms += [(m + 1, t, float(qq), *map(float, p % side))
                  for t, qq, p in zip(typ, q, pos)]
        bonds += [(t, base + i + 1, base + j + 1) for t, i, j in bl]
        angles += [(t, base + i + 1, base + j + 1, base + k + 1)
                   for t, i, j, k in al]
        placed = np.concatenate([placed, pos])
    with open(path, "w") as fh:
        fh.write(f"water, methanol and formaldehyde, seed {seed}\n\n"
                 f"{len(atoms)} atoms\n{len(bonds)} bonds\n{len(angles)} "
                 "angles\n\n4 atom types\n5 bond types\n6 angle types\n\n")
        for ax in "xyz":
            fh.write(f"0.0 {side!r} {ax}lo {ax}hi\n")
        fh.write("\nMasses\n\n1 15.9994\n2 1.008\n3 12.011\n4 15.9994\n"
                 "\nAtoms\n\n")
        for i, (mol, t, qq, x, y, z) in enumerate(atoms):
            fh.write(f"{i + 1} {mol} {t} {qq!r} {x!r} {y!r} {z!r}\n")
        fh.write("\nBonds\n\n")
        for i, b in enumerate(bonds):
            fh.write(f"{i + 1} {b[0]} {b[1]} {b[2]}\n")
        fh.write("\nAngles\n\n")
        for i, a in enumerate(angles):
            fh.write(f"{i + 1} {a[0]} {a[1]} {a[2]} {a[3]}\n")
    return len(atoms)

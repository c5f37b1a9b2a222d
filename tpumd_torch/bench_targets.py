"""Thermo gates of the in.lj benchmark deck, copied from tools/bench_all.py
(which imports jax) so that the port's chip check needs no JAX."""

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


def gate_failures(vals: dict, targets: dict) -> list[str]:
    """Keys whose value misses its (target, rtol) gate."""
    return [f"{k}={vals[k]!r} vs {t!r} (rtol {r})"
            for k, (t, r) in targets.items()
            if not abs(vals[k] - t) < r * abs(t)]

"""Per-atom views and tallies for the analysis layer, on the device.

The port of tpumd/md/peratom.py (the reference's eatom/vatom plumbing,
src/pair.cpp:893 ev_setup; compute_pe_atom.cpp, compute_stress_atom.cpp).
Every result is in TAG order (the atoms sorted by tag, as tpumd's
``_tag_order``), whatever the engine's own row order: slot order with
empty slots on the cell grid, the set-up's sorted rows on the matrix
engine.  Nothing here reads the device back: the tallies stay on it until
a consumer (a thermo row, a dump, a fix ave file) needs them.

Per-atom energy and virial come from the force styles themselves:

- on the cell grid, from the per-slot energy and virial that B1
  (lj/cut), B2 (lj/cut + FENE) and B5 (lj/charmm/coul/long) already write
  with EFLAG and VFLAG: half of each slot's value is LAMMPS's newton-off
  ``ev_tally`` share, so the launch returns the halved slots instead of
  their sums (no new kernel);
- on the matrix engine, from ``pair_sums(..., eflag="atom")`` (a hybrid
  style's summed over its sub-styles), with each atom's Coulomb
  self-energy of a Wolf or DSF style in its own energy, where LAMMPS's
  ev_tally(i, i, ...) puts it (tpumd leaves it out: ROADMAP C17);
- the bonded styles split each tuple's energy and virial evenly among its
  members (ev_tally, ev_tally3, ev_tally4's equal shares).

EAM and the granular styles have no per-atom path; a compute that needs
one raises at its set-up and names the style, as tpumd does.  Kspace and
fix contributions are not in the tallies (tpumd's choice; ROADMAP C15).
"""

from __future__ import annotations

import functools

import torch

from tpumd_torch.md.verlet import _pair_ext
from tpumd_torch.models.bonded import compute_tuples_peratom, tag_view


F64 = torch.float64


def current(sim):
    """(state, neigh) of the run's current set-up, or (sim.state, None)
    before one."""
    if sim._carry is None:
        return sim.state, None
    return sim._carry[0], sim._carry[1]


def cached(sim, key, fn):
    """fn() once per state: the analysis cache is dropped whenever the
    run's current state is another one (a segment ended, a set-up, an
    edit)."""
    s, _ = current(sim)
    if getattr(sim, "_acache_owner", None) is not s \
            or getattr(sim, "_acache_step", None) != sim.step:
        sim._acache = {}
        sim._acache_owner = s
        sim._acache_step = sim.step
    if key not in sim._acache:
        sim._acache[key] = fn()
    return sim._acache[key]


def tag_rows(sim):
    """(natoms,) int64 rows of the current state in tag order."""
    def make():
        s, _ = current(sim)
        rows = torch.nonzero(s.tag > 0).flatten()
        return rows[torch.argsort(s.tag[rows])]
    return cached(sim, "rows", make)


def mass_table(sim, device):
    return torch.as_tensor(sim.mass, dtype=torch.float64, device=device)


class TagOrder:
    """The current atoms in tag order, float64, on the run's device: x, v,
    f, type, tag, image, xu (unwrapped), mass, gmask, q, molecule, radius,
    rmass, omega (None where the atoms lack them), and the box's lengths,
    lo, hi (float64) and periodic flags.  Each per-atom field is gathered
    on first use, so a compute that reads two fields costs two gathers."""

    def __init__(self, sim):
        self.sim = sim
        self.state, _ = current(sim)
        self.rows = tag_rows(sim)
        self.n = int(self.rows.shape[0])
        box = self.state.box
        self.lengths = box.lengths.to(torch.float64)
        self.lo, self.hi = box.lo.to(torch.float64), box.hi.to(torch.float64)
        self.periodic = box.periodic

    def _take(self, name, dtype=None):
        a = getattr(self.state, name)
        if a is None:
            return None
        a = a[self.rows]
        return a if dtype is None else a.to(dtype)

    x = functools.cached_property(lambda self: self._take("x", F64))
    v = functools.cached_property(lambda self: self._take("v", F64))
    f = functools.cached_property(lambda self: self._take("f", F64))
    type = functools.cached_property(lambda self: self._take("type"))
    tag = functools.cached_property(lambda self: self._take("tag"))
    image = functools.cached_property(lambda self: self._take("image"))
    q = functools.cached_property(lambda self: self._take("q", F64))
    molecule = functools.cached_property(
        lambda self: self._take("molecule"))
    radius = functools.cached_property(lambda self: self._take("radius", F64))
    rmass = functools.cached_property(lambda self: self._take("rmass", F64))
    omega = functools.cached_property(lambda self: self._take("omega", F64))

    @functools.cached_property
    def xu(self):
        return self.x + self.image.to(F64) * self.lengths

    @functools.cached_property
    def mass(self):
        if self.rmass is not None:
            return self.rmass
        return mass_table(self.sim, self.x.device)[self.type.long()]

    @functools.cached_property
    def gmask(self):
        g = self._take("gmask")
        return torch.ones_like(self.type) if g is None else g


def atoms(sim) -> TagOrder:
    """The current atoms in tag order (``TagOrder``), once per state."""
    return cached(sim, "atoms", lambda: TagOrder(sim))


def group_sel(sim, group):
    """(natoms,) bool tag-order membership of a group."""
    a = atoms(sim)
    if group == "all":
        return torch.ones(a.n, dtype=torch.bool, device=a.x.device)
    if group not in sim.groups:
        raise ValueError(f"undefined group {group!r}")
    return (a.gmask & sim.groups[group]) > 0


def min_image(d, a):
    """d with the minimum image on the periodic axes (tpumd's _min_image:
    d - L round(d / L))."""
    per = torch.tensor(a.periodic, device=d.device)
    return torch.where(per, d - a.lengths * torch.round(d / a.lengths), d)


def check_peratom_style(sim, what):
    """Raise where the pair style has no per-atom path (EAM, granular)."""
    pair = sim.pair
    if pair is not None and not getattr(pair, "peratom", False):
        raise ValueError(
            f"compute {what}: per-atom tallies are not implemented for "
            f"pair style {pair.name!r} (tpumd has none either)")


def pair_bonded_tallies(sim):
    """(eatom (natoms,), vatom (natoms, 6)) float64 in tag order: pair +
    bonded per-atom energy and virial of the current state
    (tpumd/md/peratom.py::pair_bonded_tallies)."""
    return cached(sim, "tallies", lambda: _tallies(sim))


def _tallies(sim):
    s, neigh = current(sim)
    ctx = sim._ctx
    if ctx is None:
        raise ValueError("per-atom tallies need a set-up (run 0 first)")
    check_peratom_style(sim, "pe/atom or stress/atom")
    rows = tag_rows(sim)
    f64 = torch.float64
    n = rows.shape[0]
    eatom = torch.zeros(n, dtype=f64, device=s.x.device)
    vatom = torch.zeros((n, 6), dtype=f64, device=s.x.device)
    if ctx.pair is not None:
        ea, va = pair_rows(s, neigh, ctx)
        eatom += ea[rows].to(f64)
        vatom += va[rows].to(f64)
    if ctx.bonded:
        _, view, take = tag_view(
            s, ctx, neigh.row2slot if ctx.is_cellgrid else None)
        for style, tuples in ctx.bonded:
            # tuples name atoms by tag - 1: the bonded decks' tags run
            # 1..natoms, which is tag order; a hybrid's sub-styles are
            # separate entries, each with its own tuples
            ea, va = compute_tuples_peratom(style, view, tuples, s.box, ctx,
                                            take)
            eatom += ea.to(f64)
            vatom += va.to(f64)
    return eatom, vatom


def pair_rows(s, neigh, ctx):
    """(eatom, vatom) of the pair style per engine row (grid slot or
    matrix row), through the force launch with eflag = vflag = "atom": on
    the grid, B1's, B2's or B5's halved per-slot outputs (B2's energy holds
    the FENE bonds that ride it), on the matrix engine pair_sums'."""
    pair = ctx.pair
    if not ctx.is_cellgrid:
        special = ctx.neigh_cfg.has_special
        _, ea, va, _ = pair.compute(
            s.x, s.type, s.box, neigh.idx, neigh.sbits,
            ctx.special_lj if special else None,
            ctx.special_coul if special else None, "atom", "atom", q=s.q,
            ext=_pair_ext(s, ctx))
        if s.q is not None and hasattr(pair, "ecoul_self_atom"):
            ea = ea + pair.ecoul_self_atom(s.q)
        return ea, va
    if getattr(pair, "charged", False):
        _, ea, va, _ = pair.compute_cellgrid_charged(
            s, neigh, ctx.neigh_cfg, ctx.special_lj, ctx.special_coul,
            "atom", "atom")
        return ea, va
    bond = None
    if ctx.kernel_bond is not None:
        bond = (ctx.kernel_bond, (neigh.pairs, neigh.npairs,
                                  neigh.bond_slots, neigh.row2slot))
    _, ea, va, _ = pair.compute_cellgrid(
        s.x, neigh.valid, s.box, ctx.neigh_cfg, "atom", "atom", bond=bond,
        plist=(neigh.pairs, neigh.npairs, neigh.row2slot))
    return ea, va


def mass_tag_order(sim):
    return atoms(sim).mass


def stress_atom(sim):
    """compute stress/atom: -(m v v mvv2e + pair/bonded virial) * nktv2p
    per atom, in pressure*volume units (src/compute_stress_atom.cpp)."""
    _, vatom = pair_bonded_tallies(sim)
    v, m, u = atoms(sim).v, mass_tag_order(sim), sim.units
    kin = torch.stack([m * v[:, 0] * v[:, 0], m * v[:, 1] * v[:, 1],
                       m * v[:, 2] * v[:, 2], m * v[:, 0] * v[:, 1],
                       m * v[:, 0] * v[:, 2], m * v[:, 1] * v[:, 2]],
                      dim=1) * u.mvv2e
    return -(kin + vatom) * u.nktv2p

"""The compute library: the ``Compute`` base, ``create_compute`` and the
global and per-atom computes of tpumd/md/compute_styles.py (reference
contracts: src/compute_temp.cpp, compute_pe.cpp, compute_ke.cpp,
compute_pressure.cpp, compute_com.cpp, compute_msd.cpp, compute_vacf.cpp,
compute_gyration.cpp, compute_pe_atom.cpp, compute_ke_atom.cpp,
compute_stress_atom.cpp, compute_property_atom.cpp, compute_reduce.cpp,
compute_chunk_atom.cpp, compute_erotate_sphere.cpp).

A compute is evaluated on the device from the current state in tag order
(``md/peratom.py``) and returns a float64 tensor there: a () scalar, a
global vector or array, or per-atom (natoms,) / (natoms, k) columns.  Each
value is computed once per state (``peratom.cached``), however many
consumers read it (thermo, a dump, a fix ave, another compute).  Thermo
packs the scalars and vector entries it prints into its one read of the
device; dumps and fix ave files read theirs at their own steps.

A compute with a reference state (msd, vacf, displace/atom, msd/chunk,
msd/nongauss) keeps it by tag, taken at the first set-up after the compute
is defined: a re-bin, a new set-up and atoms that fix pour or deposit add
(whose reference is taken when first seen) leave it in place.
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.md import computes as gcomp
from tpumd_torch.md import peratom as pa


class Compute:
    # scalar: c_ID is a global scalar; otherwise a vector, an array or
    # per-atom columns
    scalar = True
    peratom = False
    # extensive: thermo_modify norm yes divides thermo's c_ID by the atoms
    extensive = False

    def __init__(self, cid, group, args=()):
        self.id = cid
        self.group = group
        self.args = list(args)

    def setup(self, sim):
        """At each set-up: raise on what the run cannot give, take a
        reference state not yet taken."""

    def evaluate(self, sim):
        raise NotImplementedError

    def __call__(self, sim):
        """The value of the current state, computed once per state."""
        return pa.cached(sim, ("compute", self.id, id(self)),
                         lambda: self.evaluate(sim))

    def scalar_value(self, sim):
        """c_ID in thermo and equal-style formulas."""
        out = self(sim)
        if out.dim() != 0:
            raise ValueError(f"compute {self.id} ({self.style}) has no "
                             "scalar")
        return out

    def vector_value(self, sim):
        """The global vector c_ID[i] indexes."""
        out = self(sim)
        if out.dim() != 1 or self.peratom:
            raise ValueError(f"compute {self.id} ({self.style}) has no "
                             "global vector")
        return out

    def sel(self, sim):
        return pa.group_sel(sim, self.group)


class RefByTag:
    """A per-atom reference (natoms, k) kept by tag: values are taken for
    tags not yet seen, so atoms added later get theirs when first
    evaluated."""

    def __init__(self):
        self.table = None       # (maxtag + 1, k) float64 by tag
        self.known = None       # (maxtag + 1,) bool

    def take(self, tags, values):
        """Store values of tags not yet known."""
        top = int(tags.max()) + 1
        if self.table is None:
            self.table = values.new_zeros((top,) + tuple(values.shape[1:]))
            self.known = torch.zeros(top, dtype=torch.bool,
                                     device=values.device)
        elif top > self.table.shape[0]:
            grow = top - self.table.shape[0]
            self.table = torch.cat([self.table, self.table.new_zeros(
                (grow,) + tuple(self.table.shape[1:]))])
            self.known = torch.cat([self.known, self.known.new_zeros(grow)])
        t = tags.long()
        fresh = ~self.known[t]
        self.table[t] = torch.where(
            fresh.reshape((-1,) + (1,) * (values.dim() - 1)), values,
            self.table[t])
        self.known[t] = True

    def of(self, tags, values):
        """The references of tags (taking those not yet known)."""
        self.take(tags, values)
        return self.table[tags.long()]


def temperature(sim, group="all"):
    a = pa.atoms(sim)
    if group != "all":
        raise ValueError("compute temp on a group is not ported (tpumd's "
                         "compute temp reads thermo's)")
    return gcomp.temperature(a.v, a.mass, sim.dof(), sim.units.boltz,
                             sim.units.mvv2e)


def potential_energy(sim):
    """The total potential energy, extensive (thermo's pe times the atoms
    under norm yes)."""
    e, _ = sim.current_energies()
    tot = sum(v.to(torch.float64) for v in e.values())
    if sim.pair is not None and sim.pair.tail_flag:
        tot = tot + sim.pair.etail / pa.atoms(sim).lengths.prod()
    return tot


class ComputeTemp(Compute):
    style = "temp"

    def evaluate(self, sim):
        return temperature(sim, self.group)


class ComputePE(Compute):
    """compute pe: tpumd reads thermo's pe (normalized under norm yes)."""

    style = "pe"

    def evaluate(self, sim):
        pe = potential_energy(sim)
        return pe / sim.natoms if sim.thermo_norm else pe


class ComputeKE(Compute):
    style = "ke"

    def evaluate(self, sim):
        ke = gcomp.kinetic_energy(temperature(sim), sim.dof(),
                                  sim.units.boltz)
        return ke / sim.natoms if sim.thermo_norm else ke


class ComputePressure(Compute):
    """compute pressure: thermo's scalar pressure (tpumd takes no
    arguments' meaning; they are ignored, as there)."""

    style = "pressure"

    def evaluate(self, sim):
        _, vir = sim.current_energies()
        a = pa.atoms(sim)
        u = sim.units
        vol = a.lengths.prod()
        ptail = 0.0
        if sim.pair is not None and sim.pair.tail_flag:
            ptail = sim.dimension * sim.pair.ptail / vol
        return gcomp.pressure(temperature(sim), vir[:3].sum().double(), vol,
                              sim.dof(), u.boltz, u.nktv2p, ptail,
                              sim.dimension)


class ComputeCOM(Compute):
    style = "com"
    scalar = False

    def evaluate(self, sim):
        a = pa.atoms(sim)
        return (a.mass[:, None] * a.xu).sum(0) / a.mass.sum()


class ComputeMSD(Compute):
    """Mean-squared displacement from the unwrapped positions at the first
    set-up (src/compute_msd.cpp): dx2 dy2 dz2 total."""

    style = "msd"
    scalar = False

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        self.ref = RefByTag()

    def setup(self, sim):
        a = pa.atoms(sim)
        self.ref.take(a.tag, a.xu)

    def evaluate(self, sim):
        a = pa.atoms(sim)
        d = a.xu - self.ref.of(a.tag, a.xu)
        m = (d * d).mean(0)
        return torch.cat([m, m.sum()[None]])


class ComputeVACF(Compute):
    style = "vacf"
    scalar = False

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        self.ref = RefByTag()

    def setup(self, sim):
        a = pa.atoms(sim)
        self.ref.take(a.tag, a.v)

    def evaluate(self, sim):
        a = pa.atoms(sim)
        m = (a.v * self.ref.of(a.tag, a.v)).mean(0)
        return torch.cat([m, m.sum()[None]])


def erotate_sphere(s, groupbit: int, mvv2e: float):
    """() rotational kinetic energy of the state's spheres in a group:
    1/2 * 2/5 m r^2 |omega|^2 * mvv2e summed (src/compute_erotate_sphere.
    cpp:44-72); empty slots have rmass 0 and add nothing."""
    if s.omega is None:
        raise ValueError("compute erotate/sphere needs atom_style sphere")
    e = torch.sum(s.omega * s.omega, dim=1) * s.radius * s.radius * s.rmass
    if groupbit != 1:
        e = torch.where((s.gmask & groupbit) > 0, e, 0.0)
    return 0.5 * mvv2e * 0.4 * torch.sum(e)


class ComputeERotateSphere(Compute):
    """compute erotate/sphere; extensive, as the reference's extscalar =
    1 (thermo_modify norm yes divides it by the atoms)."""

    style = "erotate/sphere"
    extensive = True

    def evaluate(self, sim):
        bit = 1 if self.group == "all" else sim.groups[self.group]
        return erotate_sphere(pa.current(sim)[0], bit,
                              sim.units.mvv2e).to(torch.float64)


class ComputeGyration(Compute):
    style = "gyration"

    def evaluate(self, sim):
        a = pa.atoms(sim)
        m = a.mass
        com = (m[:, None] * a.xu).sum(0) / m.sum()
        return torch.sqrt((m * ((a.xu - com) ** 2).sum(1)).sum() / m.sum())


class ComputePEAtom(Compute):
    """Per-atom potential energy, pair + bonded (src/compute_pe_atom.cpp;
    tpumd's, without kspace and fixes)."""

    style = "pe/atom"
    scalar = False
    peratom = True

    def setup(self, sim):
        pa.check_peratom_style(sim, self.style)

    def evaluate(self, sim):
        eatom, _ = pa.pair_bonded_tallies(sim)
        return torch.where(self.sel(sim), eatom, 0.0)


class ComputeKEAtom(Compute):
    style = "ke/atom"
    scalar = False
    peratom = True

    def evaluate(self, sim):
        a = pa.atoms(sim)
        ke = 0.5 * sim.units.mvv2e * a.mass * (a.v * a.v).sum(1)
        return torch.where(self.sel(sim), ke, 0.0)


class ComputeStressAtom(Compute):
    """Per-atom stress tensor times volume (src/compute_stress_atom.cpp):
    xx yy zz xy xz yz.  tpumd takes the temperature ID (NULL) and no
    keywords: the kinetic, pair and bonded terms always."""

    style = "stress/atom"
    scalar = False
    peratom = True

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        if len(self.args) > 1:
            raise NotImplementedError(
                f"compute stress/atom keywords {self.args[1:]} are not "
                "ported (tpumd takes none)")

    def setup(self, sim):
        pa.check_peratom_style(sim, self.style)

    def evaluate(self, sim):
        return torch.where(self.sel(sim)[:, None], pa.stress_atom(sim), 0.0)


def split_ref(name):
    """(kind c/f/v/d/i or None, id, 0-based column or None or "*")."""
    if len(name) > 2 and name[1] == "_" and name[0] in "cfvdi":
        base, col = name[2:], None
        if "[" in base:
            base, rest = base.split("[", 1)
            rest = rest.rstrip("]")
            col = "*" if rest == "*" else int(rest) - 1
        return name[0], base, col
    return None, name, None


def _column(out, col, what):
    if col is None:
        return out
    if out.dim() < 2:
        raise ValueError(f"{what}: not an array with columns")
    return out[:, col]


def fix_output(sim, fid):
    for fx in sim.fixes:
        if getattr(fx, "id", None) == fid and hasattr(fx, "output"):
            return fx.output(sim)
    raise ValueError(f"no fix {fid} with an output")


def peratom_input(sim, name):
    """A per-atom input in tag order, float64 on the device: c_ID[, col],
    f_ID[, col] (ave/atom, store/state), v_name (atom-style), d_/i_
    (property/atom), or an atom keyword (x, vx, fx, id, type, mass, q, xu,
    ...)."""
    kind, base, col = split_ref(name)
    dev = pa.current(sim)[0].x.device
    if kind == "c":
        c = sim.computes.get(base)
        if c is None:
            raise ValueError(f"no compute {base}")
        return _column(c(sim), col, name)
    if kind == "f":
        out = torch.as_tensor(np.asarray(fix_output(sim, base), np.float64),
                              device=dev)
        return _column(out, col, name)
    if kind == "v":
        return torch.as_tensor(np.asarray(
            sim.script.evaluate_variable(base), np.float64), device=dev)
    if kind in ("d", "i"):
        store = getattr(sim, "custom_peratom", {})
        if name not in store:
            raise ValueError(f"{name}: no fix property/atom defines it")
        a = pa.atoms(sim)
        return torch.as_tensor(store[name], dtype=torch.float64,
                               device=dev)[a.tag.long() - 1]
    out = atom_keyword(sim, name)
    if out is None:
        raise ValueError(f"per-atom input {name!r} is not available")
    return out


_KEYS = {"x": ("x", 0), "y": ("x", 1), "z": ("x", 2),
         "vx": ("v", 0), "vy": ("v", 1), "vz": ("v", 2),
         "fx": ("f", 0), "fy": ("f", 1), "fz": ("f", 2),
         "xu": ("xu", 0), "yu": ("xu", 1), "zu": ("xu", 2),
         "ix": ("image", 0), "iy": ("image", 1), "iz": ("image", 2),
         "omegax": ("omega", 0), "omegay": ("omega", 1),
         "omegaz": ("omega", 2)}


def atom_keyword(sim, name):
    """An atom attribute (compute property/atom, fix store/state, dump
    columns) in tag order, or None if it is not one."""
    a = pa.atoms(sim)
    if name in _KEYS:
        field, c = _KEYS[name]
        t = getattr(a, field)
        return None if t is None else t[:, c].to(torch.float64)
    if name == "id":
        return a.tag.to(torch.float64)
    if name == "type":
        return a.type.to(torch.float64)
    if name == "mass":
        return a.mass
    if name in ("q", "radius") and getattr(a, name) is not None:
        return getattr(a, name)
    if name == "mol" and a.molecule is not None:
        return a.molecule.to(torch.float64)
    return None


class ComputePropertyAtom(Compute):
    style = "property/atom"
    scalar = False
    peratom = True

    def evaluate(self, sim):
        cols = []
        for f in self.args:
            c = (peratom_input(sim, f) if f.startswith(("d_", "i_"))
                 else atom_keyword(sim, f))
            if c is None:
                raise ValueError(f"property/atom field {f!r} not available")
            cols.append(c)
        return cols[0] if len(cols) == 1 else torch.stack(cols, dim=1)


def reduce_fn(mode):
    return {"sum": torch.sum, "min": torch.min, "max": torch.max,
            "ave": torch.mean, "sumsq": lambda a: torch.sum(a * a)}[mode]


class ComputeReduce(Compute):
    """compute reduce sum|min|max|ave|sumsq over per-atom inputs of the
    group (src/compute_reduce.cpp).  sum and sumsq are extensive, as the
    reference's extscalar/extvector (thermo_modify norm divides them)."""

    style = "reduce"

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        self.mode = self.args[0]
        if self.mode not in ("sum", "min", "max", "ave", "sumsq"):
            raise NotImplementedError(f"compute reduce mode {self.mode!r} "
                                      "is not ported")
        self.inputs = self.args[1:]
        self.extensive = self.mode in ("sum", "sumsq")
        self.scalar = len(self.inputs) == 1 and "*" not in self.inputs[0]

    def evaluate(self, sim):
        fn = reduce_fn(self.mode)
        sel = self.sel(sim)
        out = torch.stack([fn(peratom_input(sim, nm)[sel])
                           for nm in expand_wildcards(sim, self.inputs)])
        return out[0] if self.scalar else out


def expand_wildcards(sim, names):
    """c_ID[*] / f_ID[*] expanded to c_ID[1] ... c_ID[n] over the columns
    of the compute's output (per-atom or global array; a per-chunk vector
    is an array of one column), or the entries of a global vector (as the
    reference's utils::expand_args)."""
    out = []
    for nm in names:
        kind, base, col = split_ref(nm)
        if col != "*":
            out.append(nm)
            continue
        src = sim.computes[base] if kind == "c" else None
        val = src(sim) if kind == "c" else np.asarray(fix_output(sim, base))
        shape = tuple(val.shape)
        if len(shape) == 2:
            ncol = shape[1]
        else:
            ncol = 1 if getattr(src, "per_chunk", False) else shape[0]
        out.extend(f"{kind}_{base}[{k}]" for k in range(1, ncol + 1))
    return out


class ComputeChunkAtom(Compute):
    """compute chunk/atom type|molecule|bin/1d: per-atom chunk IDs from 1
    (src/compute_chunk_atom.cpp); ``nchunk`` is set by evaluate."""

    style = "chunk/atom"
    scalar = False
    peratom = True

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        if not self.args or self.args[0] not in ("type", "molecule",
                                                 "bin/1d"):
            raise NotImplementedError(
                f"compute chunk/atom {' '.join(self.args[:1])} is not "
                "ported (only type, molecule, bin/1d)")
        n = {"type": 1, "molecule": 1, "bin/1d": 4}[self.args[0]]
        if len(self.args) > n:
            raise NotImplementedError(
                f"compute chunk/atom keywords {self.args[n:]} are not "
                "ported")
        self.nchunk = 0

    def evaluate(self, sim):
        a = pa.atoms(sim)
        style = self.args[0]
        if style == "type":
            self.nchunk = int(sim.ntypes)
            return a.type.to(torch.float64)
        if style == "molecule":
            if a.molecule is None:
                raise ValueError("compute chunk/atom molecule needs "
                                 "molecule IDs")
            self.nchunk = int(a.molecule.max())
            return a.molecule.to(torch.float64)
        dim = "xyz".index(self.args[1])
        lo, hi = float(a.lo[dim]), float(a.hi[dim])
        origin = lo if self.args[2] == "lower" else (
            hi if self.args[2] == "upper" else float(self.args[2]))
        delta = float(self.args[3])
        ids = torch.floor((a.x[:, dim] - origin) / delta) + 1
        self.nchunk = int(np.ceil((hi - lo) / delta))
        return torch.clamp(ids, 1, self.nchunk)


_STYLES = {c.style: c for c in (
    ComputeTemp, ComputePE, ComputeKE, ComputePressure, ComputeCOM,
    ComputeMSD, ComputeVACF, ComputeGyration, ComputeERotateSphere,
    ComputePEAtom, ComputeKEAtom, ComputeStressAtom, ComputePropertyAtom,
    ComputeReduce, ComputeChunkAtom)}

# compute styles of the reference that tpumd lacks or this port leaves
# out: each raises naming itself
def create_compute(cid, group, style, args=()):
    """A compute of the deck's ``compute ID group style args``."""
    from tpumd_torch.md import compute_chunk, compute_extra, \
        compute_local, compute_pair, compute_struct
    styles = dict(_STYLES)
    for mod in (compute_pair, compute_struct, compute_extra, compute_chunk,
                compute_local):
        styles.update({c.style: c for c in mod.STYLES})
    if style not in styles:
        raise NotImplementedError(f"compute style {style!r} is not ported")
    return styles[style](cid, group, args)

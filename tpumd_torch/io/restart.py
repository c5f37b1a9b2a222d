"""Checkpoint / restart and data-file output.

The port of tpumd/io/restart.py (the reference writes versioned binary
restart files, src/write_restart.cpp:222-394): a checkpoint is an ``.npz``
of the per-atom state, the box and the masses plus a JSON header, in
tpumd's format, so that either package reads the other's files.  The port
writes the atoms in tag order whatever engine held them (the cell grid
keeps them in slot order, with empty slots).  The state of fix nvt, npt
and nph (the Nose-Hoover chains and the barostat) is restored: the deck
declares the fix after read_restart, as in LAMMPS, and its next set-up
takes the saved state by fix ID (``restore_leaves``) where tpumd starts
the chains anew.  Any other fix state (an RNG stream, a rigid body's)
raises on reading, naming the fix.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from tpumd_torch.core.state import EXTRA_FIELDS, Box, make_state, \
    map_per_atom

FORMAT_VERSION = 1
MAGIC = "tpumd-restart"


def tag_ordered(sim):
    """The simulation's atoms in tag order, padding dropped (a run
    decomposed over ranks leaves them gathered in ``sim.state``)."""
    s = (sim.state if sim._carry is None or sim.decomposed
         else sim._carry[0])
    idx = torch.nonzero(s.tag > 0).flatten()
    idx = idx[torch.argsort(s.tag[idx])]
    return map_per_atom(s, lambda a: a[idx])


def _leaves(tree):
    """The tensors and arrays of a fix state, depth first."""
    if tree is None:
        return []
    if isinstance(tree, (torch.Tensor, np.ndarray, float, int)):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    if hasattr(tree, "__dataclass_fields__"):
        return [x for k in tree.__dataclass_fields__
                for x in _leaves(getattr(tree, k))]
    raise TypeError(f"fix state of type {type(tree).__name__}")


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def write_restart(sim, path: str):
    s = tag_ordered(sim)
    n = s.tag.shape[0]
    payload = {
        "x": _np(s.x), "v": _np(s.v), "f": _np(s.f), "type": _np(s.type),
        "tag": _np(s.tag), "image": _np(s.image),
        "box_lo": _np(s.box.lo), "box_hi": _np(s.box.hi),
        "nlocal": np.asarray(n, np.int32), "mass": np.asarray(sim.mass),
    }
    for k in ("q", "molecule", "radius", "rmass", "omega"):
        if getattr(s, k) is not None:
            payload[k] = _np(getattr(s, k))
    for k in EXTRA_FIELDS:
        # an atom style's other fields, named as tpumd names its extras
        if s.ellipsoid is not None and getattr(s, k) is not None:
            payload[f"extra_{k}"] = _np(getattr(s, k))
    fstates = () if sim._carry is None else sim._carry[2]
    for i, fst in enumerate(fstates):
        for j, leaf in enumerate(_leaves(fst)):
            payload[f"fix{i}_{j}"] = _np(leaf)
    header = {
        "magic": MAGIC, "version": FORMAT_VERSION,
        "step": sim.step, "units": sim.units.name, "dt": sim.dt,
        "natoms": sim.natoms, "ntypes": sim.ntypes,
        # a host RNG stream (fix langevin's "lammps" draws) is state the
        # port does not write: marked, so that reading the file raises
        "rng": [{"stream": "not written"} if hasattr(fx, "_stream")
                else None for fx in sim.fixes],
        "fixes": [f"{fx.id} {getattr(fx, 'name', type(fx).__name__)}"
                  for fx in sim.fixes],
        "boundary": list(sim.boundary),
    }
    payload["header"] = np.frombuffer(json.dumps(header).encode(),
                                      dtype=np.uint8)
    np.savez_compressed(path, **payload)


# the fix styles whose state a restart file restores
RESTORABLE = ("nh",)


def restore_leaves(template, leaves):
    """template (a fix's fresh state) with its tensors and numbers taken
    from leaves, in the depth-first order ``_leaves`` wrote them."""
    leaves = list(leaves)

    def walk(t):
        if t is None:
            return None
        if isinstance(t, torch.Tensor):
            return torch.as_tensor(leaves.pop(0), dtype=t.dtype,
                                   device=t.device).reshape(t.shape)
        if isinstance(t, np.ndarray):
            return np.asarray(leaves.pop(0))
        if isinstance(t, (int, float)):
            return type(t)(leaves.pop(0))
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(x) for x in t)
        return dataclasses.replace(t, **{k: walk(getattr(t, k))
                                         for k in t.__dataclass_fields__})
    out = walk(template)
    if leaves:
        raise ValueError("restart: the fix state does not match the fix")
    return out


def read_restart(sim, path: str) -> dict:
    """Restore the per-atom state, masses, step and timestep into a
    Simulation whose styles and fixes the deck declares (as the
    reference's read_restart and its input go together)."""
    data = np.load(path)
    header = json.loads(bytes(data["header"]).decode())
    if header.get("magic") != MAGIC:
        raise ValueError(f"{path}: not a tpumd restart file")
    names = header.get("fixes") or [None] * len(header.get("rng", ()))
    carried = sorted({int(k[3:].split("_")[0]) for k in data.files
                      if k.startswith("fix")})
    carried += [i for i, r in enumerate(header.get("rng", ()))
                if r is not None and i not in carried]
    # fix nh's state is kept for the fix of the same ID at the next set-up
    restorable = {}
    for i in list(carried):
        fid, _, style = (names[i] or "").partition(" ")
        rng = header.get("rng", ())
        if style in RESTORABLE and not (i < len(rng) and rng[i]):
            leaves = [data[k] for k in sorted(
                (k for k in data.files if k.startswith(f"fix{i}_")),
                key=lambda k: int(k.split("_")[1]))]
            restorable[fid] = (style, leaves)
            carried.remove(i)
    if carried:
        who = []
        for i in carried:
            name = names[i] if i < len(names) and names[i] else None
            if name is None and i < len(sim.fixes):
                fx = sim.fixes[i]
                name = f"{fx.id} {getattr(fx, 'name', type(fx).__name__)}"
            who.append(f"fix {name or i}")
        raise NotImplementedError(
            f"{path}: {', '.join(who)} carries state (an RNG stream or "
            "a constraint virial); restoring it from a restart file is not "
            "ported (fix nvt, npt and nph are)")
    sim.invalidate_ctx()
    sim._fstate_stash = {}
    sim.restart_fstates = restorable
    tag = data["tag"]
    rows = np.nonzero(tag > 0)[0]
    if "boundary" in header:
        sim.boundary = tuple(header["boundary"])
    periodic = tuple(t == "p" for t in sim.boundary)
    box = Box.orthogonal(data["box_lo"], data["box_hi"], device=sim.device,
                         dtype=sim.dtype, periodic=periodic)

    def opt(k):
        return data[k][rows] if k in data.files else None
    sim.mass = np.asarray(data["mass"], np.float64)
    sim.ntypes = int(header["ntypes"])
    sim.state = make_state(
        data["x"][rows], data["v"][rows], data["type"][rows], box,
        tags=tag[rows], image=data["image"][rows], q=opt("q"),
        molecule=opt("molecule"), radius=opt("radius"), rmass=opt("rmass"),
        omega=opt("omega"), extras={k[6:]: data[k][rows] for k in data.files
                                    if k.startswith("extra_")},
        device=sim.device, dtype=sim.dtype)
    sim.state = sim.state.replace(f=torch.as_tensor(
        data["f"][rows], dtype=sim.dtype, device=sim.device))
    sim._natoms = None
    sim.step = int(header["step"])
    sim.dt = float(header["dt"])
    return header


def write_data(sim, path: str):
    """Text data file (the subset of src/write_data.cpp that
    tpumd/io/restart.py writes): header, masses, atoms, velocities and
    the topology, atoms in tag order."""
    s = tag_ordered(sim)
    x, v = _np(s.x).astype(np.float64), _np(s.v).astype(np.float64)
    tag, typ = _np(s.tag), _np(s.type)
    lo, hi = _np(s.box.lo), _np(s.box.hi)
    q = None if s.q is None else _np(s.q)
    mol = None if s.molecule is None else _np(s.molecule)
    topo = sim.topology or {}
    kinds = (("bond", "bonds"), ("angle", "angles"),
             ("dihedral", "dihedrals"), ("improper", "impropers"))
    with open(path, "w") as f:
        f.write(f"LAMMPS data file via tpu-md, timestep = {sim.step}\n\n")
        f.write(f"{len(tag)} atoms\n")
        for kind, hdr in kinds:
            if kind in topo:
                f.write(f"{len(topo[kind])} {hdr}\n")
        f.write(f"\n{sim.ntypes} atom types\n")
        for kind, _ in kinds:
            nt = sim.bonded_ntypes.get(kind)
            if nt:
                f.write(f"{nt} {kind} types\n")
        for d, ax in enumerate("xyz"):
            f.write(("\n" if d == 0 else "")
                    + f"{lo[d]:.16g} {hi[d]:.16g} {ax}lo {ax}hi\n")
        f.write("\nMasses\n\n")
        for t in range(1, sim.ntypes + 1):
            f.write(f"{t} {sim.mass[t]:.16g}\n")
        f.write("\nAtoms\n\n")
        for i in range(len(tag)):
            parts = [str(tag[i])]
            if mol is not None:
                parts.append(str(mol[i]))
            parts.append(str(typ[i]))
            if q is not None:
                parts.append(f"{q[i]:.16g}")
            parts += [f"{x[i, d]:.16g}" for d in range(3)]
            f.write(" ".join(parts) + "\n")
        f.write("\nVelocities\n\n")
        for i in range(len(tag)):
            f.write(f"{tag[i]} " + " ".join(
                f"{v[i, d]:.16g}" for d in range(3)) + "\n")
        for kind, hdr in kinds:
            if kind in topo:
                f.write(f"\n{hdr.capitalize()}\n\n")
                for j, row in enumerate(topo[kind]):
                    f.write(f"{j + 1} " + " ".join(str(int(t)) for t in row)
                            + "\n")

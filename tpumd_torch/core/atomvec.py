"""Atom styles: per-atom fields and the data-file column layout.

The port's copy of tpumd/core/atomvec.py (the reference's AtomVec field
lists, src/atom_vec.h:62-80) for the styles it runs: ``atomic`` (``id type x y z [ix iy iz]``),
``charge`` (``id type q x y z [ix iy iz]``, with the charge, 0 for atoms
that create_atoms makes),
``bond``, ``angle`` and ``molecular`` (``id mol type x y z [ix iy
iz]``, with the molecule ID as a per-atom field: the layout of
src/MOLECULE/atom_vec_bond.cpp, atom_vec_angle.cpp and
atom_vec_molecular.cpp, which differ in the topologies they carry),
``full`` (``id mol type q x y z [ix iy iz]``, with the
molecule ID and the charge), ``sphere`` (``id type diameter density x
y z [ix iy iz]``, with the radius, the per-atom mass, the angular velocity
read from the Velocities section's last three columns, and the torque)
and ``ellipsoid`` (``id type ellipsoidflag density x y z [ix iy iz]``,
src/atom_vec_ellipsoid.cpp: the flag, the per-atom mass, the semi-axes
``shape`` and unit quaternion ``quat`` from the Ellipsoids section, the
angular momentum ``angmom`` from the Velocities section's last three
columns, and the torque).  tpumd has no aspherical pair style or
integrator: an ellipsoid deck runs its atoms as points of their mass.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Field:
    """One per-atom array: (N,) when width == 1, else (N, width)."""

    name: str
    kind: str = "float"          # "float" | "int"
    width: int = 1
    default: float = 0.0


@dataclasses.dataclass(frozen=True)
class AtomStyle:
    """Field set and Atoms-line layout of one atom style: data_atom(cols)
    takes the tokens after the id column and returns {field: value}
    including "type", "x" and "_imgcol" (where the image flags start);
    data_vel, where set, takes the Velocities tokens after vx vy vz."""

    name: str
    data_atom: callable
    fields: tuple = ()
    data_vel: callable = None
    # bonus sections by name: hook(fields, tokens, row), after Atoms
    sections: dict = dataclasses.field(default_factory=dict)


def _simple_layout(has_mol=False, has_q=False):
    def parse(r):
        out = {}
        col = 0
        if has_mol:
            out["molecule"] = int(r[col])
            col += 1
        out["type"] = int(r[col])
        col += 1
        if has_q:
            out["q"] = float(r[col])
            col += 1
        out["x"] = [float(r[col]), float(r[col + 1]), float(r[col + 2])]
        out["_imgcol"] = col + 3
        return out
    return parse


def _sphere_data_atom(r):
    """id type diameter density x y z (AtomVecSphere::data_atom_post,
    src/atom_vec_sphere.cpp): rmass = pi/6 density d^3, or the density
    itself as the mass when d == 0."""
    diam, dens = float(r[1]), float(r[2])
    return {"type": int(r[0]), "radius": 0.5 * diam,
            "rmass": np.pi / 6.0 * dens * diam ** 3 if diam > 0 else dens,
            "x": [float(r[3]), float(r[4]), float(r[5])], "_imgcol": 6}


def _sphere_data_vel(r):
    if len(r) != 3:
        raise ValueError(f"sphere Velocities line needs wx wy wz, got {r}")
    return {"omega": [float(r[0]), float(r[1]), float(r[2])]}


def _ellipsoid_data_atom(r):
    """id type ellipsoidflag density x y z (atom_vec_ellipsoid.cpp:65):
    the density stands in rmass until the Ellipsoids section makes it a
    mass; with flag 0 it is the mass."""
    return {"type": int(r[0]), "ellipsoid": int(r[1]), "rmass": float(r[2]),
            "x": [float(r[3]), float(r[4]), float(r[5])], "_imgcol": 6}


def _ellipsoid_data_vel(r):
    return {"angmom": [float(r[0]), float(r[1]), float(r[2])]} if r else {}


def _ellipsoid_bonus(fields, r, k):
    """id shapex shapey shapez quatw quati quatj quatk
    (AtomVecEllipsoid::data_atom_bonus, atom_vec_ellipsoid.cpp:386-418):
    the semi-axes, the normalised quaternion, and rmass = density
    4 pi / 3 a b c."""
    shape = [0.5 * float(r[1]), 0.5 * float(r[2]), 0.5 * float(r[3])]
    quat = np.asarray([float(t) for t in r[4:8]])
    fields["shape"][k] = shape
    fields["quat"][k] = quat / np.sqrt((quat * quat).sum())
    fields["rmass"][k] *= 4.0 * np.pi / 3.0 * shape[0] * shape[1] * shape[2]


STYLES = {
    "atomic": AtomStyle("atomic", data_atom=_simple_layout()),
    "charge": AtomStyle("charge", data_atom=_simple_layout(has_q=True),
                        fields=(Field("q"),)),
    **{name: AtomStyle(name, data_atom=_simple_layout(has_mol=True),
                       fields=(Field("molecule", "int"),))
       for name in ("bond", "angle", "molecular")},
    "full": AtomStyle("full", data_atom=_simple_layout(has_mol=True,
                                                       has_q=True),
                      fields=(Field("molecule", "int"), Field("q"))),
    "sphere": AtomStyle("sphere", data_atom=_sphere_data_atom,
                        data_vel=_sphere_data_vel,
                        fields=(Field("radius"), Field("rmass"),
                                Field("omega", width=3))),
    "ellipsoid": AtomStyle(
        "ellipsoid", data_atom=_ellipsoid_data_atom,
        data_vel=_ellipsoid_data_vel,
        fields=(Field("rmass"), Field("ellipsoid", "int"),
                Field("shape", width=3), Field("quat", width=4),
                Field("angmom", width=3), Field("torque", width=3)),
        sections={"Ellipsoids": _ellipsoid_bonus}),
}


# the topologies each molecular style carries (AtomVec bonds_allow, ...)
TOPOLOGIES = {"bond": ("bond",), "angle": ("bond", "angle"),
              "molecular": ("bond", "angle", "dihedral", "improper"),
              "full": ("bond", "angle", "dihedral", "improper")}


def get_style(name: str) -> AtomStyle:
    if name not in STYLES:
        raise NotImplementedError(
            f"atom_style {name!r} is not ported (ported: {sorted(STYLES)})")
    return STYLES[name]


def alloc_fields(style: AtomStyle, n: int) -> dict:
    """Host-side zero arrays for every declared field."""
    out = {}
    for f in style.fields:
        dt = np.int32 if f.kind == "int" else np.float64
        shape = (n,) if f.width == 1 else (n, f.width)
        out[f.name] = np.full(shape, f.default, dtype=dt)
    if "quat" in out:
        out["quat"][:, 0] = 1.0     # the identity until a bonus line
    return out

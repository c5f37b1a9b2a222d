"""LAMMPS text data-file reader (host side, setup time).

The part of tpumd/io/read_data.py (the reference's read_data command,
src/read_data.cpp) that the chain and rhodo_class decks need: the header
counts, an orthogonal or triclinic box (the ``xy xz yz`` line), and the
Masses, Atoms (atomic, charge, bond, angle, molecular and full styles,
image flags included), Velocities, Bonds, Angles, Dihedrals and Impropers
sections, and the Pair, Bond, Angle, Dihedral and Improper Coeffs sections
(kept raw for the styles to read, tokens as written); plus
``build_special``.  A molecular style reads the topologies it carries
(atomvec.TOPOLOGIES: angles from atom_style angle on, dihedrals and
impropers for molecular and full) and the coefficient sections.  Any
other section (the class2 cross-term coefficients among them: their
styles read them from angle_coeff, dihedral_coeff and improper_coeff
lines) raises naming itself.  A sphere file (atom_style sphere: ``id type
diameter density x y z`` atoms and ``id vx vy vz wx wy wz`` velocities)
holds only the Atoms and Velocities sections; any other raises.  An
ellipsoid file (atom_style ellipsoid: ``id type ellipsoidflag density x y
z`` atoms, ``id vx vy vz lx ly lz`` velocities) also holds its
Ellipsoids section (the style's bonus section, read after Atoms) and
Masses; the style's fields beyond the named ones ride ``fields``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpumd_torch.core.atomvec import TOPOLOGIES, alloc_fields, get_style

_HEADER_KEYS = [
    ("atoms", "natoms"), ("bonds", "nbonds"), ("angles", "nangles"),
    ("dihedrals", "ndihedrals"), ("impropers", "nimpropers"),
    ("atom types", "natomtypes"), ("bond types", "nbondtypes"),
    ("angle types", "nangletypes"), ("dihedral types", "ndihedraltypes"),
    ("improper types", "nimpropertypes"), ("ellipsoids", "nellipsoids"),
]
# topology sections: (name, attribute, count attribute, atoms per tuple)
_TOPOLOGY = {"Bonds": ("bonds", "nbonds", 2),
             "Angles": ("angles", "nangles", 3),
             "Dihedrals": ("dihedrals", "ndihedrals", 4),
             "Impropers": ("impropers", "nimpropers", 4)}
# coefficient sections, kept raw: (name, count attribute)
_COEFFS = {"Pair Coeffs": "natomtypes", "Bond Coeffs": "nbondtypes",
           "Angle Coeffs": "nangletypes",
           "Dihedral Coeffs": "ndihedraltypes",
           "Improper Coeffs": "nimpropertypes"}
_SECTIONS = ("Masses", "Atoms", "Velocities") + tuple(_TOPOLOGY) \
    + tuple(_COEFFS)
# the sections of a sphere and an ellipsoid file
_ASPHERE_SECTIONS = {"sphere": ("Atoms", "Velocities"),
                     "ellipsoid": ("Masses", "Atoms", "Velocities",
                                   "Ellipsoids")}


@dataclasses.dataclass
class DataFile:
    natoms: int = 0
    nbonds: int = 0
    nangles: int = 0
    ndihedrals: int = 0
    nimpropers: int = 0
    natomtypes: int = 0
    nbondtypes: int = 0
    nangletypes: int = 0
    ndihedraltypes: int = 0
    nimpropertypes: int = 0
    nellipsoids: int = 0
    box_lo: np.ndarray = None
    box_hi: np.ndarray = None
    tilt: np.ndarray | None = None     # (xy, xz, yz) of a triclinic box
    masses: np.ndarray = None          # (ntypes+1,)
    x: np.ndarray = None               # (N,3) in tag order (tag 1..N)
    v: np.ndarray = None
    types: np.ndarray = None
    molecule: np.ndarray = None        # bond and full styles
    q: np.ndarray = None               # full style
    image: np.ndarray = None
    radius: np.ndarray = None          # sphere style
    rmass: np.ndarray = None
    omega: np.ndarray = None
    bonds: np.ndarray = None           # (nb, 3): type, atom1, atom2 (tags)
    angles: np.ndarray = None          # (na, 4)
    dihedrals: np.ndarray = None       # (nd, 5)
    impropers: np.ndarray = None       # (ni, 5)
    # raw rows of the coefficient sections, by section name
    coeffs: dict = dataclasses.field(default_factory=dict)
    # the atom style's other fields (atom_style ellipsoid's), by name
    fields: dict = dataclasses.field(default_factory=dict)


def _header_line(d: DataFile, line: str) -> bool:
    """Consume one header line; False at the first body line."""
    for key, attr in _HEADER_KEYS:
        if line.endswith(" " + key):
            setattr(d, attr, int(line.split()[0]))
            return True
    toks = line.split()
    for c, names in enumerate((["xlo", "xhi"], ["ylo", "yhi"],
                               ["zlo", "zhi"])):
        if len(toks) >= 4 and toks[-2:] == names:
            d.box_lo[c], d.box_hi[c] = float(toks[0]), float(toks[1])
            return True
    if len(toks) >= 6 and toks[3:6] == ["xy", "xz", "yz"]:
        d.tilt = np.array([float(t) for t in toks[:3]])
        return True
    return False


def read_data(path: str, atom_style: str = "atomic") -> DataFile:
    with open(path) as fh:
        lines = fh.readlines()

    d = DataFile(box_lo=np.zeros(3), box_hi=np.ones(3))
    i = 1  # skip the title line
    while i < len(lines):
        line = " ".join(lines[i].split("#", 1)[0].split())
        if line and not _header_line(d, line):
            break
        i += 1
    carried = TOPOLOGIES.get(atom_style, ())
    for kind in ("bond", "angle", "dihedral", "improper"):
        if getattr(d, f"n{kind}s") and kind not in carried:
            raise NotImplementedError(
                f"data file: {getattr(d, f'n{kind}s')} {kind}s with "
                f"atom_style {atom_style}, which carries "
                f"{', '.join(carried) or 'no topology'}")

    n = d.natoms
    d.x = np.zeros((n, 3))
    d.v = np.zeros((n, 3))
    d.types = np.zeros(n, dtype=np.int32)
    d.image = np.zeros((n, 3), dtype=np.int32)
    d.masses = np.zeros(d.natomtypes + 1)
    style = get_style(atom_style)
    fields = alloc_fields(style, n)

    def parse_rows(start, count):
        rows = []
        j = start
        while len(rows) < count:
            s = lines[j].split("#", 1)[0].strip()
            j += 1
            if s:
                rows.append(s.split())
        return rows, j

    while i < len(lines):
        section = lines[i].split("#", 1)[0].strip()
        i += 1
        if not section:
            continue
        if section not in _SECTIONS + tuple(style.sections) or (
                section in _COEFFS and section != "Pair Coeffs"
                and atom_style not in TOPOLOGIES) or (
                section not in _ASPHERE_SECTIONS.get(atom_style,
                                                     (section,))):
            raise NotImplementedError(
                f"data-file section {section!r} is not ported with "
                f"atom_style {atom_style}")
        if section in style.sections:
            rows, i = parse_rows(i, getattr(d, f"n{section.lower()}"))
            for r in rows:
                style.sections[section](fields, r, int(r[0]) - 1)
        elif section == "Masses":
            rows, i = parse_rows(i, d.natomtypes)
            for r in rows:
                d.masses[int(r[0])] = float(r[1])
        elif section == "Atoms":
            rows, i = parse_rows(i, n)
            for r in rows:
                k = int(r[0]) - 1
                parsed = style.data_atom(r[1:])
                imgcol = parsed.pop("_imgcol") + 1
                d.types[k] = parsed.pop("type")
                d.x[k] = parsed.pop("x")
                for name, val in parsed.items():
                    fields[name][k] = val
                if len(r) >= imgcol + 3:
                    d.image[k] = [int(r[imgcol]), int(r[imgcol + 1]),
                                  int(r[imgcol + 2])]
        elif section == "Velocities":
            rows, i = parse_rows(i, n)
            for r in rows:
                k = int(r[0]) - 1
                d.v[k] = [float(r[1]), float(r[2]), float(r[3])]
                if style.data_vel is not None:
                    for name, val in style.data_vel(r[4:]).items():
                        fields[name][k] = val
        elif section in _TOPOLOGY:
            attr, count_attr, arity = _TOPOLOGY[section]
            count = getattr(d, count_attr)
            rows, i = parse_rows(i, count)
            arr = np.zeros((count, 1 + arity), dtype=np.int64)
            for r in rows:
                arr[int(r[0]) - 1] = [int(t) for t in r[1:2 + arity]]
            setattr(d, attr, arr)
        else:  # coefficients, read by the styles
            rows, i = parse_rows(i, getattr(d, _COEFFS[section]))
            d.coeffs[section] = rows
    for name in ("molecule", "q", "radius", "rmass", "omega"):
        setattr(d, name, fields.pop(name, None))
    d.fields = fields
    return d


def build_special(nlocal: int, bonds: np.ndarray):
    """1-2/1-3/1-4 special-neighbor lists from the bond topology.

    Serial equivalent of the reference's construction (src/special.cpp:
    57-125), as tpumd/io/read_data.py::build_special: onetwo from bonds
    (both directions), onethree = two hops, onefour = three hops; a pair
    keeps its closest classification.  Returns (special_tags (N, S) int32
    0-padded, special_codes (N, S) with 1/2/3).
    """
    adj = [[] for _ in range(nlocal + 1)]
    for _, a, b in bonds:
        adj[a].append(b)
        adj[b].append(a)

    tags_list = []
    codes_list = []
    maxs = 1
    for i in range(1, nlocal + 1):
        onetwo = list(dict.fromkeys(adj[i]))
        s12 = set(onetwo)
        onethree = list(dict.fromkeys(
            k for j in onetwo for k in adj[j] if k != i and k not in s12))
        s13 = set(onethree)
        onefour = list(dict.fromkeys(
            k for j in onethree for k in adj[j]
            if k != i and k not in s12 and k not in s13))
        tags_list.append(onetwo + onethree + onefour)
        codes_list.append([1] * len(onetwo) + [2] * len(onethree)
                          + [3] * len(onefour))
        maxs = max(maxs, len(tags_list[-1]))

    tags = np.zeros((nlocal, maxs), dtype=np.int32)
    codes = np.zeros((nlocal, maxs), dtype=np.int32)
    for i, (t, c) in enumerate(zip(tags_list, codes_list)):
        tags[i, :len(t)] = t
        codes[i, :len(c)] = c
    return tags, codes

"""Dump writers: per-atom snapshots in LAMMPS's text and binary formats.

The port of tpumd/io/dump.py's ``Dump`` (the reference's dump atom and
dump custom, src/dump_atom.cpp, src/dump_custom.cpp): the chosen columns
of the atoms of a group, optionally sorted by ID, into one file or one
file a step (a ``*`` in the name).  A name ending in ``.bin`` writes the
reference's binary format (DumpAtom::header_binary and write_binary,
src/dump_atom.cpp:181-276, :573-578), which its tools/binary2txt reads.  On
the cell grid the atoms sit in slot order with empty slots between them: a
dump drops the empty slots and, with ``sort id``, orders the rest by tag.
A writer reads the state to the host at its own steps, which the run loop
ends segments at.  dump custom also takes the analysis layer's per-atom
columns: c_ID and c_ID[i] (a per-atom compute), f_ID and f_ID[i] (fix
ave/atom, store/state), v_name (an atom-style variable) and d_name /
i_name (fix property/atom), each read in tag order and matched to the
rows by tag.

``DumpLocal`` (src/dump_local.cpp) writes the rows of local computes,
``DumpCFG`` (src/dump_cfg.cpp) AtomEye's extended CFG snapshots and
``DumpGrid`` (src/dump_grid.cpp) fix ave/grid's cells; ``make_dump`` picks
the writer of a dump command (io/dump_image.py has image and movie).
"""

from __future__ import annotations

import struct

import numpy as np

_XYZ = "xyz"
# the columns a dump writes as integers
_INT_FIELDS = {"id", "type", "mol", "ix", "iy", "iz"}
_FIELDS = ({"id", "type", "mol", "q", "radius"}
           | {a + s for a in _XYZ for s in ("", "s", "u")}
           | {p + a for p in ("v", "f", "i", "omega") for a in _XYZ})


def _analysis_column(name):
    """Whether a dump custom field is a per-atom column of the analysis
    layer: c_, f_, v_, d_ or i_."""
    return len(name) > 2 and name[1] == "_" and name[0] in "cfvdi"


class Dump:
    """dump ID group atom|custom N file [fields] and its dump_modify
    keywords format float, sort, first and every."""

    float_fmt = "%.8g"

    def __init__(self, dump_id, group, style, every, path, fields=None,
                 groupbit=1):
        self.id = dump_id
        self.style = style
        self.every = int(every)
        self.path = path
        self.groupbit = groupbit
        self.sort = False
        self.first = False
        self.last_step = None      # the step of the last snapshot written
        self._opened = False
        if style == "atom":
            self.fields = ["id", "type", "xs", "ys", "zs"]
        elif style == "custom":
            self.fields = list(fields or ())
            bad = [f for f in self.fields
                   if f not in _FIELDS and not _analysis_column(f)]
            if not self.fields or bad:
                raise NotImplementedError(
                    f"dump {dump_id} custom fields {bad or 'none'} are not "
                    f"ported (only {' '.join(sorted(_FIELDS))} and c_, f_, "
                    "v_, d_, i_ columns)")
        else:
            self.fields = list(fields or ())
        if path.endswith(".gz"):
            raise NotImplementedError(
                f"dump {dump_id}: gzipped dumps are not ported (text and "
                ".bin only)")

    def modify(self, args):
        """dump_modify keywords (Dump::modify_params, src/dump.cpp)."""
        i = 0
        while i < len(args):
            key = args[i]
            if key == "sort":
                if args[i + 1] not in ("id", "off"):
                    raise NotImplementedError(
                        f"dump_modify sort {args[i + 1]} is not ported")
                self.sort = args[i + 1] == "id"
                i += 2
            elif key == "format" and args[i + 1] == "float":
                self.float_fmt = args[i + 2]
                i += 3
            elif key == "first":
                self.first = args[i + 1] == "yes"
                i += 2
            elif key == "every":
                self.every = int(args[i + 1])
                i += 2
            elif key == "flush":
                i += 2   # every snapshot is closed after writing
            else:
                raise NotImplementedError(
                    f"dump_modify {' '.join(args[i:i + 2])} is not ported")

    def due(self, step: int, setup: bool) -> bool:
        """Whether a snapshot is due at step: a multiple of every not yet
        written, or at a run's set-up with first yes and nothing written
        yet (Output::setup, src/output.cpp)."""
        if self.last_step == step:
            return False
        if self.every > 0 and step % self.every == 0:
            return True
        return setup and self.first and self.last_step is None

    def _columns(self, sim):
        s = sim.state
        tag = s.tag.cpu().numpy()
        sel = tag > 0
        if self.groupbit != 1:
            sel &= (s.gmask.cpu().numpy() & self.groupbit) > 0
        order = np.nonzero(sel)[0]
        if self.sort:
            order = order[np.argsort(tag[order])]
        lo = s.box.lo.cpu().numpy().astype(np.float64)
        hi = s.box.hi.cpu().numpy().astype(np.float64)
        ell = hi - lo
        host = {}

        def field(name):
            if name not in host:
                a = getattr(s, name)
                if a is None:
                    raise ValueError(f"dump {self.id}: the atoms have no "
                                     f"{name}")
                host[name] = a.detach().cpu().numpy()[order]
            return host[name]
        cols = {}
        by_tag = None
        for name in self.fields:
            if _analysis_column(name):
                if by_tag is None:
                    # each dumped row's place in tag order
                    by_tag = np.searchsorted(np.sort(tag[tag > 0]),
                                             tag[order])
                cols[name] = self._analysis(sim, name)[by_tag]
            elif name == "id":
                cols[name] = tag[order]
            elif name == "type":
                cols[name] = field("type")
            elif name == "mol":
                cols[name] = field("molecule")
            elif name in ("q", "radius"):
                cols[name] = field(name)
            elif name in _XYZ:
                cols[name] = field("x")[:, _XYZ.index(name)]
            elif name[1:] == "s":
                # (x - lo) times the inverse length, as the reference's
                # pack_scale does: bit for bit in its binary dumps
                d = _XYZ.index(name[0])
                cols[name] = (field("x")[:, d] - lo[d]) * (1.0 / ell[d])
            elif name[1:] == "u":
                d = _XYZ.index(name[0])
                cols[name] = (field("x")[:, d].astype(np.float64)
                              + field("image")[:, d] * ell[d])
            elif name.startswith("omega"):
                cols[name] = field("omega")[:, _XYZ.index(name[-1])]
            else:
                key = {"v": "v", "f": "f", "i": "image"}[name[0]]
                cols[name] = field(key)[:, _XYZ.index(name[1])]
        return cols, lo, hi, len(order)

    def _analysis(self, sim, name):
        """(natoms,) float64 tag-order values of a c_/f_/v_/d_/i_ column."""
        from tpumd_torch.md.fix_ave import resolve_input
        out = resolve_input(sim, name)
        if out.ndim != 1 or out.shape[0] != sim.natoms:
            raise ValueError(f"dump {self.id} {name}: not a per-atom vector "
                             f"(shape {out.shape})")
        return out

    def _target(self, sim):
        """(path, mode) of this step's snapshot: a single file is
        truncated at its first snapshot; a file a step holds one."""
        mode = "w" if ("*" in self.path or not self._opened) else "a"
        self._opened = True
        self.last_step = sim.step
        return self.path.replace("*", str(sim.step)), mode

    def write(self, sim):
        cols, lo, hi, n = self._columns(sim)
        path, mode = self._target(sim)
        if path.endswith(".bin"):
            return self._write_binary(sim, cols, lo, hi, n, path, mode)
        bounds = " ".join(t if len(t) == 2 else t * 2 for t in sim.boundary)
        with open(path, mode) as fh:
            fh.write("ITEM: TIMESTEP\n%d\n" % sim.step)
            fh.write("ITEM: NUMBER OF ATOMS\n%d\n" % n)
            fh.write(f"ITEM: BOX BOUNDS {bounds}\n")
            for d in range(3):
                fh.write(f"{lo[d]:.16e} {hi[d]:.16e}\n")
            fh.write("ITEM: ATOMS " + " ".join(self.fields) + "\n")
            mat = np.column_stack([np.asarray(cols[f], np.float64)
                                   for f in self.fields])
            fmt = " ".join("%d" if f in _INT_FIELDS or f.startswith("i_")
                           else self.float_fmt for f in self.fields) + "\n"
            # one formatting of every row at once: np.savetxt's text, ~2.4x
            # faster (it formats and writes row by row)
            fh.write((fmt * n) % tuple(mat.ravel().tolist()))

    def _write_binary(self, sim, cols, lo, hi, n, path, mode):
        """One snapshot in the reference's binary layout, little-endian:
        the magic string, endianness and revision, step and count, the
        boundary codes and box, the column count and names, then one chunk
        of float64 rows (tpumd/io/dump.py:126-172)."""
        magic = b"DUMPCUSTOM" if self.style == "custom" else b"DUMPATOM"
        code = {"p": 0, "f": 1, "s": 2, "m": 3}
        bounds = [code[tok[k] if len(tok) > 1 else tok[0]]
                  for tok in sim.boundary for k in (0, 1)]
        tilt = sim.state.box.tilt
        mat = np.column_stack([np.asarray(cols[f], np.float64)
                               for f in self.fields])
        names = " ".join(self.fields).encode()
        with open(path, mode + "b") as fh:
            fh.write(struct.pack("<q", -len(magic)) + magic)
            fh.write(struct.pack("<iiqqi", 1, 2, sim.step, n,
                                 int(tilt is not None)))
            fh.write(struct.pack("<6i", *bounds))
            fh.write(struct.pack("<6d", lo[0], hi[0], lo[1], hi[1], lo[2],
                                 hi[2]))
            if tilt is not None:
                fh.write(struct.pack(
                    "<3d", *tilt.detach().cpu().double().tolist()))
            # columns, no unit style, no time; one chunk
            fh.write(struct.pack("<iibi", len(self.fields), 0, 0,
                                 len(names)) + names)
            fh.write(struct.pack("<ii", 1, mat.size))
            fh.write(mat.astype("<f8").tobytes())


def _local_column(sim, name):
    """(rows,) float64 column of a c_ID[i] or f_ID[i] reference (a local
    compute's rows, or its only column)."""
    from tpumd_torch.md.compute_styles import split_ref
    kind, base, col = split_ref(name)
    if kind == "c":
        if base not in sim.computes:
            raise ValueError(f"dump local {name}: no compute {base}")
        out = sim.computes[base](sim)
    elif kind == "f":
        fx = [f for f in sim.fixes if getattr(f, "id", None) == base]
        if not fx:
            raise ValueError(f"dump local {name}: no fix {base}")
        out = fx[0].output(sim)
    else:
        raise ValueError(f"dump local field {name!r} must be index, c_ID "
                         "or f_ID")
    out = np.asarray(out.detach().cpu().numpy() if hasattr(out, "detach")
                     else out, np.float64)
    if out.ndim == 1:
        out = out[:, None]
    return out[:, 0 if col is None else col]


class DumpLocal(Dump):
    """dump ID group local N file index c_ID[i] f_ID[i] ...: one row per
    entry of local computes (src/dump_local.cpp), every column the same
    length, written as the reference writes them (%g)."""

    float_fmt = "%g"

    def __init__(self, dump_id, group, style, every, path, fields=None,
                 groupbit=1):
        super().__init__(dump_id, group, "local", every, path,
                         fields=list(fields or ()) or ["index"],
                         groupbit=groupbit)

    def write(self, sim):
        cols = {f: _local_column(sim, f) for f in self.fields
                if f != "index"}
        lens = {len(c) for c in cols.values()}
        if len(lens) > 1:
            raise ValueError(f"dump {self.id}: local columns disagree on "
                             f"their length ({sorted(lens)})")
        nrows = lens.pop() if lens else 0
        cols["index"] = np.arange(1, nrows + 1, dtype=np.float64)
        s = sim.state
        lo = s.box.lo.cpu().numpy().astype(np.float64)
        hi = s.box.hi.cpu().numpy().astype(np.float64)
        path, mode = self._target(sim)
        with open(path, mode) as fh:
            fh.write(f"ITEM: TIMESTEP\n{sim.step}\n"
                     f"ITEM: NUMBER OF ENTRIES\n{nrows}\n"
                     "ITEM: BOX BOUNDS pp pp pp\n")
            for d in range(3):
                fh.write(f"{lo[d]:.16e} {hi[d]:.16e}\n")
            fh.write("ITEM: ENTRIES " + " ".join(self.fields) + "\n")
            if nrows:
                mat = np.column_stack([cols[f] for f in self.fields])
                fmt = " ".join([self.float_fmt] * len(self.fields)) + "\n"
                fh.write((fmt * nrows) % tuple(mat.ravel().tolist()))


class DumpCFG(Dump):
    """dump ID group cfg N file mass type xs ys zs [more]: AtomEye extended
    CFG (src/dump_cfg.cpp), the atoms in tag order, one file a snapshot;
    dump_modify element names the types (default C)."""

    def __init__(self, dump_id, group, style, every, path, fields=None,
                 groupbit=1):
        required = ["mass", "type", "xs", "ys", "zs"]
        fields = list(fields or ())
        if fields[:5] != required:
            raise ValueError("dump cfg fields must start with 'mass type xs "
                             "ys zs'")
        super().__init__(dump_id, group, "custom", every, path,
                         fields=required[1:] + fields[5:], groupbit=groupbit)
        self.style = "cfg"
        self.sort = True
        self.elements = None

    def modify(self, args):
        if args and args[0] == "element":
            self.elements = list(args[1:])
            return
        super().modify(args)

    def write(self, sim):
        cols, lo, hi, n = self._columns(sim)
        typ = cols["type"].astype(np.int64)
        mass = sim.mass[typ]
        ell = hi - lo
        t = sim.state.box.tilt
        tilt = (np.zeros(3) if t is None
                else t.detach().cpu().numpy().astype(np.float64))
        aux = self.fields[4:]
        path, _ = self._target(sim)
        with open(path, "w") as fh:
            # DumpCFG::write_header (src/dump_cfg.cpp:114-147): the tilts
            # in the lower triangle
            fh.write(f"Number of particles = {n}\n"
                     "A = 1 Angstrom (basic length-scale)\n"
                     f"H0(1,1) = {ell[0]:g} A\nH0(1,2) = 0 A\n"
                     f"H0(1,3) = 0 A\nH0(2,1) = {tilt[0]:g} A\n"
                     f"H0(2,2) = {ell[1]:g} A\nH0(2,3) = 0 A\n"
                     f"H0(3,1) = {tilt[1]:g} A\nH0(3,2) = {tilt[2]:g} A\n"
                     f"H0(3,3) = {ell[2]:g} A\n.NO_VELOCITY.\n"
                     f"entry_count = {3 + len(aux)}\n")
            for k, name in enumerate(aux):
                fh.write(f"auxiliary[{k}] = {name}\n")
            # DumpCFG::write_lines (src/dump_cfg.cpp:243-267): mass and
            # element lines, then the scaled coordinates and the rest
            rows = np.column_stack([cols[f] for f in self.fields[1:]])
            for i in range(n):
                el = self.elements[typ[i] - 1] if self.elements else "C"
                fh.write(f"{mass[i]:f} \n{el} \n"
                         + " ".join(f"{v:.8g}" for v in rows[i]) + "\n")


class DumpGrid(Dump):
    """dump ID group grid N file f_ID:grid:data[i] f_ID:grid:count ...:
    fix ave/grid's cells (src/dump_grid.cpp), z slowest, x fastest."""

    def __init__(self, dump_id, group, style, every, path, fields=None,
                 groupbit=1):
        fields = list(fields or ())
        bad = [f for f in fields if not f.startswith("f_") or ":" not in f]
        if not fields or bad:
            raise NotImplementedError(
                f"dump grid fields {bad or 'none'} are not ported (only "
                "f_ID:grid:data[i] and f_ID:grid:count)")
        super().__init__(dump_id, group, "grid", every, path, fields=fields,
                         groupbit=groupbit)

    def write(self, sim):
        cols, shape = [], None
        for name in self.fields:
            base, _, data = name[2:].split(":", 2)
            col = None
            if "[" in data:
                data, rest = data.split("[", 1)
                col = int(rest.rstrip("]"))
            fx = [f for f in sim.fixes if getattr(f, "id", None) == base
                  and hasattr(f, "grid_data")]
            if not fx:
                raise ValueError(f"dump grid {name}: no fix ave/grid {base}")
            g = fx[0].grid_data(sim, data, col)
            shape = g.shape
            cols.append(g.reshape(-1))
        nz, ny, nx = shape
        s = sim.state
        lo = s.box.lo.cpu().numpy().astype(np.float64)
        hi = s.box.hi.cpu().numpy().astype(np.float64)
        path, mode = self._target(sim)
        mat = np.column_stack(cols)
        with open(path, mode) as fh:
            fh.write(f"ITEM: TIMESTEP\n{sim.step}\n"
                     "ITEM: BOX BOUNDS pp pp pp\n")
            for d in range(3):
                fh.write(f"{lo[d]:.16e} {hi[d]:.16e}\n")
            fh.write(f"ITEM: DIMENSION\n{sim.dimension}\n"
                     f"ITEM: GRID SIZE nx ny nz\n{nx} {ny} {nz}\n"
                     "ITEM: GRID CELLS " + " ".join(self.fields) + "\n")
            fmt = " ".join([self.float_fmt] * mat.shape[1]) + "\n"
            fh.write((fmt * mat.shape[0]) % tuple(mat.ravel().tolist()))


def make_dump(dump_id, group, style, every, path, args, groupbit=1):
    """The writer of ``dump ID group style N file args``: atom, custom,
    local, cfg, grid, image or movie; any other style raises."""
    if style in ("image", "movie"):
        from tpumd_torch.io.dump_image import DumpImage, DumpMovie
        cls = DumpImage if style == "image" else DumpMovie
        return cls(dump_id, group, style, every, path, args,
                   groupbit=groupbit)
    cls = {"atom": Dump, "custom": Dump, "local": DumpLocal, "cfg": DumpCFG,
           "grid": DumpGrid}.get(style)
    if cls is None:
        raise NotImplementedError(
            f"dump style {style!r} is not ported (only atom, custom, local, "
            "cfg, grid, image and movie)")
    return cls(dump_id, group, style, every, path, args, groupbit=groupbit)

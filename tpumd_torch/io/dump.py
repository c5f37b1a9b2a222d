"""Dump writers: per-atom snapshots in LAMMPS's text format.

The port of tpumd/io/dump.py's ``Dump`` (the reference's dump atom and
dump custom, src/dump_atom.cpp, src/dump_custom.cpp): the chosen columns
of the atoms of a group, optionally sorted by ID, into one file or one
file a step (a ``*`` in the name).  Text only.  On the cell grid the
atoms sit in slot order with empty slots between them: a dump drops the
empty slots and, with ``sort id``, orders the rest by tag.  A writer reads
the state to the host at its own steps, which the run loop ends segments
at.  dump custom also takes the analysis layer's per-atom columns: c_ID
and c_ID[i] (a per-atom compute), f_ID and f_ID[i] (fix ave/atom,
store/state), v_name (an atom-style variable) and d_name / i_name (fix
property/atom), each read in tag order and matched to the rows by tag.
"""

from __future__ import annotations

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
            raise NotImplementedError(
                f"dump style {style!r} is not ported (only atom and custom)")
        if path.endswith((".bin", ".gz")):
            raise NotImplementedError(
                f"dump {dump_id}: binary and gzipped dumps are not ported "
                "(text only)")

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
                d = _XYZ.index(name[0])
                cols[name] = (field("x")[:, d] - lo[d]) / ell[d]
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

    def write(self, sim):
        cols, lo, hi, n = self._columns(sim)
        path = self.path.replace("*", str(sim.step))
        # a single file is truncated at its first snapshot; a file a step
        # holds one snapshot
        mode = "w" if ("*" in self.path or not self._opened) else "a"
        self._opened = True
        self.last_step = sim.step
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

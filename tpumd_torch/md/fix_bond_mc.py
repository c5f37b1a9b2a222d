"""fix bond/break and fix bond/create: bonds that break and form during a
run (src/MC/fix_bond_break.cpp, src/MC/fix_bond_create.cpp).

The port of tpumd/md/fix_bond_mc.py, on the port's own bonded layout: a
bond is a row (type, member, member) of the device tuples that the force
evaluation sums, and a row whose type is 0 is off (LAMMPS's bond_type 0),
which ``compute_tuples`` leaves out for a style a fix marks ``dynamic``.
Both fixes act in ``post_integrate`` of their event steps, as the
reference does, so the event step's force evaluation already sees the
change; the run rebuilds the neighbor matrix that step
(``rebuild_every``), whose special codes then carry the new or dropped
1-2 entry that the fix wrote into the special lists on the card.  The 1-3
and 1-4 entries are made exact on the host at the event's segment end
(``host_every``), where the bond graph holds an atom with two or more
bonds; until then they are the last set-up's.

- bond/break: per atom the farthest bond of its type stretched past Rmax,
  both atoms in the group; it breaks where the choice is mutual.  The
  broken rows' types go to 0 in place.
- bond/create: candidates come from each atom's row of the neighbor matrix
  (the reference walks its half list; tpumd builds a dense N x N matrix),
  so Rmin must lie within the pair cutoff.  Per atom the closest eligible
  partner (the type pair, each role's cap on bonds of the type, not
  already 1-2 special, r < Rmin); a bond forms where the choice is mutual,
  one per atom per event.  The new rows go into a table of fixed room
  beside the data file's bonds (``extra/bond/per/atom`` rows an atom, at
  least one), appended on the card from a device count: no shape changes
  within a run, and at the next set-up the table folds into the topology.

A segment redone after an overflow first puts back the rows its event
changed (``_undo``).  Both run on the matrix engine only; ``prob`` and
type changes raise, as in tpumd (the reference draws RanMars numbers only
for the atoms with a partner, a stream the device step does not keep).
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.core.state import minimum_image
from tpumd_torch.md.fixes import Fix
from tpumd_torch.ops.cellgrid import row2slot_from_tags


class BondMC(Fix):
    """What bond/break and bond/create share: the event schedule, the
    same-step rebuild, the host special pass, the undo of a redone
    segment."""

    needs_step = True
    grid_refusal = "fix bond/break and bond/create run on the matrix engine"

    def __init__(self, nevery, btype):
        self.nevery = self.host_every = self.rebuild_every = int(nevery)
        self.btype = int(btype)
        self._undo = None        # (event step, the rows to restore)
        self.events = []         # (step, bonds changed) of each event

    def init_state(self, s, ctx):
        return 0

    def set_step(self, fstate, istep):
        return istep

    def _bond_style(self, sim):
        style = sim.bonded.get("bond")
        if style is None or not hasattr(style, "bond_fn"):
            raise NotImplementedError(
                f"fix {self.name} needs one bond style with a bond_fn (not "
                "hybrid)")
        if sim._mode != "matrix":
            raise NotImplementedError(
                f"fix {self.name} on the cell grid: it runs on the matrix "
                "engine")
        if sim.shake_fixes():
            raise NotImplementedError(
                f"fix {self.name} beside fix shake or rattle is not ported")
        return style

    def _restore(self, istep):
        """Put back the rows of an event that a redone segment replays."""
        if self._undo is not None and istep <= self._undo[0]:
            self._undo[1]()
            self._undo = None

    def host_end_of_step(self, sim):
        """At the event's segment end: the count of changed bonds read
        back (with the largest bond count of an atom), and where some atom
        has two or more bonds, the 1-3 and 1-4 special entries rebuilt
        from the live bonds on the host."""
        self._undo = None
        changed, most = (int(v) for v in torch.stack(
            [self._changed().to(sim.device),
             self._max_degree(sim).to(sim.device)]).tolist())
        if changed == self._seen:
            return
        self.events.append((sim.step, changed - self._seen))
        self._seen = changed
        if most >= 2:
            sim.refresh_special()

    def _max_degree(self, sim):
        """() int64: the most live bonds of one atom, on the device."""
        deg = None
        for style, tuples in sim._ctx.bonded:
            if style.kind != "bond":
                continue
            live = (tuples[:, 0] > 0).to(torch.int64)
            d = torch.zeros(sim.natoms + 1, dtype=torch.int64,
                            device=tuples.device)
            d.index_add_(0, tuples[:, 1].long(), live)
            d.index_add_(0, tuples[:, 2].long(), live)
            deg = d if deg is None else deg + d
        return deg.max() if deg is not None else torch.zeros(
            (), dtype=torch.int64)

    @staticmethod
    def _drop_special(s, ta, tb, hit):
        """s with the 1-2 entry of each pair (ta, tb) where hit removed from
        both rows (tags as (M,) int64; rows matched by tag)."""
        if s.special_tags is None:
            return s
        n = s.tag.shape[0]
        other = torch.zeros(n + 2, dtype=torch.int64,
                            device=s.tag.device)
        dump = torch.full_like(ta, n + 1)
        other = other.index_put((torch.where(hit, ta, dump),), tb)
        other = other.index_put((torch.where(hit, tb, dump),), ta)
        other[n + 1] = 0
        rowtag = s.tag.long().clamp(max=n)
        p = other[rowtag]
        gone = (s.special_tags.long() == p[:, None]) & (p > 0)[:, None] \
            & (s.special_codes == 1)
        return s.replace(special_tags=torch.where(gone, 0, s.special_tags),
                         special_codes=torch.where(gone, 0, s.special_codes))


class FixBondBreakMC(BondMC):
    """fix ID group bond/break N btype Rmax."""

    name = "bond/break"

    def __init__(self, nevery, btype, rmax, prob=1.0):
        if prob < 1.0:
            raise NotImplementedError(
                "fix bond/break prob is not ported: the reference draws "
                "RanMars numbers only for the atoms with a partner")
        super().__init__(nevery, btype)
        self.cutsq = float(rmax) ** 2
        self._tuples = None
        self._seen = 0

    def attach_bonded(self, sim, entries):
        """Mark the bond style dynamic and keep its device rows, which
        come from the topology's rows in order."""
        style = self._bond_style(sim)
        style.dynamic = True
        self._tuples = next((t for st, t in entries if st is style), None)
        self._seen = 0
        return entries

    def _changed(self):
        if self._tuples is None:
            return torch.zeros((), dtype=torch.int64)
        return torch.sum(self._tuples[:, 0] == 0).to(torch.int64)

    def edit_topology(self, sim, kind, arr):
        if kind != "bond" or arr is None or self._tuples is None \
                or self._tuples.shape[0] != len(arr):
            return arr
        live = self._tuples[:, 0].cpu().numpy() > 0
        return arr[live]

    def fold_topology(self, sim):
        """Drop the broken rows from the topology (before a set-up); the
        special lists follow.  Returns whether anything changed."""
        arr = sim.topology.get("bond")
        kept = self.edit_topology(sim, "bond", arr)
        self._tuples = None
        if kept is arr:
            return False
        sim.topology["bond"] = kept
        return len(kept) != len(arr)

    def post_integrate(self, s, fstate, ctx):
        self._restore(fstate)
        if fstate % self.nevery or self._tuples is None:
            return s, fstate
        t = self._tuples
        ttype, a, b = t[:, 0], t[:, 1].long(), t[:, 2].long()
        n = ctx.natoms
        rows = row2slot_from_tags(s.tag, n)
        x = s.x.index_select(0, rows)
        d = minimum_image(x.index_select(0, a) - x.index_select(0, b), s.box)
        r2 = torch.sum(d * d, dim=1)
        grp = self.group_sel(s).index_select(0, rows)
        cand = (ttype == self.btype) & grp[a] & grp[b] & (r2 > self.cutsq)
        key = torch.where(cand, r2, -1.0)
        far = torch.full((n,), -1.0, dtype=r2.dtype, device=r2.device)
        far = far.scatter_reduce(0, a, key, "amax").scatter_reduce(
            0, b, key, "amax")
        idx = torch.arange(t.shape[0], device=t.device)
        big = torch.full((n,), t.shape[0], dtype=torch.int64, device=t.device)
        best = big.scatter_reduce(0, a, torch.where(
            cand & (key == far[a]), idx, t.shape[0]), "amin")
        best = best.scatter_reduce(0, b, torch.where(
            cand & (key == far[b]), idx, t.shape[0]), "amin")
        brk = cand & (best[a] == idx) & (best[b] == idx)
        old = ttype.clone()
        t[:, 0] = torch.where(brk, 0, ttype)
        self._undo = (fstate, lambda: t[:, 0].copy_(old))
        return self._drop_special(s, a + 1, b + 1, brk), fstate


class FixBondCreateMC(BondMC):
    """fix ID group bond/create N itype jtype Rmin btype [iparam maxbond
    itype] [jparam maxbond jtype]."""

    name = "bond/create"
    needs_neigh = True

    def __init__(self, nevery, itype, jtype, rmin, btype, imaxbond=0,
                 jmaxbond=0):
        super().__init__(nevery, btype)
        self.itype, self.jtype = int(itype), int(jtype)
        self.rmin = float(rmin)
        self.cutsq = self.rmin ** 2
        self.imaxbond, self.jmaxbond = int(imaxbond), int(jmaxbond)
        self._table = None       # (room + 1, 3) int32 rows; the last a dump
        self._count = None       # () int64 rows in use
        self._seen = 0

    def special_room(self, sim):
        """Columns of room in the special lists for the entries that the
        created bonds add on the card."""
        return max(sim.extra_per_atom.get("special", 0), 1)

    def attach_bonded(self, sim, entries):
        """The created-bond table beside the data file's bonds, under the
        bond style, with room for extra/bond/per/atom bonds an atom."""
        style = self._bond_style(sim)
        style.dynamic = True
        if self.rmin > sim.max_cutoff():
            raise NotImplementedError(
                f"fix bond/create Rmin {self.rmin} beyond the pair cutoff "
                f"{sim.max_cutoff()}: its candidates come from the neighbor "
                "rows")
        room = max(sim.extra_per_atom.get("bond", 0), 1) * sim.natoms // 2
        self._table = torch.zeros((room + 1, 3), dtype=torch.int32,
                                  device=sim.device)
        self._count = torch.zeros((), dtype=torch.int64, device=sim.device)
        self._over = torch.zeros((), dtype=torch.bool, device=sim.device)
        self._seen = 0
        return tuple(entries) + ((style, self._table),)

    def _changed(self):
        return self._count

    def device_flags(self, fstate):
        """() bool: the table or a special row ran out of room."""
        if self._table is None:
            return torch.zeros((), dtype=torch.bool)
        return (self._count > self._table.shape[0] - 1) | self._over

    flag_message = ("created bonds ran out of room (raise "
                    "extra/bond/per/atom or extra/special/per/atom)")

    def edit_topology(self, sim, kind, arr):
        if kind != "bond" or self._table is None:
            return arr
        n = int(self._count)
        rows = self._table[:n].cpu().numpy().astype(np.int64)
        rows = rows[rows[:, 0] > 0]
        if not len(rows):
            return arr
        rows[:, 1:] += 1
        return rows if arr is None else np.concatenate([arr, rows])

    def fold_topology(self, sim):
        if self._table is None:
            return False
        arr = self.edit_topology(sim, "bond", sim.topology.get("bond"))
        changed = arr is not sim.topology.get("bond")
        if changed:
            sim.topology["bond"] = arr
        self._table = self._count = None
        return changed

    def post_integrate(self, s, fstate, ctx, neigh):
        self._restore(fstate)
        if fstate % self.nevery or self._table is None:
            return s, fstate
        if ctx.neigh_cfg.image_shifts:
            raise NotImplementedError(
                "fix bond/create in a box narrower than 2 cutneigh (image "
                "copies) is not ported")
        n = ctx.natoms
        tag = s.tag.long()
        valid = tag > 0
        # bonds of the type per atom (tag - 1), live rows of every table
        count = torch.zeros(n + 1, dtype=torch.int64, device=s.x.device)
        for style, t in ctx.bonded:
            if style.kind == "bond":
                on = ((t[:, 0] == self.btype)).to(torch.int64)
                count.index_add_(0, t[:, 1].long(), on)
                count.index_add_(0, t[:, 2].long(), on)
        bc = count[(tag - 1).clamp(min=0)]
        typ, grp = s.type, self.group_sel(s) & valid

        def cap_ok(limit):
            return bc < limit if limit else torch.ones_like(valid)
        as_i = grp & (typ == self.itype) & cap_ok(self.imaxbond)
        as_j = grp & (typ == self.jtype) & cap_ok(self.jmaxbond)
        idx = neigh.idx.long()
        own = torch.arange(idx.shape[0], device=idx.device)[:, None]
        ok = (idx != own) & ((as_i[:, None] & as_j[idx])
                             | (as_j[:, None] & as_i[idx]))
        if s.special_tags is not None:
            jt = tag[idx]
            is12 = torch.any((s.special_tags.long()[:, None, :]
                              == jt[:, :, None])
                             & (s.special_codes == 1)[:, None, :], dim=2)
            ok = ok & ~is12
        d = minimum_image(s.x[:, None, :] - s.x[idx], s.box)
        r2 = torch.sum(d * d, dim=2)
        dist = torch.where(ok & (r2 < self.cutsq), r2, torch.inf)
        dmin, kbest = torch.min(dist, dim=1)
        has = torch.isfinite(dmin)
        p = idx.gather(1, kbest[:, None])[:, 0]
        make = has & has[p] & (p[p] == own[:, 0])
        first = make & (tag < tag[p])
        # append the new rows after the table's count, on the card
        room = self._table.shape[0] - 1
        slot = self._count + torch.cumsum(first.to(torch.int64), 0) - 1
        slot = torch.where(first, slot.clamp(max=room), room)
        new = torch.stack([torch.full_like(tag, self.btype), tag - 1,
                           tag[p] - 1], dim=1).to(torch.int32)
        old_rows, old_count = self._table.clone(), self._count.clone()
        self._table.index_put_((slot,), new)
        self._table[room] = 0
        self._count += torch.sum(first)
        table, cnt = self._table, self._count

        def undo():
            table.copy_(old_rows)
            cnt.copy_(old_count)
        self._undo = (fstate, undo)
        return self._add_special(s, make, tag[p]), fstate

    def _add_special(self, s, make, ptag):
        """s with the partner's tag entered at code 1 in the first empty
        slot of each bonding atom's special row (a full row is flagged)."""
        st, sc = s.special_tags, s.special_codes
        empty = st == 0
        first = torch.argmax(empty.to(torch.int8), dim=1)
        can = make & torch.any(empty, dim=1)
        self._over |= torch.any(make & ~can)
        hit = can[:, None] & (torch.arange(st.shape[1], device=st.device)
                              == first[:, None])
        return s.replace(
            special_tags=torch.where(hit, ptag.to(st.dtype)[:, None], st),
            special_codes=torch.where(hit, 1, sc))

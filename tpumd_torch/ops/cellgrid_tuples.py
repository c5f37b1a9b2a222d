"""Bonded tuples matched by tag on the cell grid: the molecular force path
of a decomposed grid.

PyTorch counterpart of tpumd/ops/cellgrid_tuples.py.  The tag-order view
of the bonded styles (models/bonded.py ``tag_view``) gathers every atom's
row through the grid's global tag -> slot map, which a rank's local grid
(parallel/decomp.py) does not have: its slots hold its owned atoms and the
halo copies of its neighbours'.  Here each atom carries its tuples by the
members' tags, in per-atom tables that ride ``MDState.peratom`` and so move
with the atoms through every re-bin and migration, and each evaluation
finds the members among the slots of the grid it runs on.  Each atom then
tallies its own role's force of each of its tuples and 1/arity of their
energies and virial (``BondedStyle.reduce_from_xs``): nothing is scattered
to another atom, and on a local grid the owned atoms' sums are the rank's
share, the halo slots holding no tables.

Geometry: every member lies within one cell edge of every other member
(cells are at least cutneigh wide and ``validate_tuple_span`` holds the
set-up's spans under cutneigh), so a local grid, its owned cells and one
halo layer on each split side, holds every member of an owned atom's
tuples.

tpumd finds the members by comparing each wanted tag with the tags of the
27-cell stencil, a dense (cells, cap, 27 cap) mask per wanted tag.  The
port looks them up instead: the grid's valid slots sorted by tag, each
wanted tag placed by ``searchsorted``.  A tag shows in more than one slot only on a local
grid whose split axis has 2 blocks, where the other block's boundary atoms
sit in both halos, their positions a box length apart (the seam shifts);
as tpumd's minimum-image guard for axes of fewer than 3 cells keeps the
image within half a box, the lookup keeps the copy nearest to the atom
that asks, the one within the tuple's span.  Positions come as the slots
hold them (a halo copy's with its seam shift); the styles take the
minimum image.

Per-atom tables (``MDState.peratom``, in tag order at build, row tag - 1):
- ``_bt_utags``  (N, P) the distinct member tags over all the atom's
  tuples, itself included;
- per kind: ``_bt_{kind}_pidx`` (N, K, arity) each member's column of the
  P axis, ``_bt_{kind}_ttype`` (N, K) the tuple type (0: empty) and
  ``_bt_{kind}_role`` (N, K) the atom's place in the tuple.
"""

from __future__ import annotations

import numpy as np
import torch

PREFIX = "_bt_"
# the sort key of an empty slot: past every tag
_NO_TAG = 1 << 62


def build_tuple_tables(natoms: int, topo: dict, arities: dict,
                       excl: dict | None = None) -> dict:
    """The per-atom tables of the tuples topo {kind: (M, 1 + arity) type,
    member tags} in tag order (row tag - 1), less the rows excl {kind:
    set of row indices} (SHAKE's constrained bonds and angles)."""
    excl = excl or {}
    per_atom_tags: list[dict] = [dict() for _ in range(natoms)]
    memb: dict = {k: [[] for _ in range(natoms)] for k in topo}
    for kind, tuples in topo.items():
        arity = arities[kind]
        skip = excl.get(kind, set())
        for ti, row in enumerate(np.asarray(tuples)):
            if ti in skip:
                continue
            ttype = int(row[0])
            tags = [int(t) for t in row[1:1 + arity]]
            for role, t in enumerate(tags):
                r = t - 1
                for u in tags:
                    per_atom_tags[r].setdefault(u, len(per_atom_tags[r]))
                memb[kind][r].append((ttype, role, tags))

    P = max(1, max(len(d) for d in per_atom_tags))
    utags = np.zeros((natoms, P), np.int32)
    for r, d in enumerate(per_atom_tags):
        for t, j in d.items():
            utags[r, j] = t
    out = {PREFIX + "utags": utags}
    for kind, lists in memb.items():
        arity = arities[kind]
        K = max(1, max(len(v) for v in lists))
        pidx = np.zeros((natoms, K, arity), np.int32)
        ttype = np.zeros((natoms, K), np.int32)
        role = np.zeros((natoms, K), np.int32)
        for r, items in enumerate(lists):
            for k, (tt, ro, tags) in enumerate(items):
                ttype[r, k] = tt
                role[r, k] = ro
                for a, t in enumerate(tags):
                    pidx[r, k, a] = per_atom_tags[r][t]
        out[f"{PREFIX}{kind}_pidx"] = pidx
        out[f"{PREFIX}{kind}_ttype"] = ttype
        out[f"{PREFIX}{kind}_role"] = role
    return out


def validate_tuple_span(x, topo, arities, lengths, periodic, max_span: float,
                        excl: dict | None = None) -> float:
    """The largest distance between two members of a tuple at the
    positions x (by tag - 1, host float64), at the minimum image of the
    box lengths on its periodic axes; raises past max_span (the grid finds
    members within one cell edge only)."""
    excl = excl or {}
    ell = np.asarray(lengths, np.float64)
    per = np.asarray(periodic, bool)
    worst = 0.0
    for kind, tuples in topo.items():
        arity = arities[kind]
        arr = np.asarray(tuples)
        if len(arr) == 0:
            continue
        keep = np.ones(len(arr), bool)
        keep[list(excl.get(kind, ()))] = False
        pts = x[arr[keep][:, 1:1 + arity] - 1]          # (M, arity, 3)
        for a in range(arity):
            for b in range(a + 1, arity):
                d = pts[:, a] - pts[:, b]
                d = d - np.where(per, np.round(d / ell) * ell, 0.0)
                if len(d):
                    worst = max(worst, float(np.sqrt((d * d).sum(1)).max()))
    if worst > max_span:
        raise ValueError(
            f"bonded tuple span {worst:.3f} exceeds the grid stencil's reach "
            f"{max_span:.3f}: the tag-matched bonded path needs every member "
            "within one cell of the others")
    return worst


def tag_index(tag):
    """(tags sorted, their slots) of the valid slots (tag > 0), the empty
    ones last."""
    return torch.sort(torch.where(tag > 0, tag.long(), _NO_TAG))


def member_slots(x, tag, want, copies: int = 1):
    """(slots (Np, P) int64, found (Np, P) bool) of the tags want (Np, P)
    (0: none) wanted by each slot of a grid: the slot that holds each
    wanted tag, the one nearest to the wanting slot's position where a tag
    shows in up to copies slots (a local grid's halos); 0 where not
    found.  The copies are probed together (a dozen launches a call)."""
    keys, order = tag_index(tag)
    w = want.long()[..., None]
    pos = torch.searchsorted(keys, want.long())[..., None]
    p = torch.clamp(pos + torch.arange(copies, device=w.device),
                    max=keys.shape[0] - 1)
    hit = (keys[p] == w) & (w > 0)
    cand = order[p]
    found = hit.any(dim=-1)
    if copies == 1:
        return torch.where(found, cand[..., 0], 0), found
    d = x[cand] - x[:, None, None, :]
    d2 = torch.where(hit, torch.sum(d * d, dim=-1), torch.inf)
    near = torch.gather(cand, -1, torch.argmin(d2, dim=-1, keepdim=True))
    return torch.where(found, near[..., 0], 0), found


def match_members(x, tag, type_, q, utags, cols=None, copies: int = 1):
    """The wanted tags utags (Np, P) of each slot found among the grid's
    slots (``member_slots``): (mpos (Np, P, 3) as the slots hold them,
    mtype (Np, P), mq (Np, P) or None, found (Np, P)), and where cols
    {name: (Np, ...) per-slot payload} is given, {name: (Np, P, ...)} of
    them after it (SHAKE's members' velocities and forces)."""
    slots, found = member_slots(x, tag, utags, copies)
    out = (x[slots], type_[slots], None if q is None else q[slots], found)
    if cols is None:
        return out
    return out + ({k: v[slots] for k, v in cols.items()},)


def copies_of(ctx) -> int:
    """The most slots one tag may fill on the context's grid."""
    return 1 if ctx.decomp is None else ctx.decomp.layout.copies


def compute_bonded_grid(s, ctx, styles, eflag: bool, vflag: bool):
    """Every bonded style of styles (one a kind) from the tag-matched
    members of each slot's tuples.  Returns (f (Np, 3) in slot order,
    {energy key: ()} or None, virial (6,) or None, missing: () bool, some
    tuple of a valid slot lacking a member)."""
    pa = s.peratom
    utags = pa[PREFIX + "utags"]
    mpos, mtype, mq, found = match_members(s.x, s.tag, s.type, s.q, utags,
                                           copies=copies_of(ctx))
    n, P = utags.shape
    flat_x = mpos.reshape(n * P, 3)
    types = mtype.reshape(n * P)
    charges = None if mq is None else mq.reshape(n * P)
    flat_found = found.reshape(n * P)
    base = (torch.arange(n, device=s.x.device) * P)[:, None, None]
    f = torch.zeros_like(s.x)
    energies = {} if eflag else None
    virial = s.x.new_zeros(6) if vflag else None
    missing = torch.zeros((), dtype=torch.bool, device=s.x.device)
    for style in styles:
        kind = style.kind
        pidx = pa.get(f"{PREFIX}{kind}_pidx")
        if pidx is None:
            continue
        K = pidx.shape[1]
        mem = (base + pidx.long()).reshape(n * K, style.arity)
        ttype = pa[f"{PREFIX}{kind}_ttype"].reshape(n * K).long()
        role = pa[f"{PREFIX}{kind}_role"].reshape(n * K)
        live = ttype > 0
        ok = live & torch.all(flat_found[mem], dim=1)
        missing = missing | torch.any(live & ~ok)
        xs = list(flat_x[mem].unbind(1))
        view = ((None, types, charges), mem, _take_rows)
        fb, ed, vir = style.reduce_from_xs(xs, ttype, role, ok, s.box, ctx,
                                           eflag, vflag, view)
        f = f + fb.reshape(n, K, 3).sum(dim=1)
        if eflag:
            for k, v in ed.items():
                energies[k] = energies.get(k, 0.0) + v
        if vflag:
            virial = virial + vir
    return f, energies, virial, missing


def _take_rows(table, idx):
    return torch.index_select(table, 0, idx.reshape(-1)).view(
        idx.shape + table.shape[1:])


def missing_tuples(s, ctx, styles, limit: int = 4) -> list:
    """Up to limit (kind, member tags) of the tuples whose members the
    grid's lookup does not find (host lists): what a missing-member error
    names."""
    pa = s.peratom
    utags = pa[PREFIX + "utags"]
    found = member_slots(s.x, s.tag, utags, copies_of(ctx))[1]
    out = []
    for style in styles:
        pidx = pa.get(f"{PREFIX}{style.kind}_pidx")
        if pidx is None:
            continue
        live = pa[f"{PREFIX}{style.kind}_ttype"] > 0
        lost = live & ~torch.all(torch.gather(
            found[:, None, :].expand(-1, pidx.shape[1], -1), 2, pidx.long()),
            dim=2)
        for r, k in torch.nonzero(lost).tolist()[:limit - len(out)]:
            out.append((style.kind, utags[r][pidx[r, k].long()].tolist()))
    return out

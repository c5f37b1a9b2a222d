"""Pairwise forces, energies and virial over the padded neighbor matrix.

PyTorch counterpart of tpumd/ops/pairwise.py (the reference's
Pair::compute half-list loops, src/pair_lj_cut.cpp:69-140, and its
ev_tally virial, src/pair.cpp:893-1360): one i-centric pass over the
(N, K) matrix of ``ops/neighbor.py``.  Forces are sums over each row (a
full list: no scatter), energies and the 6-component virial masked sums
with the 1/2 of a full list, made only when asked for.

A style gives ``pair_fn(r2, itype, jtype) -> (fpair, evdwl)`` on masked
squared distances, with fpair the LAMMPS force prefactor (f_ij = fpair
(x_i - x_j)); the special weights then scale both.  A style that weighs
special pairs itself gives ``pair_fn_ex(r2, itype, jtype, w_lj, w_coul,
qi, qj) -> (fpair, evdwl, ecoul, fcoul)``, already weighted.
"""

from __future__ import annotations

import torch

from tpumd_torch.core.state import minimum_image, minimum_image_c
from tpumd_torch.ops.gather import gather_rows


def pair_sums(x, type_, box, idx, sbits, pair_fn, special_lj, special_coul,
              eflag: bool, vflag: bool, q=None, pair_fn_ex=None, ext=None,
              row0: int = 0):
    """(f (N, 3), evdwl, ecoul, virial (6,)) of a pairwise style; the
    energies are None without eflag, the virial without vflag.  With
    eflag = vflag = "atom": (f, eatom (N,), vatom (N, 6), None), each
    row's per-atom tallies (evdwl + ecoul), half of each of its pairs
    (ev_tally's eatom/vatom shares, src/pair.cpp:1013;
    tpumd/ops/pairwise.py:102-118).

    special_lj/special_coul: the four weights by sbits code (code 0:
    weight 1), or None without special pairs.  ext = (xj, tj, qj, vbox):
    the multi-image mode's copy tables, which idx addresses, and the box
    of the extended domain (tpumd/md/verlet.py:97-108).  row0: x, type_
    and q are the rows [row0, row0 + N) of the tables that idx addresses
    (ext), so a row's own index, its padding, is row0 + its row."""
    peratom = eflag == "atom" or vflag == "atom"
    if peratom and not (eflag == "atom" and vflag == "atom"):
        raise ValueError("pair_sums: per-atom tallies take eflag and vflag "
                         "both 'atom'")
    n = idx.shape[0]
    dev = x.device
    mask = idx != torch.arange(row0, row0 + n, dtype=idx.dtype,
                               device=dev)[:, None]

    if ext is not None:
        xj_tab, tj_tab, qj_tab, box = ext
    else:
        xj_tab, tj_tab, qj_tab = x, type_, q
    # one packed j-side row: x, y, z, type (and q)
    cols = [xj_tab, tj_tab.to(x.dtype)[:, None]]
    if q is not None:
        cols.append(qj_tab[:, None])
    pj = gather_rows(torch.cat(cols, dim=1), idx)      # (N, K, 4 or 5)

    d = [x[:, c:c + 1] - pj[..., c] for c in range(3)]
    if box.istriclinic:
        d = list(torch.unbind(minimum_image(torch.stack(d, dim=-1), box),
                              dim=-1))
    else:
        d = [minimum_image_c(d[c], box, c) for c in range(3)]
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    r2safe = torch.where(mask, r2, 1.0)
    itype = type_[:, None]
    jtype = pj[..., 3].to(torch.int32)

    def weights(table):
        t = torch.as_tensor(table, dtype=x.dtype, device=dev)
        return t[sbits.long()]

    ecoul = None
    if pair_fn_ex is not None:
        one = torch.ones_like(r2safe)
        w_lj = weights(special_lj) if special_lj is not None else one
        w_c = weights(special_coul) if special_coul is not None else one
        qi = q[:, None] if q is not None else None
        qj = pj[..., 4] if q is not None else None
        fpair, evdwl, ecoul, fcoul = pair_fn_ex(r2safe, itype, jtype, w_lj,
                                                w_c, qi, qj)
        if fcoul is not None:
            fpair = fpair + fcoul
    else:
        fpair, evdwl = pair_fn(r2safe, itype, jtype)
        if special_lj is not None:
            w_lj = weights(special_lj)
            fpair = fpair * w_lj
            if eflag:
                evdwl = evdwl * w_lj

    fpair = torch.where(mask, fpair, 0.0)
    f = torch.stack([torch.sum(d[c] * fpair, dim=1) for c in range(3)],
                    dim=1)
    if peratom:
        etot = evdwl if ecoul is None else evdwl + ecoul
        eatom = 0.5 * torch.sum(torch.where(mask, etot, 0.0), dim=1)
        vatom = 0.5 * torch.stack([
            torch.sum(fpair * d[a] * d[b], dim=1)
            for a, b in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))],
            dim=1)
        return f, eatom, vatom, None
    e_vdwl = e_coul = virial = None
    if eflag:
        e_vdwl = 0.5 * torch.sum(torch.where(mask, evdwl, 0.0))
        e_coul = (0.5 * torch.sum(torch.where(mask, ecoul, 0.0))
                  if ecoul is not None
                  else torch.zeros((), dtype=x.dtype, device=dev))
    if vflag:
        # xx yy zz xy xz yz, the reference's order
        virial = 0.5 * torch.stack([
            torch.sum(fpair * d[0] * d[0]), torch.sum(fpair * d[1] * d[1]),
            torch.sum(fpair * d[2] * d[2]), torch.sum(fpair * d[0] * d[1]),
            torch.sum(fpair * d[0] * d[2]), torch.sum(fpair * d[1] * d[2])])
    return f, e_vdwl, e_coul, virial

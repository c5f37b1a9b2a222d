"""EAM pair styles: eam (funcfl), eam/alloy (setfl) and eam/fs.

PyTorch counterpart of tpumd/models/pair_eam.py, physics per the
reference (src/MANYBODY/pair_eam.cpp): pass 1 sums host densities
rho_i = sum_j rho(r_ij) and evaluates the embedding derivative F'(rho_i);
pass 2 sums pair forces f = -((F'_i + F'_j) rho'(r) + phi'(r)) r_hat.  The
spline tables (interpolate(), file2array()) are built by the same numpy
code as tpumd's, so they are bit-equal; the kernels read them exactly, with
no refit.

Two engines.  On the cell grid both passes sweep the grid's pair list
(B3, B4); those kernels take one element, so "auto" sends a deck with
several atom types (or a non-periodic axis, or ``neigh_modify exclude``)
to the matrix engine, as tpumd does.  There ``compute`` runs
tpumd/models/pair_eam.py:450-520 over the padded neighbor rows: pass 1
sums the host densities through type2rhor[j, i], pass 2 the pair forces
fp_i rho'_j + fp_j rho'_i + phi'; every spline row, the neighbours'
coordinates and types, and fp at the neighbours are row gathers (P1).
eam/he (its tables over [rhomin, rhomax], linear below and above) runs on
the matrix engine only.
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.core.state import minimum_image
from tpumd_torch.models.base import PairStyle
from tpumd_torch.models.registry import register_pair
from tpumd_torch.ops.gather import gather_rows
from tpumd_torch.ops.eam_cellgrid import EAMTables, eam_force_cellgrid, \
    eam_rho_cellgrid


def _interpolate(n: int, delta: float, f: np.ndarray) -> np.ndarray:
    """PairEAM::interpolate: (n+1, 7) spline coefficient table, 1-based;
    columns 0-2 give the derivative, 3-6 the value."""
    sp = np.zeros((n + 1, 7))
    sp[1:, 6] = f[1:n + 1]
    sp[1, 5] = sp[2, 6] - sp[1, 6]
    sp[2, 5] = 0.5 * (sp[3, 6] - sp[1, 6])
    sp[n - 1, 5] = 0.5 * (sp[n, 6] - sp[n - 2, 6])
    sp[n, 5] = sp[n, 6] - sp[n - 1, 6]
    m = np.arange(3, n - 1)
    sp[m, 5] = ((sp[m - 2, 6] - sp[m + 2, 6])
                + 8.0 * (sp[m + 1, 6] - sp[m - 1, 6])) / 12.0
    m = np.arange(1, n)
    sp[m, 4] = 3.0 * (sp[m + 1, 6] - sp[m, 6]) - 2.0 * sp[m, 5] - sp[m + 1, 5]
    sp[m, 3] = sp[m, 5] + sp[m + 1, 5] - 2.0 * (sp[m + 1, 6] - sp[m, 6])
    sp[n, 4] = 0.0
    sp[n, 3] = 0.0
    sp[1:, 2] = sp[1:, 5] / delta
    sp[1:, 1] = 2.0 * sp[1:, 4] / delta
    sp[1:, 0] = 3.0 * sp[1:, 3] / delta
    return sp


def _grid_interp(src: np.ndarray, src_delta: float, nsrc: int,
                 n: int, delta: float) -> np.ndarray:
    """file2array's 4-point re-interpolation onto the unified grid."""
    out = np.zeros(n + 1)
    sixth = 1.0 / 6.0
    for m in range(1, n + 1):
        r = (m - 1) * delta
        p = r / src_delta + 1.0
        k = int(p)
        k = min(k, nsrc - 2)
        k = max(k, 2)
        p -= k
        p = min(p, 2.0)
        cof1 = -sixth * p * (p - 1.0) * (p - 2.0)
        cof2 = 0.5 * (p * p - 1.0) * (p - 2.0)
        cof3 = -0.5 * p * (p + 1.0) * (p - 2.0)
        cof4 = sixth * p * (p * p - 1.0)
        out[m] = (cof1 * src[k - 1] + cof2 * src[k]
                  + cof3 * src[k + 1] + cof4 * src[k + 2])
    return out


def _spline_val_np(sp, delta, n, r):
    """Exact host-side evaluation of an interpolate() table (value)."""
    p = r / delta + 1.0
    m = np.clip(p.astype(np.int64), 1, n - 1)
    p = np.minimum(p - m, 1.0)
    c = sp[m]
    return ((c[:, 3] * p + c[:, 4]) * p + c[:, 5]) * p + c[:, 6]


def _spline_der_np(sp, delta, n, r):
    """Exact host-side evaluation of an interpolate() table (derivative)."""
    p = r / delta + 1.0
    m = np.clip(p.astype(np.int64), 1, n - 1)
    p = np.minimum(p - m, 1.0)
    c = sp[m]
    return (c[:, 0] * p + c[:, 1]) * p + c[:, 2]


class _Funcfl:
    """A funcfl file (PairEAM::read_file): one element, Z(r) for phi."""

    def __init__(self, path: str):
        with open(path) as fh:
            lines = fh.read().split("\n")
        self.mass = float(lines[1].split()[1])
        hdr = lines[2].split()
        self.nrho, self.drho = int(hdr[0]), float(hdr[1])
        self.nr, self.dr = int(hdr[2]), float(hdr[3])
        self.cut = float(hdr[4])
        body = np.array([float(v) for v in " ".join(lines[3:]).split()])
        need = self.nrho + 2 * self.nr
        if body.size < need:
            raise ValueError(f"short EAM funcfl file {path}")
        self.frho = np.zeros(self.nrho + 1)
        self.zr = np.zeros(self.nr + 1)
        self.rhor = np.zeros(self.nr + 1)
        self.frho[1:] = body[:self.nrho]
        self.zr[1:] = body[self.nrho:self.nrho + self.nr]
        self.rhor[1:] = body[self.nrho + self.nr:need]


class _Setfl:
    """A setfl file (PairEAMAlloy::read_file); with fs, an eam/fs file
    (PairEAMFS::read_file), whose density functions are per element
    pair: rhor[i, j] is element i's density in an element-j host.  With
    he, an eam/he file: eam/fs whose nrho line ends in rhomax
    (pair_eam_fs.cpp:139-148 with he_flag).  With adp, the u(r) and w(r)
    lower triangles follow phi (PairADP::read_file, pair_adp.cpp:540-607)."""

    def __init__(self, path: str, fs: bool = False, he: bool = False,
                 adp: bool = False):
        with open(path) as fh:
            lines = fh.read().split("\n")
        toks = " ".join(lines[3:]).split()
        ne = int(toks[0])
        self.elements = toks[1:1 + ne]
        p = 1 + ne
        self.nrho, self.drho = int(toks[p]), float(toks[p + 1])
        self.nr, self.dr = int(toks[p + 2]), float(toks[p + 3])
        self.cut = float(toks[p + 4])
        p += 5
        if he:
            self.rhomax_file = float(toks[p])
            p += 1

        def take(n):
            nonlocal p
            p += n
            return [float(v) for v in toks[p - n:p]]

        self.mass = np.zeros(ne)
        self.frho = np.zeros((ne, self.nrho + 1))
        self.rhor = np.zeros((ne, ne, self.nr + 1) if fs
                             else (ne, self.nr + 1))
        self.z2r = np.zeros((ne, ne, self.nr + 1))
        for i in range(ne):
            self.mass[i] = float(toks[p + 1])   # atomic number ignored
            p += 4
            self.frho[i, 1:] = take(self.nrho)
            for j in range(ne if fs else 1):
                self.rhor[(i, j) if fs else i][1:] = take(self.nr)
        tables = [self.z2r]
        if adp:
            self.u2r = np.zeros((ne, ne, self.nr + 1))
            self.w2r = np.zeros((ne, ne, self.nr + 1))
            tables += [self.u2r, self.w2r]
        for arr in tables:
            for i in range(ne):
                for j in range(i + 1):
                    arr[i, j, 1:] = take(self.nr)
                    arr[j, i] = arr[i, j]


@register_pair("eam")
class PairEAM(PairStyle):
    # no per-atom energy/virial path (tpumd has none)
    peratom = False
    name = "eam"
    # B3 and B4 take it on the cell grid (one element); ``compute`` on the
    # matrix engine
    supports_cellgrid = True
    supports_image_ext = False
    # a rank's local grid fills the halo slots' F'(rho) between B3 and B4
    forward_fp = True
    # eam/he: the embedding table starts at rhomin, with linear
    # extrapolation below it (pair_eam_he.cpp:147)
    rhomin = 0.0
    he_flag = False

    def __init__(self, ntypes: int):
        super().__init__(ntypes)
        self.funcfl: dict[int, _Funcfl] = {}    # type -> file
        self.cutmax = 0.0
        self.mass = np.zeros(ntypes + 1)
        self._tables: dict = {}

    def settings(self, *args):
        if args:
            raise ValueError(f"pair_style {self.name} takes no arguments")

    def coeff(self, ilo, ihi, jlo, jhi, filename):
        f = _Funcfl(str(filename))
        for i in range(ilo, ihi + 1):
            self.funcfl[i] = f
            self.mass[i] = f.mass
            self._setflag[i, i] = True

    def init(self):
        files = []
        for i in range(1, self.ntypes + 1):
            if i not in self.funcfl:
                raise ValueError(f"EAM coeffs missing for type {i}")
            if self.funcfl[i] not in files:
                files.append(self.funcfl[i])
        self._file2array(files)
        self._tables = {}

    def _file2array(self, files):
        # unified grids (PairEAM::file2array, src/MANYBODY/pair_eam.cpp:620-)
        dr = max(f.dr for f in files)
        drho = max(f.drho for f in files)
        rmax = max((f.nr - 1) * f.dr for f in files)
        rhomax = max((f.nrho - 1) * f.drho for f in files)
        nr = int(rmax / dr + 0.5)
        nrho = int(rhomax / drho + 0.5)
        self.dr, self.drho, self.nr, self.nrho = dr, drho, nr, nrho
        self.rhomax = rhomax
        nfile = len(files)

        frho = np.zeros((nfile, nrho + 1))
        rhor = np.zeros((nfile, nr + 1))
        for n, f in enumerate(files):
            frho[n] = _grid_interp(f.frho, f.drho, f.nrho, nrho, drho)
            rhor[n] = _grid_interp(f.rhor, f.dr, f.nr, nr, dr)

        # z2r for each file pair: 27.2*0.529 * zri*zrj (Hartree*Bohr -> eV*A)
        nz = nfile * (nfile + 1) // 2
        z2r = np.zeros((nz, nr + 1))
        z2r_index = np.zeros((nfile, nfile), dtype=np.int32)
        n = 0
        for i in range(nfile):
            zri = _grid_interp(files[i].zr, files[i].dr, files[i].nr, nr, dr)
            for j in range(i + 1):
                zrj = _grid_interp(files[j].zr, files[j].dr, files[j].nr,
                                   nr, dr)
                z2r[n] = 27.2 * 0.529 * zri * zrj
                z2r_index[i, j] = z2r_index[j, i] = n
                n += 1

        fidx = {id(f): i for i, f in enumerate(files)}
        t2f = np.zeros(self.ntypes + 1, dtype=np.int32)
        for t in range(1, self.ntypes + 1):
            t2f[t] = fidx[id(self.funcfl[t])]
        self.type2frho = t2f
        # type2rhor[i][j]: the density function an atom of type i
        # contributes to a type-j host (the provider is the first index)
        self.type2rhor = np.zeros((self.ntypes + 1, self.ntypes + 1),
                                  dtype=np.int32)
        self.type2z2r = np.zeros_like(self.type2rhor)
        for i in range(1, self.ntypes + 1):
            for j in range(1, self.ntypes + 1):
                self.type2rhor[i, j] = t2f[i]
                self.type2z2r[i, j] = z2r_index[t2f[i], t2f[j]]

        self.frho_spline = np.stack(
            [_interpolate(nrho, drho, frho[n]) for n in range(nfile)])
        self.rhor_spline = np.stack(
            [_interpolate(nr, dr, rhor[n]) for n in range(nfile)])
        self.z2r_spline = np.stack(
            [_interpolate(nr, dr, z2r[n]) for n in range(nz)])
        self.cutmax = max(f.cut for f in files)
        self.cutforcesq = self.cutmax * self.cutmax

    @property
    def max_cutoff(self) -> float:
        return self.cutmax

    def kernel_tables(self, like: torch.Tensor) -> EAMTables:
        """The single element's exact spline tables on like's device, in
        its dtype (built once per device and dtype)."""
        key = (like.device, like.dtype)
        tab = self._tables.get(key)
        if tab is None:
            def put(a):
                return torch.as_tensor(np.ascontiguousarray(a),
                                       dtype=like.dtype, device=like.device)
            tab = EAMTables(
                frho=put(self.frho_spline[self.type2frho[1]]),
                rhor=put(self.rhor_spline[self.type2rhor[1, 1]]),
                z2r=put(self.z2r_spline[self.type2z2r[1, 1]]),
                dr=float(self.dr), drho=float(self.drho), nr=int(self.nr),
                nrho=int(self.nrho), rhomax=float(self.rhomax),
                cutsq=float(self.cutforcesq))
            self._tables[key] = tab
        return tab

    def drop_tables(self):
        super().drop_tables()
        self._tables = {}

    def grid_refusal(self):
        """Why the cell grid's EAM kernels cannot take this style, or None:
        they hold one element's tables."""
        if self.ntypes != 1:
            return (f"pair_style {self.name} with {self.ntypes} atom types: "
                    "the EAM cell-grid kernels (B3, B4) take one element")
        return None

    def _spline(self, name, like):
        """The spline table ``<name>_spline`` (nfunc, n+1, 7) packed as
        (nfunc (n+1), 7) on like's device, in its dtype (once per set-up)."""
        key = ("spline", name, like.device, like.dtype)
        tab = self._tables.get(key)
        if tab is None:
            a = getattr(self, name + "_spline")
            tab = self._tables[key] = torch.as_tensor(
                np.ascontiguousarray(a.reshape(-1, 7)), dtype=like.dtype,
                device=like.device)
        return tab

    def _index_table(self, name, like):
        key = ("index", name, like.device)
        tab = self._tables.get(key)
        if tab is None:
            tab = self._tables[key] = torch.as_tensor(
                getattr(self, name), dtype=torch.int64, device=like.device)
        return tab

    def _rows(self, name, func, m, like, n):
        """The coefficient rows of function ``func`` at grid point m of the
        table ``name`` with n+1 points a function: one P1 gather."""
        flat = (func * (n + 1) + m).to(torch.int32).contiguous()
        return gather_rows(self._spline(name, like), flat)

    def _r_index(self, r):
        p = r * (1.0 / self.dr) + 1.0
        m = torch.clamp(p.to(torch.int32), 1, self.nr - 1)
        return m.long(), torch.clamp(p - m, max=1.0)

    def _rho_index(self, rho):
        p = (rho - self.rhomin) * (1.0 / self.drho) + 1.0
        m = torch.clamp(p.to(torch.int32), 1, self.nrho - 1)
        return m.long(), torch.clamp(p - m, max=1.0)

    @staticmethod
    def _val(c, p):
        return ((c[..., 3] * p + c[..., 4]) * p + c[..., 5]) * p + c[..., 6]

    @staticmethod
    def _der(c, p):
        return (c[..., 0] * p + c[..., 1]) * p + c[..., 2]

    def _pass_geometry(self, x, type_, box, idx, cutsq):
        """(d, r, inside, m, p, it, jt) of the neighbor rows: displacements
        from one P1 gather of the packed (x, y, z, type) rows, the pairs
        inside the cutoff, and each pair's r-grid index and fraction."""
        n = idx.shape[0]
        rows = torch.arange(n, dtype=idx.dtype, device=x.device)[:, None]
        pj = gather_rows(torch.cat([x, type_.to(x.dtype)[:, None]], dim=1),
                         idx)
        d = minimum_image(x[:, None, :] - pj[..., :3], box)
        r2 = torch.sum(d * d, dim=-1)
        it = type_.long()[:, None]
        jt = pj[..., 3].round().long()
        if torch.is_tensor(cutsq):
            cutsq = cutsq[it, jt]
        inside = (idx != rows) & (r2 < cutsq)
        r = torch.sqrt(torch.where(inside, r2, 1.0))
        m, p = self._r_index(r)
        return d, r, inside, m, p, it, jt

    @staticmethod
    def _virial(fpw, d):
        """The 6-component virial of per-pair forces fpw (N, K, 3) on a
        full list: half of sum d_a fpw_b."""
        return 0.5 * torch.stack([
            torch.sum(d[..., a] * fpw[..., b])
            for a, b in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))])

    def _embedding(self, type_, rho, eflag):
        """(fp, phi_e or None) of every atom: F'(rho) and, with eflag,
        F(rho) with the linear extrapolation past rhomax (and, for eam/he,
        below rhomin)."""
        mrho, prho = self._rho_index(rho)
        t2f = self._index_table("type2frho", rho)
        cf = self._rows("frho", t2f[type_.long()], mrho, rho, self.nrho)
        fp = self._der(cf, prho)
        if not eflag:
            return fp, None
        phi_e = self._val(cf, prho)
        phi_e = phi_e + torch.where(rho > self.rhomax,
                                    fp * (rho - self.rhomax), 0.0)
        if self.he_flag:
            phi_e = phi_e + torch.where(rho < self.rhomin,
                                        fp * (rho - self.rhomin), 0.0)
        return fp, phi_e

    def compute(self, x, type_, box, idx, sbits, special_lj, special_coul,
                eflag: bool, vflag: bool, q=None, ext=None):
        """(f, evdwl, None, virial) on the matrix engine
        (tpumd/models/pair_eam.py:450-520)."""
        if ext is not None:
            raise NotImplementedError(
                f"pair_style {self.name}: a box narrower than 2*cutneigh "
                "(the multi-image mode) is not ported for EAM")
        d, r, inside, m, p, it, jt = self._pass_geometry(
            x, type_, box, idx, self.cutforcesq)
        t2rhor = self._index_table("type2rhor", x)
        t2z2r = self._index_table("type2z2r", x)
        # pass 1: the host densities, j's density function felt at i
        c_ji = self._rows("rhor", t2rhor[jt, it], m, x, self.nr)
        rho = torch.sum(torch.where(inside, self._val(c_ji, p), 0.0), dim=1)
        fp, phi_e = self._embedding(type_, rho, eflag)
        # pass 2: the pair forces
        c_ij = self._rows("rhor", t2rhor[it, jt], m, x, self.nr)
        cz = self._rows("z2r", t2z2r[it, jt], m, x, self.nr)
        rhoip, rhojp = self._der(c_ij, p), self._der(c_ji, p)
        z2p, z2 = self._der(cz, p), self._val(cz, p)
        recip = 1.0 / r
        phi = z2 * recip
        phip = z2p * recip - phi * recip
        fpj = gather_rows(fp[:, None].contiguous(), idx)[..., 0]
        psip = fp[:, None] * rhojp + fpj * rhoip + phip
        fpair = torch.where(inside, -psip * recip, 0.0)
        fpw = d * fpair[..., None]
        f = torch.sum(fpw, dim=1)
        evdwl = None
        if eflag:
            evdwl = (torch.sum(torch.where(type_ > 0, phi_e, 0.0))
                     + 0.5 * torch.sum(torch.where(inside, phi, 0.0)))
        return f, evdwl, None, (self._virial(fpw, d) if vflag else None)

    def compute_cellgrid(self, x, valid, box, cfg, eflag: bool, vflag: bool,
                         bond=None, plist=None, halo=None):
        """(f, evdwl, virial, None) on the cell grid: the density kernel
        (rho, F'(rho) and, with eflag, F(rho) per slot), then the force
        kernel, both over the grid's pair list plist = (pairs, npairs,
        rows) (or their plain versions for CPU tensors).  evdwl is the
        embedding energy plus the pair energy, None unless eflag; the
        virial is None unless vflag.  On a rank's local grid, halo fills
        the halo slots' F'(rho) from their owners between the two kernels
        (the reference's comm->forward_comm(this), pair_eam.cpp)."""
        if self.ntypes != 1:
            raise NotImplementedError(
                f"pair_style {self.name} with more than one atom type: the "
                "EAM cell-grid kernels take one element")
        if bond is not None:
            raise NotImplementedError(
                f"bonds with pair_style {self.name}: the EAM kernels have "
                "no bond path")
        tab = self.kernel_tables(x)
        _, fp, e_embed = eam_rho_cellgrid(x, valid, box, cfg, tab, eflag,
                                          plist)
        if halo is not None:
            fp = halo(fp)
        f, e_pair, virial = eam_force_cellgrid(x, valid, fp, box, cfg, tab,
                                               eflag, vflag, plist)
        return f, (e_embed + e_pair if eflag else None), virial, None


@register_pair("eam/alloy")
class PairEAMAlloy(PairEAM):
    """eam/alloy: setfl multi-element tables, z2r given directly
    (src/MANYBODY/pair_eam_alloy.cpp)."""

    name = "eam/alloy"
    _fs = False

    _reader = {}

    def coeff(self, ilo, ihi, jlo, jhi, filename, *elems):
        # 'pair_coeff * * file El1 El2 ...' maps each type to an element
        f = _Setfl(str(filename), fs=self._fs, **self._reader)
        self._setfl = f
        elems = [str(e) for e in elems]
        if len(elems) != self.ntypes:
            raise ValueError(f"{self.name} needs one element name per type")
        self._typemap = np.zeros(self.ntypes + 1, dtype=np.int32)
        for t, e in enumerate(elems, start=1):
            if e not in f.elements:
                raise ValueError(f"element {e} not in {self.name} file")
            self._typemap[t] = f.elements.index(e)
            self.mass[t] = f.mass[self._typemap[t]]
            self._setflag[t, t] = True

    def init(self):
        f = self._setfl
        self.dr, self.drho = f.dr, f.drho
        self.nr, self.nrho = f.nr, f.nrho
        self.rhomax = (f.nrho - 1) * f.drho
        ne = len(f.elements)
        self.type2frho = np.zeros(self.ntypes + 1, dtype=np.int32)
        self.type2rhor = np.zeros((self.ntypes + 1, self.ntypes + 1),
                                  dtype=np.int32)
        self.type2z2r = np.zeros_like(self.type2rhor)
        idx = np.arange(ne * ne).reshape(ne, ne)
        for i in range(1, self.ntypes + 1):
            ei = self._typemap[i]
            self.type2frho[i] = ei
            for j in range(1, self.ntypes + 1):
                ej = self._typemap[j]
                # provider first (PairEAMAlloy::file2array:
                # type2rhor[i][j] = map[i]); eam/fs reads rhor[elem_i]
                # [elem_j] (PairEAMFS::file2array, pair_eam_fs.cpp:307)
                self.type2rhor[i, j] = idx[ei, ej] if self._fs else ei
                self.type2z2r[i, j] = idx[ei, ej]
        rhor = f.rhor.reshape(-1, f.nr + 1)
        self.frho_spline = np.stack(
            [_interpolate(f.nrho, f.drho, f.frho[e]) for e in range(ne)])
        self.rhor_spline = np.stack(
            [_interpolate(f.nr, f.dr, row) for row in rhor])
        self.z2r_spline = np.stack(
            [_interpolate(f.nr, f.dr, f.z2r[i, j])
             for i in range(ne) for j in range(ne)])
        self.cutmax = f.cut
        self.cutforcesq = f.cut * f.cut
        self._tables = {}


@register_pair("eam/fs")
class PairEAMFS(PairEAMAlloy):
    """eam/fs: setfl tables with a density function per element pair
    (src/MANYBODY/pair_eam_fs.cpp)."""

    name = "eam/fs"
    _fs = True


@register_pair("eam/he")
class PairEAMHE(PairEAMFS):
    """eam/he: eam/fs tables over rho in [rhomin, rhomax], the embedding
    extrapolated linearly outside (src/MANYBODY/pair_eam_he.cpp); the
    matrix engine only (the grid's kernels take tables from rho = 0)."""

    name = "eam/he"
    he_flag = True
    supports_cellgrid = False
    _reader = {"he": True}

    def init(self):
        super().init()
        f = self._setfl
        self.rhomax = f.rhomax_file
        self.rhomin = self.rhomax - (f.nrho - 1) * f.drho

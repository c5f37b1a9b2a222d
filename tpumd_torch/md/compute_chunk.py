"""The per-chunk computes (src/compute_*_chunk.cpp) and the small global
computes momentum, count/type, msd/nongauss and gyration/shape, on the
device.

The port of tpumd/md/compute_chunk.py: per-chunk segment sums
(``index_add``) over the chunk IDs of a compute chunk/atom, with the
unwrapped-coordinate and centre-of-mass conventions of the reference
sources.  Results are in chunk order (chunk ID - 1).
"""

from __future__ import annotations

import torch

from tpumd_torch.md import peratom as pa
from tpumd_torch.md.compute_styles import Compute, RefByTag


def chunk_ids(sim, chunkid):
    """(0-based chunk index of each atom in tag order, chunk count)."""
    cchunk = sim.computes[chunkid]
    ids = cchunk(sim).long()
    n = cchunk.nchunk
    return torch.clamp(ids - 1, 0, n - 1), n


def chunk_sum(n, idx, w):
    out = w.new_zeros((n,) + tuple(w.shape[1:]))
    return out.index_add_(0, idx, w)


class ChunkCompute(Compute):
    scalar = False
    per_chunk = True        # rows are chunks: a vector is one column

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args[1:])
        self.chunkid = str(args[0])

    def parts(self, sim):
        """(atoms, chunk index, chunk count, masses zeroed outside the
        group)."""
        a = pa.atoms(sim)
        idx, n = chunk_ids(sim, self.chunkid)
        return a, idx, n, torch.where(self.sel(sim), a.mass, 0.0)

    @staticmethod
    def com(n, idx, xu, m):
        mt = chunk_sum(n, idx, m)
        return chunk_sum(n, idx, xu * m[:, None]) \
            / torch.clamp(mt, min=1e-300)[:, None], mt


class ComputeCOMChunk(ChunkCompute):
    """Per-chunk centre of mass, unwrapped (compute_com_chunk.cpp)."""

    style = "com/chunk"

    def evaluate(self, sim):
        a, idx, n, m = self.parts(sim)
        return self.com(n, idx, a.xu, m)[0]


class ComputeVCMChunk(ChunkCompute):
    """Per-chunk centre-of-mass velocity (compute_vcm_chunk.cpp)."""

    style = "vcm/chunk"

    def evaluate(self, sim):
        a, idx, n, m = self.parts(sim)
        return self.com(n, idx, a.v, m)[0]


class ComputeGyrationChunk(ChunkCompute):
    """Per-chunk radius of gyration (compute_gyration_chunk.cpp)."""

    style = "gyration/chunk"

    def evaluate(self, sim):
        a, idx, n, m = self.parts(sim)
        com, mt = self.com(n, idx, a.xu, m)
        d = a.xu - com[idx]
        rg2 = chunk_sum(n, idx, m * (d * d).sum(1))
        return torch.sqrt(rg2 / torch.clamp(mt, min=1e-300))


class ComputeMSDChunk(ChunkCompute):
    """Per-chunk centre-of-mass MSD from the first evaluation
    (compute_msd_chunk.cpp): dx2 dy2 dz2 total."""

    style = "msd/chunk"

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        self.ref = None

    def evaluate(self, sim):
        a, idx, n, m = self.parts(sim)
        com = self.com(n, idx, a.xu, m)[0]
        if self.ref is None:
            self.ref = com.clone()
        d = com - self.ref
        return torch.cat([d * d, (d * d).sum(1)[:, None]], dim=1)


class ComputeTempChunk(ChunkCompute):
    """Per-chunk temperature (compute_temp_chunk.cpp, temp attribute):
    mvv2e sum m v^2 / (dim N_c kB); com yes removes the chunk's VCM first.
    Without attributes: the global 6-component KE tensor of the chunked
    atoms."""

    style = "temp/chunk"

    def evaluate(self, sim):
        a, idx, n, m = self.parts(sim)
        vv = a.v
        if "com" in self.args and \
                self.args[self.args.index("com") + 1] == "yes":
            vv = a.v - self.com(n, idx, a.v, m)[0][idx]
        u = sim.units
        if "temp" not in self.args:
            return u.mvv2e * torch.stack([
                (m * vv[:, p] * vv[:, q]).sum()
                for p, q in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2),
                             (1, 2))])
        ke = chunk_sum(n, idx, m * (vv * vv).sum(1))
        cnt = chunk_sum(n, idx, self.sel(sim).to(torch.float64))
        dof = sim.dimension * torch.clamp(cnt, min=1.0)
        return u.mvv2e * ke / (dof * u.boltz)


def _arm(a, idx, n, m, com_of):
    return a.xu - com_of(n, idx, a.xu, m)[0][idx]


class ComputeAngmomChunk(ChunkCompute):
    """Per-chunk angular momentum about the chunk's centre of mass
    (compute_angmom_chunk.cpp)."""

    style = "angmom/chunk"

    def evaluate(self, sim):
        a, idx, n, m = self.parts(sim)
        d = _arm(a, idx, n, m, self.com)
        return chunk_sum(n, idx, m[:, None] * torch.linalg.cross(d, a.v))


class ComputeTorqueChunk(ChunkCompute):
    """Per-chunk torque about the chunk's centre of mass
    (compute_torque_chunk.cpp)."""

    style = "torque/chunk"

    def evaluate(self, sim):
        a, idx, n, m = self.parts(sim)
        d = _arm(a, idx, n, m, self.com)
        f = torch.where(self.sel(sim)[:, None], a.f, 0.0)
        return chunk_sum(n, idx, torch.linalg.cross(d, f))


class ComputeInertiaChunk(ChunkCompute):
    """Per-chunk inertia tensor, xx yy zz xy yz xz
    (compute_inertia_chunk.cpp)."""

    style = "inertia/chunk"

    def tensor(self, sim):
        a, idx, n, m = self.parts(sim)
        d = _arm(a, idx, n, m, self.com)
        return chunk_sum(n, idx, torch.stack([
            m * (d[:, 1] ** 2 + d[:, 2] ** 2),
            m * (d[:, 0] ** 2 + d[:, 2] ** 2),
            m * (d[:, 0] ** 2 + d[:, 1] ** 2),
            -m * d[:, 0] * d[:, 1], -m * d[:, 1] * d[:, 2],
            -m * d[:, 0] * d[:, 2]], dim=1))

    def evaluate(self, sim):
        return self.tensor(sim)


class ComputeOmegaChunk(ComputeInertiaChunk):
    """Per-chunk angular velocity, I w = L solved per chunk
    (compute_omega_chunk.cpp); 0 where I is singular."""

    style = "omega/chunk"

    def evaluate(self, sim):
        a, idx, n, m = self.parts(sim)
        d = _arm(a, idx, n, m, self.com)
        ang = chunk_sum(n, idx, m[:, None] * torch.linalg.cross(d, a.v))
        t = self.tensor(sim)
        ione = torch.stack([t[:, 0], t[:, 3], t[:, 5],
                            t[:, 3], t[:, 1], t[:, 4],
                            t[:, 5], t[:, 4], t[:, 2]], dim=1).reshape(n, 3, 3)
        ok = torch.abs(torch.linalg.det(ione)) > 1e-12
        eye = torch.eye(3, dtype=t.dtype, device=t.device)
        w = torch.linalg.solve(torch.where(ok[:, None, None], ione, eye), ang)
        return torch.where(ok[:, None], w, 0.0)


class ComputePropertyChunk(ChunkCompute):
    """compute property/chunk count|id (compute_property_chunk.cpp)."""

    style = "property/chunk"

    def evaluate(self, sim):
        a, idx, n, _ = self.parts(sim)
        cols = []
        for field in self.args:
            if field == "count":
                cols.append(chunk_sum(n, idx, self.sel(sim).double()))
            elif field == "id":
                cols.append(torch.arange(1, n + 1, dtype=torch.float64,
                                         device=a.x.device))
            else:
                raise NotImplementedError(
                    f"property/chunk field {field!r} is not ported (tpumd "
                    "takes count and id)")
        return cols[0] if len(cols) == 1 else torch.stack(cols, dim=1)


class ComputeMomentum(Compute):
    """The group's total momentum (src/compute_momentum.cpp)."""

    style = "momentum"
    scalar = False

    def evaluate(self, sim):
        a = pa.atoms(sim)
        m = torch.where(self.sel(sim), a.mass, 0.0)
        return (m[:, None] * a.v).sum(0)


class ComputeCountType(Compute):
    """Atoms of each type (src/compute_count_type.cpp, atom mode)."""

    style = "count/type"
    scalar = False

    def __init__(self, cid, group, args=()):
        super().__init__(cid, group, args)
        if args and args[0] != "atom":
            raise NotImplementedError("compute count/type: only mode atom "
                                      "is ported")

    def evaluate(self, sim):
        a = pa.atoms(sim)
        t = a.type[self.sel(sim)].long()
        return torch.bincount(t, minlength=sim.ntypes + 1)[1:].double()


class ComputeMSDNonGauss(Compute):
    """MSD, its 4th moment and the non-gaussian parameter
    (src/compute_msd_nongauss.cpp): <r^2>, <r^4>, 3<r^4>/(5<r^2>^2) - 1."""

    style = "msd/nongauss"
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
        d2 = (d * d).sum(1)
        msd, m4 = d2.mean(), (d2 * d2).mean()
        ng = torch.where(msd > 0, 3.0 * m4 / (5.0 * msd * msd) - 1.0, 0.0)
        return torch.stack([msd, m4, ng])


class ComputeGyrationShape(Compute):
    """The gyration tensor's eigenvalues (descending), asphericity,
    acylindricity and kappa^2 (src/EXTRA-COMPUTE/compute_gyration_shape.
    cpp), from the group's unwrapped positions."""

    style = "gyration/shape"
    scalar = False

    def evaluate(self, sim):
        a = pa.atoms(sim)
        m = torch.where(self.sel(sim), a.mass, 0.0)
        com = (m[:, None] * a.xu).sum(0) / m.sum()
        d = a.xu - com
        t = torch.einsum("n,na,nb->ab", m, d, d) / m.sum()
        l3, l2, l1 = torch.linalg.eigvalsh(t)
        tr = l1 + l2 + l3
        b = l1 - 0.5 * (l2 + l3)
        c = l2 - l3
        k2 = torch.where(tr > 0, (b * b + 0.75 * c * c) / (tr * tr), 0.0)
        return torch.stack([l1, l2, l3, b, c, k2])


STYLES = (ComputeCOMChunk, ComputeVCMChunk, ComputeGyrationChunk,
          ComputeMSDChunk, ComputeTempChunk, ComputeAngmomChunk,
          ComputeTorqueChunk, ComputeInertiaChunk, ComputeOmegaChunk,
          ComputePropertyChunk, ComputeMomentum, ComputeCountType,
          ComputeMSDNonGauss, ComputeGyrationShape)

"""Nudged elastic band: the neb command with fix neb (src/REPLICA/neb.cpp,
src/REPLICA/fix_neb.cpp; the port of tpumd/md/neb.py).

The band's R images sit in tag order on a leading axis, (R, N, 3), on the
device; the reference runs one image per partition and sends neighbouring
images' coordinates between them (fix_neb.cpp inter_replica_comm), and here
rolls of the image axis stand in for those sends.  The projection
(``_neb_project``: upwind tangent, parallel spring, climbing image) is
elementwise over the band, as in tpumd, with fix_neb.cpp's defaults (mode
neigh, no perpendicular spring, fixed ends):

- the tangent upwind by the neighbouring images' energies (:336-420),
  normalized over the image;
- an interior image's prefactor -F.t + kspring (|x_next - x| - |x - x_prev|)
  (:566), the climbing image's -2 F.t (:564);
- the end images keep their true forces (:470).

The band relaxes by FIRE (the reference takes min_style quickmin or fire
for neb), in chunks of ``nevery`` iterations with one read of the band's
energies, forces and reaction coordinates a chunk, and two stages: without
a climber for N1 iterations, then with the highest interior image climbing
for N2.

Each image is its own copy of the simulation's state and neighbour
structure on the engine the deck runs on (B1 over its pair list on the cell
grid, the matrix engine's rows elsewhere): its positions are the band's
scattered onto its rows, its forces and energy come from the port's force
evaluation, and its list is rebuilt where an atom of it moved more than
half the skin since its build (the minimizer's every 1 delay 0 check yes),
a rebuild that wraps its positions back into the box.  The skin checks of
all images take one read an iteration.  tpumd instead rebuilds every
image's neighbour matrix at every iteration (a ``vmap`` cannot branch);
the forces are the same, since either list holds every pair within the
cutoff.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpumd_torch.core.state import tag_rows
from tpumd_torch.md.minimize import FIRE_PARAMS
from tpumd_torch.md.prd import clone_tree
from tpumd_torch.md.verlet import _rebuild, compute_forces
from tpumd_torch.ops import cellgrid as cg
from tpumd_torch.ops import neighbor as nb

DMAX = 0.1     # the most an atom moves in a FIRE iteration (tpumd's dmax)


def read_neb_file(path: str, natoms: int):
    """The final-coordinates file: a count line, then 'ID x y z' rows
    (NEB::readfile, src/REPLICA/neb.cpp:446-533).  Returns (tags, coords)
    numpy arrays."""
    rows, count = [], None
    with open(path) as fh:
        for raw in fh:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            t = line.split()
            if count is None:
                count = int(t[0])
                continue
            rows.append((int(t[0]), float(t[1]), float(t[2]), float(t[3])))
    if count is None or len(rows) < count:
        raise ValueError(f"incorrectly formatted NEB file {path!r}")
    rows = rows[:count]
    return (np.asarray([r[0] for r in rows], np.int64),
            np.asarray([r[1:] for r in rows], np.float64))


def _min_image(d, ell, per):
    return d - torch.where(per, torch.round(d / ell) * ell, 0.0)


def _neb_project(x, f, veng, ell, per, gsel, kspring, climber: int):
    """The NEB projection of the band's forces f (R, N, 3) at x, with the
    images' energies veng (R,), the NEB group gsel (N,) bool and the
    climbing image's index (-1: none)."""
    R = x.shape[0]
    sel = gsel[None, :, None]
    delp = _min_image(x - torch.roll(x, 1, 0), ell, per)
    deln = _min_image(torch.roll(x, -1, 0) - x, ell, per)
    vprev, vnext = torch.roll(veng, 1), torch.roll(veng, -1)
    up = ((vnext > veng) & (veng > vprev))[:, None, None]
    down = ((vnext < veng) & (veng < vprev))[:, None, None]
    dvmax = torch.maximum((vnext - veng).abs(), (vprev - veng).abs())
    dvmin = torch.minimum((vnext - veng).abs(), (vprev - veng).abs())
    wn = torch.where(vnext > vprev, dvmax, dvmin)[:, None, None]
    wp = torch.where(vnext > vprev, dvmin, dvmax)[:, None, None]
    mixed = torch.where((vnext == vprev)[:, None, None], deln + delp,
                        wn * deln + wp * delp)
    tangent = torch.where(up, deln, torch.where(down, delp, mixed))
    tangent = torch.where(sel, tangent, 0.0)

    def norm(a):
        return torch.sqrt(torch.sum(a * a, dim=(1, 2)))

    plen = norm(torch.where(sel, delp, 0.0))
    nlen = norm(torch.where(sel, deln, 0.0))
    tangent = tangent / torch.clamp(norm(tangent), min=1e-30)[:, None, None]
    dot = torch.sum(f * tangent, dim=(1, 2))
    lane = torch.arange(R, device=x.device)
    interior = ((lane > 0) & (lane < R - 1))[:, None, None]
    prefactor = torch.where(lane == climber, -2.0 * dot,
                            -dot + kspring * (nlen - plen))
    fneb = f + prefactor[:, None, None] * tangent
    return torch.where(interior & sel, fneb, f)


class _Band:
    """The images' states and neighbour structures, and their force
    evaluation; counts evaluations, rebuilds and host reads.  The images'
    first builds grow the simulation's capacities where one overflows (an
    interpolated image crowds cells that neither end does); a later
    overflow raises at the end of its chunk."""

    def __init__(self, sim, xs):
        self.sim, self.n = sim, sim.natoms
        for _ in range(8):
            self.ctx = sim._ctx
            s0, neigh0, _ = sim._carry
            self.images = []
            for r in range(xs.shape[0]):
                s = s0.replace(x=self._scatter(s0, xs[r]))
                s, neigh = _rebuild(s, clone_tree(neigh0), self.ctx)
                self.images.append([s, neigh, tag_rows(s.tag, self.n)])
            over = [self._over(neigh) for _, neigh, _ in self.images]
            worst = int(torch.argmax(torch.stack(over).to(torch.int32)))
            if not bool(over[worst]):
                break
            neigh = self.images[worst][1]
            if self.ctx.is_cellgrid:
                sim._grow_grid(neigh, neigh.max_count)
            else:
                sim._grow_matrix(neigh)
            sim.rebin_grown(sim._carry)
        self.evals = self.rebuilds = self.reads = 0
        self.overflow = torch.zeros((), dtype=torch.bool, device=s0.x.device)

    def _over(self, neigh):
        return neigh.any_overflow if self.ctx.is_cellgrid else neigh.overflow

    def _scatter(self, s, xb, rows=None):
        rows = tag_rows(s.tag, self.n) if rows is None else rows
        return s.x.index_copy(0, rows, xb.to(s.x.dtype))

    def positions(self):
        """(R, N, 3): every image's positions in tag order."""
        return torch.stack([s.x[rows] for s, _, rows in self.images])

    def _exceeded(self, s, neigh):
        cfg = self.ctx.neigh_cfg
        if self.ctx.is_cellgrid:
            return cg.displacement_exceeded(s.x, neigh.xhold, neigh.valid,
                                            s.box, cfg.skin, neigh.lohold,
                                            neigh.hihold)
        return nb.displacement_exceeded(s.x, neigh.xhold, s.box, cfg.skin)

    def evaluate(self, xs):
        """Move the images to xs (R, N, 3), rebuild the lists that need it
        (one read for all images' checks), and return (xs as the images now
        hold them, wrapped where rebuilt; forces (R, N, 3) in tag order;
        energies (R,))."""
        for img, xb in zip(self.images, xs):
            s, neigh, rows = img
            img[0] = s.replace(x=self._scatter(s, xb, rows))
            img[1] = neigh.replace(ago=neigh.ago + 1)
        flags = torch.stack([self._exceeded(s, neigh)
                             for s, neigh, _ in self.images]).tolist()
        self.reads += 1
        fs, es = [], []
        for img, flag in zip(self.images, flags):
            s, neigh, rows = img
            if flag:
                s, neigh = _rebuild(s, neigh, self.ctx)
                rows = tag_rows(s.tag, self.n)
                self.rebuilds += 1
            f, energies, _, _, neigh = compute_forces(
                s, neigh, self.ctx, eflag=True, vflag=False)
            self.overflow = self.overflow | self._over(neigh)
            img[:] = [s, neigh, rows]
            fs.append(f[rows])
            es.append(sum(energies.values()))
        self.evals += len(self.images)
        return self.positions(), torch.stack(fs), torch.stack(es)


def neb(sim, etol, ftol, n1, n2, nevery, final_tags, final_xyz,
        kspring=1.0, nreplica=None, group_bit=1, log=print):
    """The two-stage climbing-image NEB (NEB::run, src/REPLICA/neb.cpp:
    200-380) from the simulation's current state to the final coordinates
    (by tag) over nreplica images.  Returns a dict: the last chunk's
    ``step``, ``fmax_atom``, ``fmax_replica``, ``energies``, ``ebf``,
    ``ebr`` and ``rd``, the ``climber``, ``stage1``'s dict, ``band_x``
    (R, N, 3) f64 in tag order, ``wall_s``, and the counts ``iterations``,
    ``evaluations``, ``rebuilds``, ``reads`` (host reads) and ``chunks``.
    The climbing image's configuration is left in the simulation."""
    if nreplica is None or nreplica < 3:
        raise ValueError("neb needs >= 3 replicas")
    if sim._ctx is None:
        sim.setup()
    if not getattr(sim, "_neb_grown", False):
        # interpolated images squeeze the hopping atoms past their
        # neighbours: room for longer rows up front (tpumd/md/neb.py:
        # 142-148), once per simulation
        ctx = sim._ctx
        k = ctx.pairlist_k if ctx.is_cellgrid else ctx.neigh_cfg.kmax
        sim._kmax_override = int(k * 1.5) + 16
        sim.rebin_grown(sim._carry)
        sim._neb_grown = True
    R, n = int(nreplica), sim.natoms
    s0 = sim._carry[0]
    dev, dt_ = s0.x.device, s0.x.dtype
    rows0 = tag_rows(s0.tag, n)
    ell_h = s0.box.lengths_np().astype(np.float64)
    per_h = np.asarray(s0.box.periodic)
    ell = torch.as_tensor(ell_h, dtype=dt_, device=dev)
    per = torch.as_tensor(per_h, device=dev)

    # the band: linear interpolation along the minimum-image displacement
    # to the final coordinates (NEB::readfile:533-560)
    x0 = s0.x[rows0].double().cpu().numpy()
    dx = np.zeros_like(x0)
    for t, xyz in zip(final_tags, final_xyz):
        if not 1 <= int(t) <= n:
            raise ValueError(f"invalid atom ID {t} in NEB file")
        d = xyz - x0[int(t) - 1]
        dx[int(t) - 1] = d - np.where(per_h, np.round(d / ell_h) * ell_h,
                                      0.0)
    fracs = np.arange(R, dtype=np.float64) / (R - 1)
    xs = torch.as_tensor(x0[None] + fracs[:, None, None] * dx[None],
                         dtype=dt_, device=dev)
    gmask = s0.gmask[rows0] if s0.gmask is not None else None
    gsel = (torch.ones(n, dtype=torch.bool, device=dev)
            if group_bit == 1 or gmask is None else (gmask & group_bit) > 0)
    band = _Band(sim, xs)
    xs = band.positions()
    invm = (1.0 / sim._ctx.mass_per_atom(s0)[rows0])[:, None]
    p = FIRE_PARAMS
    dt0 = sim._ctx.dt
    vels = torch.zeros_like(xs)
    dts = torch.full((R,), dt0, dtype=dt_, device=dev)
    alphas = torch.full((R,), p["alpha0"], dtype=dt_, device=dev)
    nnegs = torch.zeros(R, dtype=torch.int64, device=dev)
    counts = {"iterations": 0, "chunks": 0}

    def chunk(niter, climber):
        """niter FIRE iterations of the band with projected forces, then
        the diagnostics at the new positions (tpumd/md/neb.py:209-255)."""
        nonlocal xs, vels, dts, alphas, nnegs
        for _ in range(niter):
            xs, fs, vengs = band.evaluate(xs)
            fs = _neb_project(xs, fs, vengs, ell, per, gsel, kspring,
                              climber)
            v = vels + dts[:, None, None] * fs * invm[None]
            vdotf = torch.sum(v * fs, dim=(1, 2))
            fnorm = torch.sqrt(torch.sum(fs * fs, dim=(1, 2)))
            vnorm = torch.sqrt(torch.sum(v * v, dim=(1, 2)))
            mix = ((1.0 - alphas)[:, None, None] * v
                   + (alphas * vnorm / torch.clamp(fnorm, min=1e-30))
                   [:, None, None] * fs)
            uphill = vdotf <= 0.0
            v = torch.where(uphill[:, None, None], 0.0, mix)
            grow = ~uphill & (nnegs > p["delaystep"])
            dts = torch.where(grow, torch.clamp(dts * p["dt_grow"],
                                                max=p["tmax"] * dt0), dts)
            alphas = torch.where(grow, alphas * p["alpha_shrink"], alphas)
            dts = torch.where(uphill, dts * p["dt_shrink"], dts)
            alphas = torch.where(uphill, torch.full_like(alphas,
                                                         p["alpha0"]),
                                 alphas)
            nnegs = torch.where(uphill, 0, nnegs + 1)
            dstep = dts[:, None, None] * v
            dlen = torch.sqrt(torch.sum(dstep * dstep, dim=-1, keepdim=True))
            xs = xs + dstep * torch.clamp(DMAX / torch.clamp(dlen, min=1e-30),
                                          max=1.0)
            vels = v
        counts["iterations"] += niter
        counts["chunks"] += 1
        xs, fs, vengs = band.evaluate(xs)
        fs = _neb_project(xs, fs, vengs, ell, per, gsel, kspring, climber)
        seg = _min_image(xs[1:] - xs[:-1], ell, per)
        seglen = torch.sqrt(torch.sum(seg.double() ** 2, dim=(1, 2)))
        words = torch.cat([
            vengs.double(), torch.amax(fs.abs()).double().reshape(1),
            torch.sqrt(torch.amax(torch.sum(fs * fs, dim=(1, 2)))).double()
            .reshape(1), band.overflow.double().reshape(1), seglen])
        band.reads += 1
        return words.tolist()

    def stage(tag, nsteps, climber):
        e_prev, out, done = None, None, 0
        log(f"NEB {tag}: Step MaxReplicaForce MaxAtomForce EBF EBR RDn PEn "
            "...")
        while done < nsteps:
            it = min(nevery, nsteps - done)
            words = chunk(it, climber)
            done += it
            vh = np.asarray(words[:R])
            fa, fr, ovf = words[R:R + 3]
            if ovf:
                raise RuntimeError("neb: neighbour overflow in a band image "
                                   "(the band grows no capacity)")
            rd = np.concatenate([[0.0], np.cumsum(words[R + 3:])])
            rd = (rd / (rd[-1] if rd[-1] > 0 else 1.0)).tolist()
            ebf, ebr = float(vh.max() - vh[0]), float(vh.max() - vh[-1])
            cols = " ".join(f"{r:.4f} {e:.6f}" for r, e in zip(rd, vh))
            log(f"NEB {tag} {done:6d} {fr:.6g} {fa:.6g} {ebf:.8g} "
                f"{ebr:.8g} {cols}")
            out = dict(step=done, fmax_atom=fa, fmax_replica=fr,
                       energies=vh.tolist(), ebf=ebf, ebr=ebr, rd=rd)
            if fa < ftol:
                break
            if e_prev is not None and abs(vh.max() - e_prev) \
                    < etol * max(abs(vh.max()), 1e-30):
                break
            e_prev = vh.max()
        return out

    t0 = time.perf_counter()
    res1 = stage("stage1", n1, -1)
    top = int(np.argmax(np.asarray(res1["energies"][1:-1]))) + 1
    res2 = stage("stage2(climb)", n2, top)
    res2.update(climber=top, stage1=res1,
                band_x=xs.double().cpu().numpy(), evaluations=band.evals,
                rebuilds=band.rebuilds, reads=band.reads, **counts)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    res2["wall_s"] = time.perf_counter() - t0
    # the simulation goes on from the climbing image
    s, neigh, _ = band.images[top]
    sim._carry = (s, neigh, sim._carry[2])
    sim.state = s
    sim._energies_of = None
    return res2

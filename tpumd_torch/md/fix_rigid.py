"""fix rigid, rigid/nve, rigid/nvt, rigid/npt, rigid/nph (and each /small):
rigid-body time integration.

PyTorch counterpart of tpumd/md/fix_rigid.py (the reference's FixRigid,
src/RIGID/fix_rigid.cpp, and FixRigidNH, src/RIGID/fix_rigid_nh.cpp) for
clusters of point particles: bodies per molecule ID, per listed group or
one body of the fix's atoms.  A body carries (xcm, vcm, quaternion,
angmom); its atoms are slaved to the body frame every step (set_xv :1330,
set_v :1503).  rigid and rigid/nve integrate the body with velocity Verlet
and the Richardson quaternion update; rigid/nvt, rigid/npt and rigid/nph
with the symplectic no-squish rotor splitting and Nose-Hoover chains on
the translational and rotational motion (Kamberaj, Low, Neal 2005), and
rigid/npt and rigid/nph with the MTK barostat on the bodies' kinetic
energy, which dilates the box, the atoms and the centres of mass about the
box centre in two half steps around set_xv.

Body sums are ``index_add_`` over a body index kept in tag space (per
tag-1), so it holds across the cell grid's re-bins; the per-atom slaving
gathers from the (B, ...) body tables.  The static body geometry (mass,
principal moments, body-frame displacements) is set up on the host in
float64 with ``numpy.linalg.eigh`` standing in for the reference's Jacobi
sweeps (the same principal frame up to the eigenvectors' signs, to which
the dynamics are blind).  The /small styles are the same integrators.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tpumd_torch.md.fixes import Fix

EPSILON = 1.0e-7  # rigid_const.h:38: the zero-moment threshold


# ------------------------------------------------------------- quaternions
# batched MathExtra (src/math_extra.cpp, .h) over a (B, ...) leading axis

def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def qnormalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def vecquat(a, b):
    """c = (0, a) * b for a 3-vector a and a quaternion b."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2, b3 = b.unbind(-1)
    return torch.stack([-a0 * b1 - a1 * b2 - a2 * b3,
                        b0 * a0 + a1 * b3 - a2 * b2,
                        b0 * a1 + a2 * b1 - a0 * b3,
                        b0 * a2 + a0 * b2 - a1 * b1], dim=-1)


def quatvec(a, b):
    """c = a * (0, b) for a quaternion a and a 3-vector b."""
    a0, a1, a2, a3 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([-a1 * b0 - a2 * b1 - a3 * b2,
                        a0 * b0 + a2 * b2 - a3 * b1,
                        a0 * b1 + a3 * b0 - a1 * b2,
                        a0 * b2 + a1 * b1 - a2 * b0], dim=-1)


def invquatvec(a, b):
    """The vector part of conj(a) * b for quaternions a, b."""
    a0, a1, a2, a3 = a.unbind(-1)
    b0, b1, b2, b3 = b.unbind(-1)
    return torch.stack([-a1 * b0 + a0 * b1 + a3 * b2 - a2 * b3,
                        -a2 * b0 - a3 * b1 + a0 * b2 + a1 * b3,
                        -a3 * b0 + a2 * b1 - a1 * b2 + a0 * b3], dim=-1)


def quat_to_mat(q):
    """(B, 4) -> (B, 3, 3) rotation with the body axes ex, ey, ez as its
    columns (quat_to_mat, q_to_exyz)."""
    w, i, j, k = q.unbind(-1)
    ex = torch.stack([w * w + i * i - j * j - k * k,
                      2 * (i * j + w * k), 2 * (i * k - w * j)], dim=-1)
    ey = torch.stack([2 * (i * j - w * k), w * w - i * i + j * j - k * k,
                      2 * (j * k + w * i)], dim=-1)
    ez = torch.stack([2 * (i * k + w * j), 2 * (j * k - w * i),
                      w * w - i * i - j * j + k * k], dim=-1)
    return torch.stack([ex, ey, ez], dim=-1)


def _rt(rot, a):
    """R^T a, batched: space frame to body frame."""
    return torch.einsum("...ji,...j->...i", rot, a)


def _r(rot, a):
    """R a, batched: body frame to space frame."""
    return torch.einsum("...ij,...j->...i", rot, a)


def angmom_to_omega(m, rot, idiag):
    """w = R diag(1/I) R^T m, the zero-moment components dropped
    (math_extra.cpp:259)."""
    zero = idiag == 0.0
    wbody = torch.where(zero, 0.0,
                        _rt(rot, m) / torch.where(zero, 1.0, idiag))
    return _r(rot, wbody)


# no_squish_rotate's permutation operators for k = 1, 2, 3
_NSQ_IDX = {1: (1, 0, 3, 2), 2: (2, 3, 0, 1), 3: (3, 2, 1, 0)}
_NSQ_SGN = {1: (-1.0, 1.0, 1.0, -1.0), 2: (-1.0, -1.0, 1.0, 1.0),
            3: (-1.0, 1.0, -1.0, 1.0)}


def no_squish_rotate(k, p, q, inertia, dt):
    """One free-rotor sub-rotation of the no-squish integrator
    (math_extra.cpp:203, Miller et al. 2002), batched over bodies: p the
    conjugate quaternion momentum, q the quaternion."""
    idx = list(_NSQ_IDX[k])
    sgn = torch.tensor(_NSQ_SGN[k], dtype=p.dtype, device=p.device)
    kq = q[..., idx] * sgn
    kp = p[..., idx] * sgn
    phi = torch.sum(p * kq, dim=-1)
    inert = inertia[..., k - 1]
    zero = inert == 0.0
    phi = torch.where(zero, 0.0, phi / (4.0 * torch.where(zero, 1.0, inert)))
    c = torch.cos(dt * phi)[..., None]
    s = torch.sin(dt * phi)[..., None]
    return c * p + s * kp, c * q + s * kq


def maclaurin_series(x):
    """sinh(x)/x by its Maclaurin expansion (fix_rigid_nh.h:89)."""
    x2 = x * x
    x4 = x2 * x2
    return (1.0 + x2 / 6.0 + x4 / 120.0 + x2 * x4 / 5040.0
            + x4 * x4 / 362880.0)


def richardson(q, m, w, moments, dtq):
    """The Richardson-extrapolated quaternion update (math_extra.cpp:100)."""
    wq = vecquat(w, q)
    qfull = qnormalize(q + dtq * wq)
    qhalf = qnormalize(q + 0.5 * dtq * wq)
    w2 = angmom_to_omega(m, quat_to_mat(qhalf), moments)
    qhalf = qnormalize(qhalf + 0.5 * dtq * vecquat(w2, qhalf))
    return qnormalize(2.0 * qhalf - qfull)


def _exyz_to_q_np(e):
    """Host: a rotation (columns ex, ey, ez) to its quaternion
    (math_extra.cpp:328)."""
    ex, ey, ez = e[:, 0], e[:, 1], e[:, 2]
    q = np.zeros(4)
    q0sq = 0.25 * (ex[0] + ey[1] + ez[2] + 1.0)
    q1sq = q0sq - 0.5 * (ey[1] + ez[2])
    q2sq = q0sq - 0.5 * (ex[0] + ez[2])
    q3sq = q0sq - 0.5 * (ex[0] + ey[1])
    if q0sq >= 0.25:
        q[0] = np.sqrt(q0sq)
        q[1] = (ey[2] - ez[1]) / (4.0 * q[0])
        q[2] = (ez[0] - ex[2]) / (4.0 * q[0])
        q[3] = (ex[1] - ey[0]) / (4.0 * q[0])
    elif q1sq >= 0.25:
        q[1] = np.sqrt(q1sq)
        q[0] = (ey[2] - ez[1]) / (4.0 * q[1])
        q[2] = (ey[0] + ex[1]) / (4.0 * q[1])
        q[3] = (ex[2] + ez[0]) / (4.0 * q[1])
    elif q2sq >= 0.25:
        q[2] = np.sqrt(q2sq)
        q[0] = (ez[0] - ex[2]) / (4.0 * q[2])
        q[1] = (ey[0] + ex[1]) / (4.0 * q[2])
        q[3] = (ez[1] + ey[2]) / (4.0 * q[2])
    else:
        q[3] = np.sqrt(q3sq)
        q[0] = (ex[1] - ey[0]) / (4.0 * q[3])
        q[1] = (ez[0] + ex[2]) / (4.0 * q[3])
        q[2] = (ez[1] + ey[2]) / (4.0 * q[3])
    return q / np.linalg.norm(q)


def _ramp(start, stop, fst):
    """start + delta (stop - start), delta the run's fraction done."""
    den = fst.end - fst.begin
    delta = (fst.step - fst.begin) / den if den > 0 else 0.0
    return start + delta * (stop - start)


@dataclasses.dataclass(frozen=True)
class RigidState:
    xcm: torch.Tensor        # (B, 3) unwrapped centres of mass
    vcm: torch.Tensor        # (B, 3)
    quat: torch.Tensor       # (B, 4)
    angmom: torch.Tensor     # (B, 3) space frame
    omega: torch.Tensor      # (B, 3) space frame
    virial: torch.Tensor     # (6,) the constraint forces' virial this step
    inertia: torch.Tensor    # (B, 3) principal moments
    masstotal: torch.Tensor  # (B,)
    body_tag: torch.Tensor   # (natoms,) int64 body per tag-1, -1: none
    disp_tag: torch.Tensor   # (natoms, 3) body-frame displacement per tag-1
    # the no-squish and Nose-Hoover extension (rigid/nvt, npt, nph); the
    # chains are host floats (C links each)
    conjqm: torch.Tensor | None = None    # (B, 4) conjugate momentum
    eta_t: tuple = ()                     # translational chain
    eta_r: tuple = ()                     # rotational chain
    eta_dot_t: tuple = ()
    eta_dot_r: tuple = ()
    f_eta_t: tuple = ()                   # the chain forces
    f_eta_r: tuple = ()
    step: int = 0                         # the timestep (host schedule)
    begin: int = 0                        # the run's first and last steps
    end: int = 0
    # the barostat (rigid/npt, rigid/nph)
    epsilon: torch.Tensor | None = None       # (3,)
    epsilon_dot: torch.Tensor | None = None   # (3,)
    eta_b: tuple = ()                         # its chain (host floats)
    eta_dot_b: tuple = ()
    f_eta_b: tuple = ()
    mtk_term2: torch.Tensor | None = None     # ()
    akin_t: torch.Tensor | None = None        # () 2 KE of the bodies
    akin_r: torch.Tensor | None = None
    virial_save: torch.Tensor | None = None   # (6,) the step's virial

    def replace(self, **kw) -> "RigidState":
        return dataclasses.replace(self, **kw)


class FixRigid(Fix):
    """fix ID group rigid|rigid/nve[/small] single|molecule|group N g1 ...;
    point particles only (src/RIGID/fix_rigid_nve.cpp is FixRigid without
    the langevin extras)."""

    name = "rigid"
    contributes_virial = True

    def __init__(self, style="molecule", group_bits=()):
        if style not in ("single", "molecule", "group"):
            raise ValueError(f"fix rigid bodystyle {style!r}: single, "
                             "molecule or group")
        self.style = style
        self.group_bits = tuple(group_bits)
        self.nbody = 0
        self.dof_removed = 0

    def virial_contrib(self, fstate):
        return fstate.virial

    # ------------------------------------------------------------- setup
    def _body_assignment(self, tag, sel, mol, gmask):
        """(natoms,) body per tag-1 (-1: in no body) and the body count."""
        body_tag = np.full(int(tag.max()), -1, np.int64)
        rows = np.nonzero(sel)[0]
        if self.style == "single":
            body_tag[tag[rows] - 1] = 0
            return body_tag, 1
        if self.style == "molecule":
            if mol is None:
                raise ValueError("fix rigid molecule needs molecule IDs")
            mids, inv = np.unique(mol[rows], return_inverse=True)
            body_tag[tag[rows] - 1] = inv
            return body_tag, len(mids)
        # without a group command every atom is in group all (bit 1) only
        gm = gmask if gmask is not None else np.ones_like(tag)
        for i, bit in enumerate(self.group_bits):
            inb = ((gm & bit) > 0) & (tag > 0)
            body_tag[tag[inb] - 1] = i
        return body_tag, len(self.group_bits)

    def init_state(self, s, ctx):
        """The host-side f64 body set-up (setup_bodies_static :1640,
        setup_bodies_dynamic :2159): masses, centres, inertia tensors,
        principal frames, body-frame displacements, vcm and angmom."""
        dev, dt_ = s.x.device, s.x.dtype

        def host(t):
            return t.detach().cpu().numpy()
        tag = host(s.tag).astype(np.int64)
        valid = tag > 0
        x = host(s.x).astype(np.float64)
        v = host(s.v).astype(np.float64)
        img = host(s.image).astype(np.float64)
        gm = None if s.gmask is None else host(s.gmask)
        mol = None if s.molecule is None else host(s.molecule)
        ell = s.box.lengths_np()
        xy, xz, yz = ((0.0, 0.0, 0.0) if s.box.tilt is None else
                      host(s.box.tilt).astype(np.float64))
        m = host(ctx.mass_per_atom(s)).astype(np.float64)
        sel = valid & ((gm & self.groupbit) > 0 if self.groupbit != 1
                       else True)
        body_tag, nbody = self._body_assignment(tag, sel, mol, gm)
        self.nbody = nbody

        # unwrapped coordinates (Domain::unmap, with the tilt shifts)
        u = np.stack([
            x[:, 0] + img[:, 0] * ell[0] + img[:, 1] * xy + img[:, 2] * xz,
            x[:, 1] + img[:, 1] * ell[1] + img[:, 2] * yz,
            x[:, 2] + img[:, 2] * ell[2]], axis=1)
        rows = np.nonzero(valid)[0]
        rows = rows[body_tag[tag[rows] - 1] >= 0]
        b = body_tag[tag[rows] - 1]
        mb, ub, vb = m[rows], u[rows], v[rows]
        masstotal = np.zeros(nbody)
        np.add.at(masstotal, b, mb)
        xcm = np.zeros((nbody, 3))
        np.add.at(xcm, b, mb[:, None] * ub)
        xcm /= masstotal[:, None]

        # the inertia tensors (:1830) and their principal frames
        d = ub - xcm[b]
        it = np.zeros((nbody, 6))
        np.add.at(it, b, np.stack([
            mb * (d[:, 1] ** 2 + d[:, 2] ** 2),
            mb * (d[:, 0] ** 2 + d[:, 2] ** 2),
            mb * (d[:, 0] ** 2 + d[:, 1] ** 2),
            -mb * d[:, 1] * d[:, 2], -mb * d[:, 0] * d[:, 2],
            -mb * d[:, 0] * d[:, 1]], axis=1))
        tens = np.stack([it[:, [0, 5, 4]], it[:, [5, 1, 3]],
                         it[:, [4, 3, 2]]], axis=1)
        evals, evecs = np.linalg.eigh(tens)
        # jacobi3's SORT_DECREASING
        evals, evecs = evals[:, ::-1].copy(), evecs[:, :, ::-1].copy()
        evals[evals < EPSILON * np.maximum(evals.max(1, keepdims=True),
                                           0.0)] = 0.0
        nlinear = int((evals == 0.0).any(axis=1).sum())
        # a right-handed frame: flip ez where needed
        flip = np.einsum("ni,ni->n", np.cross(evecs[:, :, 0],
                                              evecs[:, :, 1]),
                         evecs[:, :, 2]) < 0
        evecs[flip, :, 2] *= -1.0
        inertia, rot = evals, evecs
        quat = np.stack([_exyz_to_q_np(r) for r in rot]) if nbody else \
            np.zeros((0, 4))

        # displacements in the body frame (transpose_matvec)
        disp_tag = np.zeros((body_tag.shape[0], 3))
        disp_tag[tag[rows] - 1] = np.einsum("nji,nj->ni", rot[b], d)
        vcm = np.zeros((nbody, 3))
        np.add.at(vcm, b, mb[:, None] * vb)
        vcm /= masstotal[:, None]
        angmom = np.zeros((nbody, 3))
        np.add.at(angmom, b, np.cross(d, mb[:, None] * vb))
        wbody = np.einsum("nji,nj->ni", rot, angmom)
        wbody = np.where(inertia == 0.0, 0.0,
                         wbody / np.where(inertia == 0.0, 1.0, inertia))
        omega = np.einsum("nij,nj->ni", rot, wbody)

        # 3N - 6 dof removed per body, one more for a linear body (:1281)
        ncount = np.bincount(b, minlength=nbody)
        self.dof_removed = int((3 * ncount - 6).sum() + nlinear)

        def t(a):
            return torch.as_tensor(a, dtype=dt_, device=dev)
        return RigidState(
            xcm=t(xcm), vcm=t(vcm), quat=t(quat), angmom=t(angmom),
            omega=t(omega), virial=torch.zeros(6, dtype=dt_, device=dev),
            inertia=t(inertia), masstotal=t(masstotal),
            body_tag=torch.as_tensor(body_tag, device=dev),
            disp_tag=t(disp_tag))

    # ------------------------------------------------------------ device
    def _atom_body(self, s, fst):
        """(body (N,), clamped body (N,), disp (N, 3)) of each slot."""
        rows = torch.clamp(s.tag.long() - 1, min=0)
        body = torch.where(s.tag > 0, fst.body_tag[rows], -1)
        return body, torch.clamp(body, min=0), fst.disp_tag[rows]

    @staticmethod
    def _shift(s):
        """The image shift of each slot, unwrapped - wrapped."""
        box = s.box
        ell = box.lengths
        img = s.image.to(s.x.dtype)
        sx = img[:, 0] * ell[0]
        sy = img[:, 1] * ell[1]
        if box.tilt is not None:
            xy, xz, yz = box.tilt.unbind()
            sx = sx + img[:, 1] * xy + img[:, 2] * xz
            sy = sy + img[:, 2] * yz
        return torch.stack([sx, sy, img[:, 2] * ell[2]], dim=1)

    def _fcm_torque(self, s, fst, body, bidx):
        """The bodies' forces and torques about xcm
        (compute_forces_and_torques :1021)."""
        nb = fst.xcm.shape[0]
        seg = torch.where(body >= 0, body, nb)
        fcm = s.f.new_zeros((nb + 1, 3)).index_add_(0, seg, s.f)[:nb]
        arm = s.x + self._shift(s) - fst.xcm[bidx]
        tq = torch.where((body >= 0)[:, None], _cross(arm, s.f), 0.0)
        torque = s.f.new_zeros((nb + 1, 3)).index_add_(0, seg, tq)[:nb]
        return fcm, torque

    def _slave_v(self, fst, bidx, disp):
        """The body-frame velocities of the slaved atoms (set_v :1503)."""
        rot = quat_to_mat(fst.quat)
        delta = torch.einsum("nij,nj->ni", rot[bidx], disp)
        return _cross(fst.omega[bidx], delta) + fst.vcm[bidx]

    def _virial_half(self, s, ctx, vnew, body):
        """Half the constraint forces' virial, unwrap(x) (x) f_c
        (set_xv's tally :1414), in Voigt order."""
        dtf = 0.5 * ctx.dt * ctx.units.ftm2v
        m = ctx.mass_per_atom(s)[:, None]
        fc = torch.where((body >= 0)[:, None],
                         m * (vnew - s.v) / dtf - s.f, 0.0)
        u = s.x + self._shift(s)
        return 0.5 * torch.stack([
            torch.sum(u[:, 0] * fc[:, 0]), torch.sum(u[:, 1] * fc[:, 1]),
            torch.sum(u[:, 2] * fc[:, 2]), torch.sum(u[:, 0] * fc[:, 1]),
            torch.sum(u[:, 0] * fc[:, 2]), torch.sum(u[:, 1] * fc[:, 2])])

    def _set_v(self, s, fst, ctx, body, bidx, disp):
        """set_v: the slaved velocities, and the virial's second half."""
        vnew = self._slave_v(fst, bidx, disp)
        vhalf = self._virial_half(s, ctx, vnew, body)
        return (s.replace(v=torch.where((body >= 0)[:, None], vnew, s.v)),
                vhalf)

    def _set_xv(self, s, fst, ctx, body, bidx, disp, rot):
        """set_xv :1330: the slaved positions and velocities; the virial's
        first half uses the positions from before."""
        delta = torch.einsum("nij,nj->ni", rot[bidx], disp)
        vnew = _cross(fst.omega[bidx], delta) + fst.vcm[bidx]
        xnew = delta + fst.xcm[bidx] - self._shift(s)
        vhalf = self._virial_half(s, ctx, vnew, body)
        inbody = (body >= 0)[:, None]
        s = s.replace(x=torch.where(inbody, xnew, s.x),
                      v=torch.where(inbody, vnew, s.v))
        return s, fst.replace(virial=vhalf)

    def setup_post_force(self, s, fstate, ctx, xin=None):
        """FixRigid::setup :783: the velocities projected on the bodies'
        motion, the constraint virial estimated as twice set_v's half."""
        body, bidx, disp = self._atom_body(s, fstate)
        fstate = fstate.replace(omega=angmom_to_omega(
            fstate.angmom, quat_to_mat(fstate.quat), fstate.inertia))
        s, vhalf = self._set_v(s, fstate, ctx, body, bidx, disp)
        return s, fstate.replace(virial=2.0 * vhalf)

    def initial_integrate(self, s, fstate, ctx):
        fst = fstate
        body, bidx, disp = self._atom_body(s, fst)
        dtf = 0.5 * ctx.dt * ctx.units.ftm2v
        dtq = 0.5 * ctx.dt
        fcm, torque = self._fcm_torque(s, fst, body, bidx)
        vcm = fst.vcm + (dtf / fst.masstotal)[:, None] * fcm
        xcm = fst.xcm + ctx.dt * vcm
        angmom = fst.angmom + dtf * torque
        omega = angmom_to_omega(angmom, quat_to_mat(fst.quat), fst.inertia)
        quat = richardson(fst.quat, angmom, omega, fst.inertia, dtq)
        rot = quat_to_mat(quat)
        # the reference updates w in place: omega at the new quaternion
        omega = angmom_to_omega(angmom, rot, fst.inertia)
        fst = fst.replace(vcm=vcm, xcm=xcm, angmom=angmom, quat=quat,
                          omega=omega)
        return self._set_xv(s, fst, ctx, body, bidx, disp, rot)

    def final_integrate(self, s, fstate, ctx):
        fst = fstate
        body, bidx, disp = self._atom_body(s, fst)
        dtf = 0.5 * ctx.dt * ctx.units.ftm2v
        fcm, torque = self._fcm_torque(s, fst, body, bidx)
        vcm = fst.vcm + (dtf / fst.masstotal)[:, None] * fcm
        angmom = fst.angmom + dtf * torque
        omega = angmom_to_omega(angmom, quat_to_mat(fst.quat), fst.inertia)
        fst = fst.replace(vcm=vcm, angmom=angmom, omega=omega)
        s, vhalf = self._set_v(s, fst, ctx, body, bidx, disp)
        return s, fst.replace(virial=fst.virial + vhalf)


class FixRigidNVT(FixRigid):
    """fix ID group rigid/nvt[/small] <bodystyle> temp T1 T2 Tdamp
    [tparam chain iter order]: FixRigidNH with a thermostat
    (fix_rigid_nh.cpp:430-718), no-squish rotors and two Nose-Hoover
    chains (nhc_temp_integrate :721).  The chains are a few scalars each:
    they live on the host in float64, and their Suzuki-Yoshida sweeps run
    there from the bodies' kinetic energies, read once a step, instead of
    as a thousand launches of () tensors; the card reads back only their
    scale factors, as Python floats."""

    name = "rigid/nvt"
    needs_step = True

    def __init__(self, style="molecule", group_bits=(), t_start=None,
                 t_stop=None, t_period=None, t_chain=10, t_iter=1,
                 t_order=3):
        super().__init__(style=style, group_bits=group_bits)
        if t_start is None:
            raise ValueError(f"fix {self.name} needs the temp keyword")
        if t_order not in (3, 5):
            raise ValueError(f"fix {self.name} tparam order {t_order}: 3 or "
                             "5")
        self.t_start, self.t_stop = float(t_start), float(t_stop)
        self.t_freq = 1.0 / float(t_period)
        self.t_chain, self.t_iter = int(t_chain), int(t_iter)
        self.t_order = int(t_order)
        self.tstat = True
        self.nf_t = self.nf_r = 0

    def set_step(self, fstate, istep):
        return fstate.replace(step=istep)

    def pre_run(self, fstate, begin: int, end: int):
        return fstate.replace(begin=begin, end=end)

    def _t_target(self, fst) -> float:
        return _ramp(self.t_start, self.t_stop, fst)

    def init_state(self, s, ctx):
        fst = super().init_state(s, ctx)
        # translational and rotational thermostat dof (:227-239)
        inertia = fst.inertia.detach().cpu().numpy()
        self.nf_t = 3 * self.nbody
        self.nf_r = 3 * self.nbody - int((np.abs(inertia) < EPSILON).sum())
        C = self.t_chain
        zc = (0.0,) * C
        # the chain forces with eta_dot = 0 (setup :385-390): -kT / t_mass
        # above the first; rigid/nph runs no chain (tpumd divides 0 by 0
        # there, ROADMAP C13)
        kt = ctx.units.boltz * self.t_start
        f0 = (0.0,) + (-kt / (kt / (self.t_freq * self.t_freq))
                       if self.tstat else 0.0,) * (C - 1)
        return fst.replace(conjqm=self._conjqm(fst), eta_t=zc, eta_r=zc,
                           eta_dot_t=zc, eta_dot_r=zc, f_eta_t=f0,
                           f_eta_r=f0)

    @staticmethod
    def _conjqm(fst):
        """conjqm = 2 quat * (0, R^T angmom) (:330-336)."""
        return 2.0 * quatvec(fst.quat, _rt(quat_to_mat(fst.quat),
                                            fst.angmom))

    def _w_coeffs(self, dt):
        """The Suzuki-Yoshida weights times dt / iter, over every
        iteration (Kamberaj et al. 2005, Table 1; :243-262)."""
        if self.t_order == 3:
            w0 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
            w = [w0, 1.0 - 2.0 * w0, w0]
        else:
            w0 = 1.0 / (4.0 - 4.0 ** (1.0 / 3.0))
            w = [w0, w0, 1.0 - 4.0 * w0, w0, w0]
        return [wi * dt / self.t_iter for wi in w] * self.t_iter

    @staticmethod
    def _chain_sweep(eta, ed, f, q, kt, wdti1, half_exp):
        """One Suzuki-Yoshida sub-step of a Nose-Hoover chain on host
        floats: eta, ed and f the positions, velocities and forces, q the
        masses; the exponent's factor is 1/2 in the barostat's chain
        (:814-889), 1 in the thermostats'.  Returns (eta, ed, f)."""
        ed, f = list(ed), list(f)
        C = len(ed)
        wdti2, wdti4 = wdti1 / 2.0, wdti1 / 4.0
        ed[C - 1] = ed[C - 1] + wdti2 * f[C - 1]
        for k in range(1, C):
            tmp = wdti4 * ed[C - k]
            sf = math.exp(-half_exp * tmp)
            ed[C - k - 1] = (ed[C - k - 1] * sf * sf + wdti2 * f[C - k - 1]
                             * sf * maclaurin_series(tmp))
        eta = tuple(e + wdti1 * d for e, d in zip(eta, ed))
        for k in range(1, C):
            f[k] = (q[k - 1] * ed[k - 1] ** 2 - kt) / q[k]
        for k in range(C - 1):
            tmp = wdti4 * ed[k + 1]
            sf = math.exp(-half_exp * tmp)
            ed[k] = ed[k] * sf * sf + wdti2 * f[k] * sf * maclaurin_series(
                tmp)
            f[k + 1] = (q[k] * ed[k] ** 2 - kt) / q[k + 1]
        ed[C - 1] = ed[C - 1] + wdti2 * f[C - 1]
        return eta, tuple(ed), tuple(f)

    def _nhc_temp(self, fst, akin_t, akin_r, ctx):
        """nhc_temp_integrate (:721-812): both chains, every weight, from
        the bodies' kinetic energies as host floats."""
        mvv2e = ctx.units.mvv2e
        kt = ctx.units.boltz * self._t_target(fst)
        C = self.t_chain
        t_mass = kt / (self.t_freq * self.t_freq)
        q_t = [self.nf_t * t_mass] + [t_mass] * (C - 1)
        q_r = [self.nf_r * t_mass] + [t_mass] * (C - 1)
        et, er = fst.eta_t, fst.eta_r
        edt, edr = fst.eta_dot_t, fst.eta_dot_r
        ft = ((akin_t * mvv2e - self.nf_t * kt) / q_t[0],) + fst.f_eta_t[1:]
        fr = ((akin_r * mvv2e - self.nf_r * kt) / q_r[0],) + fst.f_eta_r[1:]
        for wdti1 in self._w_coeffs(ctx.dt):
            et, edt, ft = self._chain_sweep(et, edt, ft, q_t, kt, wdti1, 1.0)
            er, edr, fr = self._chain_sweep(er, edr, fr, q_r, kt, wdti1, 1.0)
        return fst.replace(eta_t=et, eta_r=er, eta_dot_t=edt, eta_dot_r=edr,
                           f_eta_t=ft, f_eta_r=fr)

    def setup_post_force(self, s, fstate, ctx, xin=None):
        """FixRigidNH::setup: conjqm refreshed from the projected angmom."""
        s, fst = super().setup_post_force(s, fstate, ctx, xin)
        return s, fst.replace(conjqm=self._conjqm(fst))

    def _scales(self, fst, dtq):
        """(scale_t, scale_r) of the half kicks."""
        return (math.exp(-dtq * fst.eta_dot_t[0]),
                math.exp(-dtq * fst.eta_dot_r[0]))

    def _rotate(self, fst, torque, dtf, dtq, dtv, scale_r):
        """Steps 1.3-1.13: the torque onto conjqm, then the no-squish
        3, 2, 1, 2, 3 rotor splitting; returns (conjqm, quat, rot, angmom,
        omega)."""
        rot = quat_to_mat(fst.quat)
        fquat = quatvec(fst.quat, _rt(rot, torque))
        conjqm = (fst.conjqm + 2.0 * dtf * fquat) * scale_r
        quat = fst.quat
        for k, dt_k in ((3, dtq), (2, dtq), (1, dtv), (2, dtq), (3, dtq)):
            conjqm, quat = no_squish_rotate(k, conjqm, quat, fst.inertia,
                                            dt_k)
        rot = quat_to_mat(quat)
        angmom = 0.5 * _r(rot, invquatvec(quat, conjqm))
        return conjqm, quat, rot, angmom, angmom_to_omega(angmom, rot,
                                                          fst.inertia)

    def _final_kick(self, s, fst, ctx, scale_t, scale_r):
        """The final half kick of vcm and conjqm; returns (fst, body,
        bidx, disp)."""
        body, bidx, disp = self._atom_body(s, fst)
        dtf = 0.5 * ctx.dt * ctx.units.ftm2v
        fcm, torque = self._fcm_torque(s, fst, body, bidx)
        vcm = fst.vcm * scale_t + (dtf / fst.masstotal)[:, None] * fcm
        rot = quat_to_mat(fst.quat)
        conjqm = scale_r * fst.conjqm + 2.0 * dtf * quatvec(
            fst.quat, _rt(rot, torque))
        angmom = 0.5 * _r(rot, invquatvec(fst.quat, conjqm))
        omega = angmom_to_omega(angmom, rot, fst.inertia)
        return (fst.replace(vcm=vcm, conjqm=conjqm, angmom=angmom,
                            omega=omega), body, bidx, disp)

    def initial_integrate(self, s, fstate, ctx):
        fst = fstate
        body, bidx, disp = self._atom_body(s, fst)
        dtv = ctx.dt
        dtf = 0.5 * ctx.dt * ctx.units.ftm2v
        dtq = 0.5 * ctx.dt
        fcm, torque = self._fcm_torque(s, fst, body, bidx)
        scale_t, scale_r = self._scales(fst, dtq)
        # steps 1.1-1.2: vcm's half kick and the thermostat; xcm's drift
        vcm = (fst.vcm + (dtf / fst.masstotal)[:, None] * fcm) * scale_t
        akin_t = torch.sum(fst.masstotal * torch.sum(vcm * vcm, dim=1))
        xcm = fst.xcm + dtv * vcm
        conjqm, quat, rot, angmom, omega = self._rotate(
            fst, torque, dtf, dtq, dtv, scale_r)
        akin_r = torch.sum(angmom * omega)
        fst = fst.replace(vcm=vcm, xcm=xcm, quat=quat, conjqm=conjqm,
                          angmom=angmom, omega=omega)
        # the step's one read: the bodies' kinetic energies, for the chains
        fst = self._nhc_temp(fst, *torch.stack([akin_t, akin_r]).tolist(),
                             ctx)
        return self._set_xv(s, fst, ctx, body, bidx, disp, rot)

    def final_integrate(self, s, fstate, ctx):
        scale_t, scale_r = self._scales(fstate, 0.5 * ctx.dt)
        fst, body, bidx, disp = self._final_kick(s, fstate, ctx, scale_t,
                                                 scale_r)
        s, vhalf = self._set_v(s, fst, ctx, body, bidx, disp)
        return s, fst.replace(virial=fst.virial + vhalf)


class FixRigidNPT(FixRigidNVT):
    """fix ID group rigid/npt[/small] <bodystyle> temp T1 T2 Tdamp
    iso|aniso|x|y|z P1 P2 Pdamp [tparam ...] [pchain N] [dilate all]:
    FixRigidNH with a thermostat and a barostat (fix_rigid_npt.cpp;
    fix_rigid_nh.cpp:428-717 the integration, :814-889
    nhc_press_integrate, :977-1031 remap, :1067-1095 nh_epsilon_dot)."""

    name = "rigid/npt"
    needs_virial = True

    def __init__(self, style="molecule", group_bits=(), t_start=None,
                 t_stop=None, t_period=None, t_chain=10, t_iter=1,
                 t_order=3, p_start=None, p_stop=None, p_period=None,
                 p_flag=(True, True, True), pstyle="iso", p_chain=10,
                 tstat=True):
        super().__init__(style=style, group_bits=group_bits,
                         t_start=t_start if tstat else 0.0,
                         t_stop=t_stop if tstat else 0.0,
                         t_period=t_period if tstat else 1.0,
                         t_chain=t_chain, t_iter=t_iter, t_order=t_order)
        if p_start is None:
            raise ValueError(f"fix {self.name} needs a pressure keyword")
        self.tstat = bool(tstat)
        self.box_change = True
        self.p_start = np.asarray(p_start, np.float64)
        self.p_stop = np.asarray(p_stop, np.float64)
        period = np.asarray(p_period, np.float64)
        self.p_freq = np.where(period > 0, 1.0 / np.maximum(period, 1e-300),
                               0.0)
        self.p_flag = tuple(bool(f) for f in p_flag)
        self.pdim = sum(self.p_flag)
        self.p_freq_max = float(self.p_freq[list(self.p_flag)].max()
                                if self.pdim else 0.0)
        self.pstyle = pstyle          # iso: the mean pressure
        self.p_chain = int(p_chain)
        self.t0 = None                # nph's target, set at set-up
        self._dev = {}

    def _consts(self, like):
        """(flags (3,) bool, p_freq^2 or 1 (3,)) on like's device."""
        key = (like.dtype, like.device)
        if key not in self._dev:
            self._dev[key] = (
                torch.tensor(self.p_flag, device=like.device),
                torch.as_tensor(self.p_freq ** 2 + (self.p_freq == 0),
                                dtype=like.dtype, device=like.device))
        return self._dev[key]

    def init_state(self, s, ctx):
        fst = super().init_state(s, ctx)
        dt_, dev = s.x.dtype, s.x.device
        self.g_f = self.nf_t + self.nf_r
        vol0 = float(s.box.volume)
        zb = (0.0,) * self.p_chain
        zero = torch.zeros((), dtype=dt_, device=dev)
        return fst.replace(
            epsilon=torch.as_tensor(np.where(self.p_flag, np.log(vol0) / 3.0,
                                             0.0), dtype=dt_, device=dev),
            epsilon_dot=torch.zeros(3, dtype=dt_, device=dev),
            eta_b=zb, eta_dot_b=zb, f_eta_b=zb, mtk_term2=zero,
            akin_t=zero, akin_r=zero,
            virial_save=torch.zeros(6, dtype=dt_, device=dev))

    def save_virial(self, fstate, virial):
        return fstate.replace(virial_save=virial)

    def _kt(self, fst, ctx) -> float:
        t = self._t_target(fst) if self.tstat else (self.t0 or 1.0)
        return ctx.units.boltz * t

    def _p_current(self, s, ctx, virial):
        """compute_pressure's diagonal, (mvv + virial) / V; iso couples it to
        its mean (couple(), :946-975)."""
        m = ctx.mass_per_atom(s)
        mvv = ctx.units.mvv2e * torch.sum(m[:, None] * s.v * s.v, dim=0)
        p = (mvv + virial[:3]) / s.box.volume * ctx.units.nktv2p
        if self.pstyle == "iso":
            p = (torch.sum(p) / 3.0).expand(3)
        return p

    def _p_hydro(self, fst) -> float:
        p_t = _ramp(self.p_start, self.p_stop, fst)
        return float(np.sum(np.where(self.p_flag, p_t, 0.0))) / max(
            self.pdim, 1)

    def _nh_epsilon_dot(self, s, fst, ctx, p_current):
        """nh_epsilon_dot (:1067): the barostat velocity, MTK terms
        included."""
        u = ctx.units
        dtq = 0.5 * ctx.dt
        kt = self._kt(fst, ctx)
        flag, freq2 = self._consts(s.x)
        mtk1 = (fst.akin_t + fst.akin_r) * u.mvv2e / self.g_f
        scale = math.exp(-dtq * fst.eta_dot_b[0])
        eps_mass = (self.g_f + 3) * kt / freq2
        f_eps = ((p_current - self._p_hydro(fst)) * s.box.volume / u.nktv2p
                 + mtk1) / eps_mass
        eps_dot = torch.where(flag, (fst.epsilon_dot + dtq * f_eps) * scale,
                              fst.epsilon_dot)
        mtk2 = torch.sum(torch.where(flag, eps_dot, 0.0)) / self.g_f
        return fst.replace(epsilon_dot=eps_dot, mtk_term2=mtk2)

    def _nhc_press(self, fst, ctx, eps_dot):
        """nhc_press_integrate (:814-889), its exponent halved, on the
        host from the barostat velocities eps_dot (3 floats)."""
        kt = self._kt(fst, ctx)
        C = self.p_chain
        tb_mass = kt / (self.p_freq_max * self.p_freq_max)
        q_b = [9.0 * tb_mass] + [tb_mass] * (C - 1)
        edb, fb = fst.eta_dot_b, list(fst.f_eta_b)
        for k in range(1, C):
            fb[k] = (q_b[k - 1] * edb[k - 1] ** 2 - kt) / q_b[k]
        freq2 = self.p_freq ** 2 + (self.p_freq == 0)
        kecur = sum((self.g_f + 3) * kt / float(freq2[i]) * eps_dot[i] ** 2
                    for i in range(3) if self.p_flag[i]) / self.pdim
        fb[0] = (kecur - kt) / q_b[0]
        eb = fst.eta_b
        for wdti1 in self._w_coeffs(ctx.dt):
            eb, edb, fb = self._chain_sweep(eb, edb, fb, q_b, kt, wdti1, 0.5)
        return fst.replace(eta_b=eb, eta_dot_b=edb, f_eta_b=fb)

    def _remap(self, s, fst, ctx):
        """remap (:977): the box, the atoms and the centres of mass dilated
        by exp(dtq epsilon_dot) about the box centre."""
        dtq = 0.5 * ctx.dt
        flag, _ = self._consts(s.x)
        expfac = torch.where(flag, torch.exp(dtq * fst.epsilon_dot), 1.0)
        box = s.box
        ctr = 0.5 * (box.lo + box.hi)
        x = torch.where((s.tag > 0)[:, None], (s.x - ctr) * expfac + ctr,
                        s.x)
        s = s.replace(x=x, box=box.replace(lo=(box.lo - ctr) * expfac + ctr,
                                           hi=(box.hi - ctr) * expfac + ctr))
        return s, fst.replace(xcm=(fst.xcm - ctr) * expfac + ctr,
                              epsilon=fst.epsilon + dtq * fst.epsilon_dot)

    def setup_with_state_virial(self, s, fst, ctx):
        """FixRigidNH::setup's tail (:346-424): akin from the bodies'
        motion, t0 for nph, then nh_epsilon_dot with the set-up's
        pressure."""
        if not self.tstat and self.t0 is None:
            m = ctx.mass_per_atom(s)
            mvv = ctx.units.mvv2e * float(torch.sum(m[:, None] * s.v * s.v))
            t0 = mvv / (max(ctx.tdof, 1.0) * ctx.units.boltz)
            self.t0 = t0 if t0 != 0.0 else (1.0 if ctx.units.name == "lj"
                                             else 300.0)
        fst = fst.replace(
            akin_t=torch.sum(fst.masstotal * torch.sum(fst.vcm ** 2, dim=1)),
            akin_r=torch.sum(fst.angmom * fst.omega))
        return self._nh_epsilon_dot(
            s, fst, ctx, self._p_current(s, ctx, fst.virial_save))

    def _scales(self, fst, dtq):
        flag, _ = self._consts(fst.epsilon_dot)
        eps = torch.where(flag, fst.epsilon_dot, 0.0)
        scale_t = torch.exp(-dtq * (eps + fst.mtk_term2))
        scale_r = torch.exp(-dtq * (self.pdim * fst.mtk_term2))
        if self.tstat:
            t, r = super()._scales(fst, dtq)
            scale_t, scale_r = scale_t * t, scale_r * r
        return scale_t, scale_r

    def initial_integrate(self, s, fstate, ctx):
        fst = fstate
        body, bidx, disp = self._atom_body(s, fst)
        dtv = ctx.dt
        dtf = 0.5 * ctx.dt * ctx.units.ftm2v
        dtq = 0.5 * ctx.dt
        fcm, torque = self._fcm_torque(s, fst, body, bidx)
        scale_t, scale_r = self._scales(fst, dtq)
        flag, _ = self._consts(s.x)
        tmp = dtq * torch.where(flag, fst.epsilon_dot, 0.0)
        scale_v = dtv * torch.exp(tmp) * maclaurin_series(tmp)
        vcm = (fst.vcm + (dtf / fst.masstotal)[:, None] * fcm) * scale_t
        akin_t = torch.sum(fst.masstotal * torch.sum(vcm * vcm, dim=1))
        xcm = fst.xcm + scale_v * vcm
        conjqm, quat, rot, angmom, omega = self._rotate(
            fst, torque, dtf, dtq, dtv, scale_r)
        akin_r = torch.sum(angmom * omega)
        fst = fst.replace(vcm=vcm, xcm=xcm, quat=quat, conjqm=conjqm,
                          angmom=angmom, omega=omega, akin_t=akin_t,
                          akin_r=akin_r)
        # the step's one read: the bodies' kinetic energies and the barostat
        # velocities, for the chains
        at, ar, *eps = torch.cat([torch.stack([akin_t, akin_r]),
                                  fst.epsilon_dot]).tolist()
        if self.tstat:
            fst = self._nhc_temp(fst, at, ar, ctx)
        fst = self._nhc_press(fst, ctx, eps)
        # the box in two half-step dilations around set_xv
        s, fst = self._remap(s, fst, ctx)
        s, fst = self._set_xv(s, fst, ctx, body, bidx, disp, rot)
        return self._remap(s, fst, ctx)

    def final_integrate(self, s, fstate, ctx):
        scale_t, scale_r = self._scales(fstate, 0.5 * ctx.dt)
        fst, body, bidx, disp = self._final_kick(s, fstate, ctx, scale_t,
                                                 scale_r)
        fst = fst.replace(
            akin_t=torch.sum(fst.masstotal * torch.sum(fst.vcm * fst.vcm,
                                                       dim=1)),
            akin_r=torch.sum(fst.angmom * fst.omega))
        s, vhalf = self._set_v(s, fst, ctx, body, bidx, disp)
        fst = fst.replace(virial=fst.virial + vhalf)
        # the barostat velocity at the step's end: the pressure of the
        # step's whole tally (pair, bonded, kspace, both constraint halves)
        return s, self._nh_epsilon_dot(
            s, fst, ctx, self._p_current(s, ctx, fst.virial_save + vhalf))


class FixRigidNPH(FixRigidNPT):
    """fix rigid/nph[/small]: the barostat without a thermostat; the
    target temperature is the set-up's t0."""

    name = "rigid/nph"

    def __init__(self, style="molecule", group_bits=(), **kw):
        kw.pop("tstat", None)
        super().__init__(style=style, group_bits=group_bits, tstat=False,
                         **kw)

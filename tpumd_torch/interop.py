"""State bridge: build the port's objects from another engine's arrays.

Takes plain numpy arrays (for example the fields of a tpumd ``MDState``,
``PairLJCut``, ``PairEAM``, ``PairLJCharmmCoulLong``, ``PPPM`` and
``PairGranHookeHistory``, and a ``NeighborConfig`` and ``NeighborState``
of the matrix engine, and a fix's per-atom state), so one state, one
potential and one neighbor list can be fed to both engines. This module
imports nothing of tpumd.
"""

from __future__ import annotations

import numpy as np
import torch

from tpumd_torch.core.state import Box, MDState
from tpumd_torch.models.kspace_pppm import PPPM
from tpumd_torch.models.pair_charmm import PairLJCharmmCoulLong
from tpumd_torch.models.pair_eam import PairEAM
from tpumd_torch.models.pair_gran import PairGranHookeHistory
from tpumd_torch.models.pair_lj_cut import PairLJCut
from tpumd_torch.ops.neighbor import NeighborConfig, NeighborState
from tpumd_torch.utils.units import get_units


def state_from_numpy(arrays, box, *, device, dtype) -> MDState:
    """MDState from {x, v, f, type, tag, image} arrays, and where given q,
    molecule, special_tags, special_codes, gmask and the sphere fields
    radius, rmass, omega and torque, and a box mapping {lo, hi, periodic,
    tilt} (periodic on every axis and orthogonal when not given); rows keep
    their order (padding included)."""
    def floats(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)

    def ints(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    def opt(name, conv):
        a = arrays.get(name)
        return None if a is None else conv(a)

    return MDState(
        x=floats(arrays["x"]), v=floats(arrays["v"]), f=floats(arrays["f"]),
        type=ints(arrays["type"]), tag=ints(arrays["tag"]),
        image=ints(arrays["image"]),
        box=box_from_numpy(box, device=device, dtype=dtype),
        q=opt("q", floats), molecule=opt("molecule", ints),
        special_tags=opt("special_tags", ints),
        special_codes=opt("special_codes", ints),
        gmask=opt("gmask", ints), radius=opt("radius", floats),
        rmass=opt("rmass", floats), omega=opt("omega", floats),
        torque=opt("torque", floats))


def box_from_numpy(box, *, device, dtype) -> Box:
    """Box from a mapping {lo, hi} and, where given, periodic and tilt
    (xy, xz, yz; a triclinic box, even when all zero)."""
    tilt = box.get("tilt")
    return Box(lo=torch.as_tensor(np.asarray(box["lo"], np.float64),
                                  dtype=dtype, device=device),
               hi=torch.as_tensor(np.asarray(box["hi"], np.float64),
                                  dtype=dtype, device=device),
               periodic=tuple(bool(p) for p in box.get(
                   "periodic", (True, True, True))),
               tilt=None if tilt is None else torch.as_tensor(
                   np.asarray(tilt, np.float64), dtype=dtype, device=device))


def neighbor_config_from_numpy(fields) -> NeighborConfig:
    """NeighborConfig from a mapping of its fields (for example
    ``dataclasses.asdict`` of tpumd's ``NeighborConfig``)."""
    fields = dict(fields)
    fields["exclude_bits"] = tuple(tuple(int(b) for b in p)
                                   for p in fields.get("exclude_bits", ()))
    fields["image_shifts"] = tuple(tuple(int(k) for k in sv)
                                   for sv in fields.get("image_shifts", ()))
    return NeighborConfig(**fields)


def neighbor_state_from_numpy(idx, sbits, xhold, *, shear=None, nbuilds=1,
                              overflow=False, max_count=0, device,
                              dtype) -> NeighborState:
    """NeighborState holding the given list (idx, sbits (N, K) int32), the
    positions at its build and, for a granular style, its (N, K, 3)
    history (for example the fields of tpumd's ``NeighborState``)."""
    def ints(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    def floats(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)
    return NeighborState(
        idx=ints(idx), sbits=ints(sbits), xhold=floats(xhold), ago=0,
        nbuilds=int(nbuilds),
        overflow=torch.tensor(bool(overflow), device=device),
        max_count=torch.tensor(int(max_count), device=device),
        shear=None if shear is None else floats(shear))


def pair_from_numpy(epsilon, sigma, cut, *, shift=False,
                    mix="geometric") -> PairLJCut:
    """PairLJCut with the given (ntypes+1)^2 tables, every pair set."""
    epsilon = np.array(epsilon, np.float64)
    pair = PairLJCut(epsilon.shape[0] - 1)
    pair.epsilon = epsilon
    pair.sigma = np.array(sigma, np.float64)
    pair.cut = np.array(cut, np.float64)
    pair.cut_global = float(pair.cut[1:, 1:].max())
    pair.shift = bool(shift)
    pair.mix = mix
    pair._setflag[1:, 1:] = True
    pair.init()
    return pair


def eam_from_numpy(frho_spline, rhor_spline, z2r_spline, dr, drho, nr, nrho,
                   rhomax, cutmax) -> PairEAM:
    """A one-type PairEAM holding the given spline tables (for example
    tpumd's ``PairEAM`` fields), ready for ``compute_cellgrid``: tables of
    shape (k, n+1, 7), the first of each serving the one element.  It
    has no potential file, so ``init`` must not be called on it."""
    pair = PairEAM(1)
    pair.frho_spline, pair.rhor_spline, pair.z2r_spline = (
        np.array(a, np.float64) for a in (frho_spline, rhor_spline,
                                          z2r_spline))
    pair.type2frho = np.zeros(2, np.int32)
    pair.type2rhor = np.zeros((2, 2), np.int32)
    pair.type2z2r = np.zeros((2, 2), np.int32)
    pair.dr, pair.drho = float(dr), float(drho)
    pair.nr, pair.nrho = int(nr), int(nrho)
    pair.rhomax, pair.cutmax = float(rhomax), float(cutmax)
    pair.cutforcesq = pair.cutmax * pair.cutmax
    pair._setflag[1, 1] = True
    return pair


def charmm_from_numpy(epsilon, sigma, eps14, sigma14, cut_lj_inner, cut_lj,
                      cut_coul, g_ewald, units) -> PairLJCharmmCoulLong:
    """PairLJCharmmCoulLong with the given (ntypes+1)^2 tables (every pair
    set, so nothing is mixed), its cutoffs, the kspace solver's g_ewald and
    the unit style's name; init has run."""
    epsilon = np.array(epsilon, np.float64)
    pair = PairLJCharmmCoulLong(epsilon.shape[0] - 1)
    pair.units = get_units(units)
    pair.settings(cut_lj_inner, cut_lj, cut_coul)
    pair.epsilon = epsilon
    pair.sigma = np.array(sigma, np.float64)
    pair.eps14 = np.array(eps14, np.float64)
    pair.sigma14 = np.array(sigma14, np.float64)
    pair._setflag[1:, 1:] = True
    pair.init()
    pair.g_ewald = float(g_ewald)
    return pair


def pppm_from_numpy(natoms, q, prd, cutoff, accuracy_relative, nxyz,
                    g_ewald, units, dynamic_box=False) -> PPPM:
    """PPPM on the given host charges and box lengths whose mesh and
    g_ewald are those carried from another engine (for example tpumd's
    ``PPPM.nx, ny, nz, g_ewald``); the coefficients are built on them."""
    ks = PPPM(accuracy_relative)
    ks.init(int(natoms), np.asarray(q, np.float64), prd, get_units(units),
            cutoff, dynamic_box=dynamic_box)
    ks.nx, ks.ny, ks.nz = (int(v) for v in nxyz)
    ks.g_ewald = float(g_ewald)
    ks._setup_coeffs()
    ks._dev = {}
    return ks


def gran_from_numpy(kn, kt, gamman, gammat, xmu, *, limit_damping=False,
                    freeze_bit=0, exclude_bits=(),
                    max_radius=0.5) -> PairGranHookeHistory:
    """PairGranHookeHistory with the given settings as resolved numbers
    (for example tpumd's ``PairGranHookeHistory`` fields: kt and gammat
    after NULL and dampflag), the frozen group's gmask bit, the excluded
    group-bit pairs and the largest radius."""
    pair = PairGranHookeHistory(1)
    pair.kn, pair.kt, pair.gamman, pair.gammat, pair.xmu = (
        float(v) for v in (kn, kt, gamman, gammat, xmu))
    pair.limit_damping = bool(limit_damping)
    pair.freeze_group_bit = int(freeze_bit)
    pair.exclude_bits = tuple(tuple(int(b) for b in p) for p in exclude_bits)
    pair.set_max_radius(max_radius)
    return pair


def with_fix_peratom(s: MDState, fix, values) -> MDState:
    """s with the per-atom state of the port's fix (fix move's x0,
    spring/self's anchors: ``fix.history_key`` in ``MDState.peratom``)
    taken from another engine's (N, 3) array in s's row order, for
    example tpumd's ``FixMove`` state ``x0`` or ``FixSpringSelf`` state,
    so that both engines carry one state on."""
    table = dict(s.peratom or {})
    table[fix.history_key] = torch.as_tensor(
        np.asarray(values, np.float64), dtype=s.x.dtype, device=s.x.device)
    return s.replace(peratom=table)

"""Global thermodynamic computes (src/compute_temp.cpp,
src/compute_pressure.cpp, src/thermo.cpp; tpumd/md/computes.py)."""

from __future__ import annotations

import torch


def temperature(v, mass_per_atom, dof, boltz, mvv2e):
    """Instantaneous temperature; dof already includes -extra_dof -fix_dof."""
    ke2 = torch.sum(mass_per_atom[:, None] * v * v)
    tfactor = mvv2e / (dof * boltz)
    return ke2 * tfactor


def kinetic_energy(t_scalar, dof, boltz):
    """Thermo 'ke' = 0.5 * dof * boltz * T (src/thermo.cpp compute_ke)."""
    return 0.5 * dof * boltz * t_scalar


def pressure(t_scalar, vir3, volume, dof, boltz, nktv2p, ptail=0.0,
             dimension=3):
    """Scalar pressure = (dof kB T + tr(W) + ptail) / (dim V) * nktv2p,
    from the temperature (the kinetic tensor's trace) and the trace of the
    total virial (ComputePressure::compute_scalar)."""
    return (dof * boltz * t_scalar + vir3 + ptail) / (dimension * volume) \
        * nktv2p


def pressure_vector(mvv, virial, volume, nktv2p):
    """(3,) diagonal pressure: the kinetic tensor's diagonal mvv plus the
    virial's, over the volume (ComputePressure::compute_vector)."""
    return (mvv + virial[:3]) / volume * nktv2p


class ComputeERotateSphere:
    """compute erotate/sphere: the rotational kinetic energy of the
    group's spheres, 1/2 * 2/5 m r^2 |omega|^2 * mvv2e summed
    (src/compute_erotate_sphere.cpp:44-72, tpumd/md/compute_styles.py:
    126-140), on the device: empty slots have rmass 0 and add nothing.
    Extensive, so ``thermo_modify norm yes`` divides it by the atom count
    (extscalar = 1 in the reference)."""

    extensive = True

    def __init__(self, cid: str, groupbit: int):
        self.id = cid
        self.groupbit = groupbit

    def value(self, s, mvv2e: float):
        if s.omega is None:
            raise ValueError("compute erotate/sphere needs atom_style sphere")
        w2 = torch.sum(s.omega * s.omega, dim=1)
        e = w2 * s.radius * s.radius * s.rmass
        if self.groupbit != 1:
            e = torch.where((s.gmask & self.groupbit) > 0, e, 0.0)
        return 0.5 * mvv2e * 0.4 * torch.sum(e)

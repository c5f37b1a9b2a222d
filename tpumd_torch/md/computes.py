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

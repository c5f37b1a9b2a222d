"""Global thermodynamic computes (src/compute_temp.cpp, src/thermo.cpp;
tpumd/md/computes.py)."""

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

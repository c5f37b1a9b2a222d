"""fix external: forces that a calling program supplies
(src/fix_external.cpp; tpumd/md/fix_external.py).

A per-atom force array ``fexternal`` owned by the calling program is added
to f in post_force.  Two modes:

- ``pf/array Napply``: the calling program writes the force buffer between runs
  (``host_force_buffer``, lammps_fix_external_get_force); it is pushed to
  the device at each run's start (``host_run_start``) and applies on steps
  where ntimestep % Napply == 0.
- ``pf/callback Ncall Napply``: a host callback fires during the step,
  after the force evaluation and before post_force and the final
  integration, on steps where ntimestep % Ncall == 0 (src/fix_external.cpp:
  141-176), and at a run's set-up where its step is one of those; the run
  splits those steps around it (``Simulation._advance``, at the port's
  step_pre / step_post boundary).  A segment redone after a neighbour
  overflow calls the callback again for its steps.

Row order: the port keeps fix external on either engine.  The calling
program sees the atoms in TAG order: the callback gets x and ids (ids =
1..N) of the atoms sorted by tag and fills fexternal in that order, and the
pf/array buffer is indexed by tag - 1; the fix keeps the forces by tag on
the device and gathers them onto the rows (grid slots, which a re-bin
permutes) at each post_force.  tpumd instead forces the matrix engine,
whose rows stay put, and hands the caller its rows.  A callback is one host
read of x and one write of fexternal by design (``reads`` counts them); the
fix reads the host nowhere else.

The calling program may also set a global energy and virial (the energy is
the fix's scalar, the virial joins the pressure on apply steps), per-atom
tallies and a global vector (lammps_fix_external_set_*).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpumd_torch.core.state import tag_rows
from tpumd_torch.md.fixes import Fix


class FixExternal(Fix):
    name = "external"
    needs_step = True
    contributes_virial = True

    def __init__(self, mode: str, ncall: int = 1, napply: int = 1):
        if mode not in ("pf/callback", "pf/array"):
            raise ValueError(f"fix external: unknown mode {mode!r}")
        self.mode = mode
        self.ncall = int(ncall)
        self.napply = int(napply)
        if self.ncall <= 0 or self.napply <= 0:
            raise ValueError("Illegal fix external command")
        self.callback = None        # callable(step, x, ids, fext)
        self.energy_global = 0.0
        self.virial_global = np.zeros(6)
        self._fext_host = None      # the pf/array buffer, (N, 3) by tag
        self.energy_peratom = None   # (N,) by tag
        self.virial_peratom = None   # (N, 6) by tag
        self._vector = None          # global vector for extract_fix
        self.reads = 0               # host reads of x (callbacks)
        self.callback_s = 0.0        # host seconds in callbacks

    @classmethod
    def parse(cls, args):
        """pf/callback Ncall Napply | pf/array Napply."""
        if args[:1] == ["pf/callback"] and len(args) == 3:
            return cls("pf/callback", int(args[1]), int(args[2]))
        if args[:1] == ["pf/array"] and len(args) == 2:
            return cls("pf/array", napply=int(args[1]))
        raise ValueError(f"Illegal fix external command: {' '.join(args)}")

    # ------------------------------------------------------------ state
    def init_state(self, s, ctx):
        """(timestep, fexternal by tag, the caller's virial)."""
        return (0, torch.zeros((ctx.natoms, 3), dtype=s.x.dtype,
                               device=s.x.device),
                torch.zeros(6, dtype=s.x.dtype, device=s.x.device))

    def set_step(self, fstate, istep):
        return (istep,) + tuple(fstate[1:])

    def _on_rows(self, s, fext):
        """fexternal gathered onto the state's rows, zero off the group."""
        add = fext[(s.tag.long() - 1).clamp(min=0)]
        return torch.where(self.group_sel(s)[:, None] & (s.tag > 0)[:, None],
                           add, 0)

    def post_force(self, s, fstate, ctx, xin=None):
        step, fext, _ = fstate
        if step % self.napply:
            return s, fstate
        return s.replace(f=s.f + self._on_rows(s, fext)), fstate

    def virial_contrib(self, fstate):
        step, _, vir = fstate
        return vir if step % self.napply == 0 else torch.zeros_like(vir)

    # ------------------------------------------------------ host side
    def host_force_buffer(self, sim):
        """The caller's pf/array buffer, (N, 3) f64 by tag - 1; pushed to
        the device at the next run's start."""
        if self._fext_host is None or self._fext_host.shape[0] != sim.natoms:
            self._fext_host = np.zeros((sim.natoms, 3))
        return self._fext_host

    def _push(self, sim, carry, fext_new, patch_force: bool):
        """carry with a new fill (and the caller's virial) in the fix state;
        where ``patch_force`` (a run's set-up), the carried force swaps the
        old fill for the new on an apply step, since no post_force runs
        before the next half-kick (the reference re-runs post_force in
        Verlet::setup, src/fix_external.cpp:110-113)."""
        s, neigh, fstates = carry
        i = list(sim._ctx.fixes).index(self)
        fstates = list(fstates)
        step, fext_old, _ = fstates[i]
        fext_new = torch.as_tensor(fext_new, dtype=s.x.dtype,
                                   device=s.x.device)
        vir = torch.as_tensor(self.virial_global, dtype=s.x.dtype,
                              device=s.x.device)
        fstates[i] = (step, fext_new, vir)
        if patch_force and sim.step % self.napply == 0:
            s = s.replace(f=s.f + self._on_rows(s, fext_new - fext_old))
        return s, neigh, tuple(fstates)

    def host_run_start(self, sim):
        """At a run's start: push the pf/array buffer and the virial, or
        fire the callback at the set-up step."""
        if self.mode == "pf/array":
            if self._fext_host is None and not np.any(self.virial_global):
                return
            i = list(sim._ctx.fixes).index(self)
            fext = (self._fext_host if self._fext_host is not None
                    else sim._carry[2][i][1])
            sim._carry = self._push(sim, sim._carry, fext, True)
        elif self.callback is not None and sim.step % self.ncall == 0:
            sim._carry = self.invoke_callback(sim, sim._carry, sim.step,
                                              at_setup=True)
        sim.state = sim._carry[0]

    def mid_step_due(self, istep: int) -> bool:
        """Whether the callback fires inside the step to istep."""
        return (self.mode == "pf/callback" and self.callback is not None
                and istep % self.ncall == 0)

    def invoke_callback(self, sim, carry, timestep: int,
                        at_setup: bool = False):
        """The callback on carry's positions (one host read, in tag order);
        returns carry with its fill stored for this step's post_force."""
        s = carry[0]
        x = s.x[tag_rows(s.tag, sim.natoms)].double().cpu().numpy()
        self.reads += 1
        t0 = time.perf_counter()
        ids = np.arange(1, x.shape[0] + 1, dtype=np.int32)
        fext = np.zeros_like(x)
        self.callback(int(timestep), x, ids, fext)
        self.callback_s += time.perf_counter() - t0
        return self._push(sim, carry, fext, at_setup)

    def scalar(self, sim):
        """The caller's global energy (compute_scalar)."""
        return self.energy_global

    def set_vector_length(self, n: int):
        """The length of the caller's global vector, before any
        set_vector (lammps_fix_external_set_vector_length)."""
        self._vector = np.zeros(int(n))

    def set_vector(self, idx: int, val: float):
        """1-based element store (lammps_fix_external_set_vector)."""
        if self._vector is None:
            raise ValueError("fix external: set_vector before "
                             "set_vector_length")
        if not 1 <= idx <= self._vector.shape[0]:
            raise IndexError(f"fix external vector index {idx} out of "
                             f"range 1..{self._vector.shape[0]}")
        self._vector[idx - 1] = float(val)

    @property
    def vector(self):
        return self._vector

"""Wall fixes: wall/lj93, wall/lj126, wall/harmonic (post_force) and
wall/reflect (post_integrate).

The port of tpumd/md/fix_wall.py (src/fix_wall.cpp: the wall specs and
EDGE coordinates; fix_wall_lj93.cpp, fix_wall_lj126.cpp,
fix_wall_harmonic.cpp, fix_wall_reflect.cpp).  Each wall is a face
(dim, side) and a coordinate: a number or EDGE, the box face.  side -1 is
a lo wall (the atoms above it), +1 a hi wall; the wall pushes the atoms
within its cutoff away.  The walls' energy is the fix's output
(``f_ID`` in thermo), as tpumd has it; it is not added to the potential
energy.
"""

from __future__ import annotations

import torch

from tpumd_torch.md.fixes import Fix

FACES = {"xlo": (0, -1), "xhi": (0, 1), "ylo": (1, -1), "yhi": (1, 1),
         "zlo": (2, -1), "zhi": (2, 1)}


def _coord(s, face, spec):
    """The wall's coordinate: EDGE is the box face, else the number."""
    dim, side = FACES[face]
    if spec == "EDGE":
        return s.box.lo[dim] if side < 0 else s.box.hi[dim]
    return float(spec)


class _FixWall(Fix):
    def __init__(self, walls):
        """walls: [(face, coord or EDGE, eps, sigma, cutoff), ...]."""
        self.walls = walls

    def wall_fe(self, delta, eps, sigma, cutoff):
        """(the force's magnitude, energy) at distance delta in (0, cutoff)."""
        raise NotImplementedError

    def _each_wall(self, s):
        """(dim, side, the atoms within the cutoff, delta there (1
        elsewhere), eps, sigma, cutoff) of each wall."""
        sel = self.group_sel(s)
        for face, spec, eps, sigma, cutoff in self.walls:
            dim, side = FACES[face]
            coord = _coord(s, face, spec)
            delta = (s.x[:, dim] - coord if side < 0
                     else coord - s.x[:, dim])
            act = sel & (delta < cutoff) & (delta > 0)
            yield (dim, side, act, torch.where(act, delta, 1.0), eps, sigma,
                   cutoff)

    def post_force(self, s, fstate, ctx, xin=None):
        f = s.f.clone()
        for dim, side, act, delta, eps, sigma, cutoff in self._each_wall(s):
            fw, _ = self.wall_fe(delta, eps, sigma, cutoff)
            f[:, dim] -= torch.where(act, side * fw, 0.0)
        return s.replace(f=f), fstate

    def energy(self, s):
        """The walls' total energy."""
        e = torch.zeros((), dtype=s.x.dtype, device=s.x.device)
        for _, _, act, delta, eps, sigma, cutoff in self._each_wall(s):
            _, ew = self.wall_fe(delta, eps, sigma, cutoff)
            e = e + torch.sum(torch.where(act, ew, 0.0))
        return e

    def output(self, sim):
        return float(self.energy(sim._carry[0]))


class FixWallLJ93(_FixWall):
    """E = eps (2/15 (s/r)^9 - (s/r)^3) - offset (fix_wall_lj93.cpp)."""

    name = "wall/lj93"

    def wall_fe(self, delta, eps, sigma, cutoff):
        c1 = 6.0 / 5.0 * eps * sigma**9
        c2 = 3.0 * eps * sigma**3
        c3 = 2.0 / 15.0 * eps * sigma**9
        c4 = eps * sigma**3
        ci = 1.0 / cutoff
        offset = c3 * ci**9 - c4 * ci**3
        rinv = 1.0 / delta
        r2 = rinv * rinv
        r4 = r2 * r2
        fw = c1 * r4 * r4 * r2 - c2 * r4
        ew = c3 * r4 * r4 * rinv - c4 * r2 * rinv - offset
        return fw, ew


class FixWallLJ126(_FixWall):
    """The full 12-6 LJ wall (fix_wall_lj126.cpp)."""

    name = "wall/lj126"

    def wall_fe(self, delta, eps, sigma, cutoff):
        c1 = 48.0 * eps * sigma**12
        c2 = 24.0 * eps * sigma**6
        c3 = 4.0 * eps * sigma**12
        c4 = 4.0 * eps * sigma**6
        ci = 1.0 / cutoff
        offset = c3 * ci**12 - c4 * ci**6
        rinv = 1.0 / delta
        r2 = rinv * rinv
        r6 = r2 * r2 * r2
        fw = (c1 * r6 * r6 - c2 * r6) * rinv
        ew = c3 * r6 * r6 - c4 * r6 - offset
        return fw, ew


class FixWallHarmonic(_FixWall):
    """E = eps (cutoff - r)^2 inside the cutoff (fix_wall_harmonic.cpp)."""

    name = "wall/harmonic"

    def wall_fe(self, delta, eps, sigma, cutoff):
        dr = cutoff - delta
        return 2.0 * eps * dr, eps * dr * dr


class FixWallReflect(Fix):
    """Atoms past a wall are reflected back: x -> 2 coord - x and v[dim]
    -> -v[dim] (fix_wall_reflect.cpp post_integrate)."""

    name = "wall/reflect"

    def __init__(self, walls):
        self.walls = walls  # [(face, coord or EDGE), ...]

    def post_integrate(self, s, fstate, ctx):
        x, v = s.x.clone(), s.v.clone()
        sel = self.group_sel(s)
        for face, spec in self.walls:
            dim, side = FACES[face]
            coord = _coord(s, face, spec)
            past = sel & ((x[:, dim] < coord) if side < 0
                          else (x[:, dim] > coord))
            x[:, dim] = torch.where(past, 2 * coord - x[:, dim], x[:, dim])
            v[:, dim] = torch.where(past, -v[:, dim], v[:, dim])
        return s.replace(x=x, v=v), fstate


def parse_walls(style, args, spacing=None):
    """The walls of ``fix ID group wall/STYLE face args ... [units
    box|lattice]`` (FixWall::FixWall, src/fix_wall.cpp): face coord eps
    sigma cutoff for lj93, lj126 and harmonic, face coord for reflect; a
    coordinate is EDGE or a number, in lattice spacings (spacing, the
    lattice's, when one exists) unless units box.  tpumd takes a number as
    it is in both cases."""
    per = 1 if style == "wall/reflect" else 4
    units = "lattice"
    walls, i = [], 0
    while i < len(args):
        key = args[i]
        if key in FACES:
            vals = args[i + 1:i + 1 + per]
            if len(vals) < per:
                raise ValueError(f"fix {style} {key}: {per} values")
            if vals[0] != "EDGE":
                try:
                    float(vals[0])
                except ValueError:
                    raise NotImplementedError(
                        f"fix {style} {key} {vals[0]}: a wall position from "
                        "a variable is not ported (a number or EDGE)") \
                        from None
            walls.append([key, vals[0], *map(float, vals[1:])])
            i += 1 + per
        elif key == "units" and args[i + 1:i + 2] in (["box"], ["lattice"]):
            units = args[i + 1]
            i += 2
        else:
            raise NotImplementedError(
                f"fix {style} keyword {key!r} is not ported (faces "
                "xlo..zhi, units box|lattice)")
    if not walls:
        raise ValueError(f"fix {style}: no wall")
    for w in walls:
        if w[1] != "EDGE" and units == "lattice" and spacing is not None:
            w[1] = float(w[1]) * float(spacing[FACES[w[0]][0]])
    return [tuple(w) for w in walls]

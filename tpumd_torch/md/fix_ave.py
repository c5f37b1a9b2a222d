"""Output fixes: ave/time, ave/atom, ave/histo, ave/correlate, ave/chunk,
print, halt, store/state and property/atom; and tune/kspace.

The port of tpumd/md/fix_ave.py (src/fix_ave_time.cpp, fix_ave_atom.cpp,
fix_ave_histo.cpp, fix_ave_correlate.cpp, fix_ave_chunk.cpp,
fix_print.cpp, fix_halt.cpp, fix_store_state.cpp,
fix_property_atom.cpp).  These fixes act only every Nevery steps and
never touch the dynamics, so they run on the host at the run loop's host
events (``host_every``, ``host_end_of_step``), after the step's forces and
before its thermo row and dumps, as Verlet::run orders end_of_step before
output.  Their inputs (computes, atom attributes, variables) are read from
the device there; their files keep tpumd's layout.  tune/kspace acts at
the same events, swapping the kspace solver.  ave/grid is the exception:
it bins the atoms on the device at its sample steps (``end_of_step``),
keeps its sums there, and only dump grid reads them back.  balance
reorders the atoms' rows at its host events on the matrix engine
(``tpumd_torch/parallel/balance.py``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpumd_torch.md import peratom as pa
from tpumd_torch.md.compute_styles import atom_keyword, expand_wildcards, \
    peratom_input, split_ref
from tpumd_torch.md.fixes import Fix, fix_state
from tpumd_torch.script.formula import SimFormulaContext


def _host(t):
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                      else t, np.float64)


def resolve_input(sim, name):
    """A scalar, global or per-atom input as float64 numpy: c_ID[col]
    (c_ID[*] the whole output), f_ID[i], v_name, an atom attribute or a
    thermo keyword."""
    kind, base, col = split_ref(name)
    if kind == "c":
        c = sim.computes.get(base)
        if c is None:
            raise ValueError(f"no compute {base}")
        if col is None:
            out = c.scalar_value(sim) if c.scalar else c(sim)
            return _host(out)
        if col == "*":
            return _host(c(sim))
        out = c(sim)
        if out.dim() == 0:
            return _host(c.vector_value(sim))[col]
        return _host(out[..., col] if out.dim() > 1 else out[col])
    if kind == "f":
        for fx in sim.fixes:
            if getattr(fx, "id", None) == base and hasattr(fx, "output"):
                out = np.asarray(fx.output(sim), np.float64)
                if col is None or col == "*":
                    return out
                return out[..., col] if out.ndim > 1 else out[col]
        raise ValueError(f"unknown fix output {name}")
    if kind == "v":
        return np.asarray(sim.script.evaluate_variable(base), np.float64)
    if kind in ("d", "i"):
        return _host(peratom_input(sim, name))
    pa_ = atom_keyword(sim, name)
    if pa_ is not None:
        return _host(pa_)
    tv = SimFormulaContext(sim, sim.script).thermo_keyword(name)
    if tv is None:
        raise ValueError(f"unknown input {name!r}")
    return np.asarray(tv, np.float64)


def check_inputs(style, names):
    bad = [nm for nm in names if split_ref(nm)[0] not in ("c", "f", "v")]
    if bad:
        raise NotImplementedError(
            f"fix {style} inputs or keywords {bad} are not ported (inputs "
            "are c_, f_ and v_ references)")


def _group_mask(sim, fx):
    """(natoms,) bool tag-order membership of the fix's group."""
    gmask = _host(pa.atoms(sim).gmask).astype(np.int64)
    return (gmask & fx.groupbit) > 0


class AveBase(Fix):
    """Sampling on the reference's schedule: the Nrepeat steps Nevery
    apart that end at each multiple of Nfreq."""

    # FixAveTime::setup invokes end_of_step once when the run starts on an
    # output step, writing the step-0 rows
    invoke_at_setup = True

    def __init__(self, nevery, nrepeat, nfreq, inputs, file=None):
        self.nevery = int(nevery)
        self.nrepeat = int(nrepeat)
        self.nfreq = int(nfreq)
        self.inputs = list(inputs)
        self.file = file
        self.host_every = self.nevery
        self._samples = []
        self._result = None
        self._fh = None
        self._setup_invoked = False

    def _sample_due(self, step):
        if step == 0:
            return True
        if step < 0 or step % self.nevery:
            return False
        r = step % self.nfreq
        if r == 0:
            return True
        return r >= self.nfreq - (self.nrepeat - 1) * self.nevery

    def output(self, sim):
        if self._result is None:
            return self._before_first(sim)
        return self._result

    def _before_first(self, sim):
        """The output before the first window closes (the reference's
        arrays start zeroed), where its shape is known."""
        raise ValueError(f"fix {self.id}: no average yet")

    def _open(self, header):
        if self._fh is None:
            self._fh = open(self.file, "w")
            self._fh.write(header)

    def _emit(self, sim, row):
        if self.file:
            self._open("# step " + " ".join(self.inputs) + "\n")
            self._fh.write(f"{sim.step} " + " ".join(
                f"{v:.10g}" for v in np.atleast_1d(row).ravel()) + "\n")
            self._fh.flush()


class FixAveTime(AveBase):
    """fix ave/time Nevery Nrepeat Nfreq value... [mode scalar|vector]
    [file f]: averages of global values; mode vector writes the
    reference's vector-file layout (a `TimeStep Number-of-rows` header,
    then `Row value...` lines, src/fix_ave_time.cpp invoke_vector)."""

    name = "ave/time"

    def __init__(self, nevery, nrepeat, nfreq, inputs, file=None,
                 mode_vector=False):
        super().__init__(nevery, nrepeat, nfreq, inputs, file=file)
        self.mode_vector = mode_vector

    def _before_first(self, sim):
        if self.mode_vector:
            return super()._before_first(sim)
        n = len(self.inputs)
        return 0.0 if n == 1 else np.zeros(n)

    def _vector_sample(self, sim):
        cols = []
        for nm in self.inputs:
            v = resolve_input(sim, nm)
            cols.append(v[:, None] if v.ndim == 1 else v)
        return np.concatenate(cols, axis=1) if len(cols) > 1 else cols[0]

    def _emit_vector(self, sim, arr):
        if not self.file:
            return
        self._open(f"# Time-averaged data for fix {self.id}\n"
                   "# TimeStep Number-of-rows\n"
                   "# Row " + " ".join(expand_wildcards(sim, self.inputs))
                   + "\n")
        arr = np.atleast_2d(arr)
        self._fh.write(f"{sim.step} {arr.shape[0]}\n")
        for i, row in enumerate(arr, 1):
            self._fh.write(f"{i} " + " ".join(f"{v:g}" for v in row) + "\n")
        self._fh.flush()

    def host_end_of_step(self, sim):
        if not self._sample_due(sim.step):
            return
        if self.mode_vector:
            self._samples.append(self._vector_sample(sim))
            if sim.step % self.nfreq == 0:
                self._result = np.mean(self._samples[-self.nrepeat:], axis=0)
                self._samples = []
                self._emit_vector(sim, self._result)
            return
        vals = np.array([float(resolve_input(sim, nm).ravel()[0])
                         for nm in self.inputs])
        self._samples.append(vals)
        if sim.step % self.nfreq == 0:
            self._result = np.mean(self._samples[-self.nrepeat:], axis=0)
            if self._result.size == 1:
                self._result = float(self._result[0])
            self._samples = []
            self._emit(sim, self._result)


class FixAveAtom(AveBase):
    """fix ave/atom Nevery Nrepeat Nfreq value...: per-atom averages in
    tag order."""

    name = "ave/atom"
    peratom = True

    def _before_first(self, sim):
        return np.zeros((sim.natoms, len(self.inputs)))

    def host_end_of_step(self, sim):
        if not self._sample_due(sim.step):
            return
        cols = [resolve_input(sim, nm) for nm in self.inputs]
        self._samples.append(np.stack(cols, axis=-1))
        if sim.step % self.nfreq == 0:
            self._result = np.mean(self._samples[-self.nrepeat:], axis=0)
            self._samples = []


class FixAveChunk(AveBase):
    """fix ave/chunk Nevery Nrepeat Nfreq chunkID value... [file f]:
    per-atom values averaged over chunks (density/number and count count
    atoms); one file row a window: step, then each chunk's columns."""

    name = "ave/chunk"

    def __init__(self, nevery, nrepeat, nfreq, chunk_id, inputs, file=None):
        super().__init__(nevery, nrepeat, nfreq, inputs, file)
        self.chunk_id = chunk_id

    def host_end_of_step(self, sim):
        if not self._sample_due(sim.step):
            return
        chunk = sim.computes[self.chunk_id]
        ids = _host(chunk(sim)).astype(np.int64)
        nchunk = chunk.nchunk
        counts = np.bincount(ids - 1, minlength=nchunk).astype(np.float64)
        cols = []
        for nm in self.inputs:
            if nm in ("density/number", "count"):
                cols.append(counts)
                continue
            v = resolve_input(sim, nm)
            sums = np.bincount(ids - 1, weights=v, minlength=nchunk)
            cols.append(np.where(counts > 0, sums / np.maximum(counts, 1),
                                 0.0))
        self._samples.append(np.stack(cols, axis=-1))
        if sim.step % self.nfreq == 0:
            self._result = np.mean(self._samples[-self.nrepeat:], axis=0)
            self._samples = []
            self._emit(sim, self._result)


class FixPrint(Fix):
    """fix print N "text" [file f]: the text, variables substituted, every
    N steps, into the log or a file."""

    name = "print"

    def __init__(self, nevery, text, file=None):
        self.host_every = int(nevery)
        self.text = text.strip('"')
        self.file = file
        self._fh = None

    def host_end_of_step(self, sim):
        if sim.step % self.host_every:
            return
        line = sim.script.substitute(self.text)
        if self.file:
            if self._fh is None:
                self._fh = open(self.file, "w")
            self._fh.write(line + "\n")
            self._fh.flush()
        else:
            sim._log(line)


class FixHalt(Fix):
    """fix halt N attribute op value (src/fix_halt.cpp): the run stops
    cleanly at the first check where the condition holds."""

    name = "halt"
    _OPS = {"<": np.less, "<=": np.less_equal, ">": np.greater,
            ">=": np.greater_equal, "==": np.equal, "!=": np.not_equal}

    def __init__(self, nevery, attr, op, value):
        if op not in self._OPS:
            raise NotImplementedError(f"fix halt operator {op!r}")
        self.host_every = int(nevery)
        self.attr = attr
        self.op = op
        self.value = float(value)

    def host_end_of_step(self, sim):
        if sim.step % self.host_every:
            return
        cur = float(np.asarray(resolve_input(sim, self.attr)).ravel()[0])
        if self._OPS[self.op](cur, self.value):
            sim.halt = (f"fix halt condition {self.attr} {self.op} "
                        f"{self.value} met (value {cur:.6g}) at step "
                        f"{sim.step}")


class FixAveHisto(AveBase):
    """fix ave/histo Nevery Nrepeat Nfreq lo hi Nbin value... [file f]
    [beyond ignore|end|extra]: histograms of the inputs over each window's
    samples (ave one), the reference's '# Bin Coord Count Count/Total'
    rows."""

    name = "ave/histo"

    def __init__(self, nevery, nrepeat, nfreq, lo, hi, nbin, inputs,
                 file=None, beyond="ignore"):
        super().__init__(nevery, nrepeat, nfreq, inputs, file)
        self.lo = float(lo)
        self.hi = float(hi)
        self.nbins = int(nbin)
        if beyond not in ("ignore", "end", "extra"):
            raise NotImplementedError(f"fix ave/histo beyond {beyond!r}")
        self.beyond = beyond
        self._inner = self.nbins
        if beyond == "extra":
            self.nbins += 2
        self._reset_window()

    def _reset_window(self):
        self._bins = np.zeros(self.nbins)
        self._stats = np.array([0.0, 0.0, np.inf, -np.inf])

    def _bin_values(self, vals):
        v = np.asarray(vals, np.float64).ravel()
        if v.size == 0:
            return
        self._stats[2] = min(self._stats[2], v.min())
        self._stats[3] = max(self._stats[3], v.max())
        below, above = v < self.lo, v > self.hi
        inside = ~(below | above)
        binsize = (self.hi - self.lo) / self._inner
        ib = np.minimum(((v[inside] - self.lo) / binsize).astype(int),
                        self._inner - 1)
        if self.beyond == "ignore":
            self._stats[1] += below.sum() + above.sum()
            np.add.at(self._bins, ib, 1.0)
            self._stats[0] += inside.sum()
            return
        self._bins[0] += below.sum()
        self._bins[-1] += above.sum()
        np.add.at(self._bins, ib + (self.beyond == "extra"), 1.0)
        self._stats[0] += v.size

    def host_end_of_step(self, sim):
        if not self._sample_due(sim.step):
            return
        gsel = _group_mask(sim, self)
        for nm in self.inputs:
            vals = resolve_input(sim, nm)
            if vals.ndim and vals.shape[0] == gsel.shape[0]:
                vals = vals[gsel]
            self._bin_values(vals)
        if sim.step % self.nfreq:
            return
        binsize = (self.hi - self.lo) / self._inner
        coords = self.lo + (np.arange(self._inner) + 0.5) * binsize
        if self.beyond == "extra":
            coords = np.concatenate([[self.lo - 0.5 * binsize], coords,
                                     [self.hi + 0.5 * binsize]])
        total = self._stats[0]
        frac = self._bins / total if total else np.zeros_like(self._bins)
        self._result = np.column_stack([coords, self._bins, frac])
        if self.file:
            self._open(f"# Histogrammed data for fix {self.id}\n"
                       "# TimeStep Number-of-bins Total-counts "
                       "Missing-counts Min-value Max-value\n"
                       "# Bin Coord Count Count/Total\n")
            st = self._stats
            mn = st[2] if np.isfinite(st[2]) else 0.0
            mx = st[3] if np.isfinite(st[3]) else 0.0
            # the extremes at full precision, as the reference prints
            # them (shortest round-trip form)
            self._fh.write(f"{sim.step} {self.nbins} {st[0]:g} {st[1]:g} "
                           f"{float(mn)!r} {float(mx)!r}\n")
            for i in range(self.nbins):
                self._fh.write(f"{i + 1} {coords[i]:g} {self._bins[i]:g} "
                               f"{frac[i]:g}\n")
            self._fh.flush()
        self._reset_window()


class FixAveCorrelate(Fix):
    """fix ave/correlate Nevery Nrepeat Nfreq value... [type auto|upper|
    auto/upper] [ave one|running] [file f] (src/fix_ave_correlate.cpp):
    time correlations of global scalars, written every Nfreq as Index
    TimeDelta Ncount rows; with ave one the window-closing sample seeds
    the next window."""

    name = "ave/correlate"

    def __init__(self, nevery, nrepeat, nfreq, inputs, ctype="auto",
                 ave="one", file=None):
        if ctype not in ("auto", "upper", "auto/upper"):
            raise NotImplementedError(f"fix ave/correlate type {ctype!r} "
                                      "is not ported")
        if ave not in ("one", "running"):
            raise NotImplementedError(f"fix ave/correlate ave {ave!r}")
        self.host_every = self.nevery = int(nevery)
        self.nrepeat = int(nrepeat)
        self.nfreq = int(nfreq)
        self.inputs = list(inputs)
        self.ave = ave
        self.file = file
        self._fh = None
        self._result = None
        self._setup_sampled = False
        nv = len(self.inputs)
        if ctype == "auto":
            self.pairs = [(i, i) for i in range(nv)]
        elif ctype == "upper":
            self.pairs = [(i, j) for i in range(nv) for j in range(i + 1, nv)]
        else:
            self.pairs = [(i, j) for i in range(nv) for j in range(i, nv)]
        self._reset()

    def _reset(self):
        self._hist = []             # newest first
        self._corr = np.zeros((self.nrepeat, len(self.pairs)))
        self._count = np.zeros(self.nrepeat, dtype=np.int64)

    def _sample(self, vals):
        self._hist.insert(0, vals)
        del self._hist[self.nrepeat:]
        for m, old in enumerate(self._hist):
            for c, (i, j) in enumerate(self.pairs):
                # the older sample takes the first index
                self._corr[m, c] += old[i] * vals[j]
            self._count[m] += 1

    def _step_sample(self, sim):
        vals = np.array([float(resolve_input(sim, nm).ravel()[0])
                         for nm in self.inputs])
        self._sample(vals)
        if self.nfreq and sim.step % self.nfreq == 0:
            self._emit(sim)
            if self.ave == "one":
                self._reset()
                self._sample(vals)

    def host_setup_sample(self, sim):
        """The reference's setup(): the step-0 sample and a first block."""
        self._step_sample(sim)

    def host_end_of_step(self, sim):
        if sim.step % self.nevery == 0:
            self._step_sample(sim)

    def output(self, sim):
        if self._result is None:
            raise ValueError(f"fix {self.id}: no correlation yet")
        return self._result

    def _emit(self, sim):
        table = self._corr / np.maximum(self._count, 1)[:, None]
        self._result = table
        if not self.file:
            return
        if self._fh is None:
            self._fh = open(self.file, "w")
            self._fh.write(
                f"# Time-correlated data for fix {self.id}\n"
                "# Timestep Number-of-time-windows\n"
                "# Index TimeDelta Ncount "
                + " ".join(f"{self.inputs[i]}*{self.inputs[j]}"
                           for i, j in self.pairs) + "\n")
        self._fh.write(f"{sim.step} {self.nrepeat}\n")
        for m in range(self.nrepeat):
            self._fh.write(f"{m + 1} {m * self.nevery} {int(self._count[m])} "
                           + " ".join(f"{v:g}" for v in table[m]) + "\n")
        self._fh.flush()


class FixStoreState(Fix):
    """fix store/state N input... (src/fix_store_state.cpp): per-atom
    values in tag order, stored at the fix's definition and, with N > 0,
    every N steps; read as f_ID[i]."""

    name = "store/state"
    peratom = True

    def __init__(self, nevery, inputs):
        self.nevery = int(nevery)
        self.host_every = max(self.nevery, 0)
        self.inputs = list(inputs)
        self._stored = None

    def _grab(self, sim):
        cols = [resolve_input(sim, nm) for nm in self.inputs]
        out = np.stack(cols, axis=-1)
        out = np.where(_group_mask(sim, self)[:, None], out, 0.0)
        return out[:, 0] if out.shape[-1] == 1 else out

    def host_setup(self, sim):
        if self._stored is None:
            self._stored = self._grab(sim)

    def host_end_of_step(self, sim):
        if self.nevery and sim.step % self.nevery == 0:
            self._stored = self._grab(sim)

    def output(self, sim):
        if self._stored is None:
            self.host_setup(sim)
        return self._stored


class FixPropertyAtom(Fix):
    """fix property/atom i_name|d_name... (src/fix_property_atom.cpp):
    custom per-atom columns by tag (default 0), set by `set` and read as
    i_name / d_name in dumps, computes and formulas."""

    name = "property/atom"

    def __init__(self, names):
        self.names = list(names)

    def host_setup(self, sim):
        store = sim.custom_peratom
        n = int(_host(pa.current(sim)[0].tag).max())
        for nm in self.names:
            if nm not in store:
                store[nm] = np.zeros(n, np.int64 if nm.startswith("i_")
                                     else np.float64)


class FixTuneKspace(Fix):
    """fix tune/kspace N (src/KSPACE/fix_tune_kspace.cpp; tpumd/md/
    fix_ave.py:530-600): time the long-range solver in place over N-step
    windows against the other of pppm and ewald on the same pair style,
    and keep the faster.  The first window after a swap restarts the
    clock (the swap sets up anew); the swap keeps the accuracy.  The
    reference also tries msm with its pair style and adjusts the Coulomb
    cutoff between trials; tpumd does neither, nor does the port
    (ROADMAP A6).  The clock is ``time.perf_counter``."""

    name = "tune/kspace"

    def __init__(self, nevery):
        self.host_every = int(nevery)
        self._t_last = None
        self._times = {}
        self._phase = 0        # 0: timing the deck's, 1: the other, 2: done

    @staticmethod
    def _make(style, accuracy):
        from tpumd_torch.models.kspace_ewald import Ewald
        from tpumd_torch.models.kspace_pppm import PPPM
        return PPPM(accuracy) if style == "pppm" else Ewald(accuracy)

    def host_end_of_step(self, sim):
        if self._phase == 2 or sim.kspace is None:
            return
        now = time.perf_counter()
        cur = "pppm" if sim.kspace.style.startswith("pppm") else "ewald"
        if self._t_last is None:
            self._t_last = now
            return
        self._times[cur] = now - self._t_last
        acc = sim.kspace.accuracy_relative
        if self._phase == 0:
            other = "ewald" if cur == "pppm" else "pppm"
            sim.kspace = self._make(other, acc)
            sim.invalidate_ctx()
            self._phase = 1
            self._t_last = None
            sim._log(f"fix tune/kspace: timing {other}")
            return
        best = min(self._times, key=self._times.get)
        if best != cur:
            sim.kspace = self._make(best, acc)
            sim.invalidate_ctx()
        self._phase = 2
        t = {k: round(v, 3) for k, v in self._times.items()}
        sim._log(f"fix tune/kspace: times {t} -> keeping {best}")


class FixBalance(Fix):
    """fix balance N thresh rcb|shift dims|x|y|z (src/fix_balance.cpp;
    tpumd/md/fix_ave.py:588-623): every N steps, on the matrix engine,
    the imbalance of the equal-count row blocks (``slab_imbalance``, over
    the card count of the run's device) is measured, and above thresh
    the rows are reordered as the balance command reorders them; the run
    then sets up anew.  On the cell grid it does nothing: equal slot
    ranges are equal work."""

    name = "balance"

    def __init__(self, nevery, thresh, style, dims=""):
        self.host_every = int(nevery)
        self.thresh = float(thresh)
        self.style = "shift" if style in ("x", "y", "z") else str(style)
        self.dims = dims or (style if style in ("x", "y", "z") else "")

    def host_end_of_step(self, sim):
        if sim.step % self.host_every or sim._ctx.is_cellgrid:
            return
        from tpumd_torch.parallel.balance import balance_atoms, part_count, \
            slab_imbalance
        x = sim.state.x.detach().cpu().numpy().astype(np.float64)
        cur = slab_imbalance(x, np.arange(len(x)), part_count(sim.device))
        if cur <= self.thresh:
            return
        before, after = balance_atoms(sim, self.style, dims=self.dims)
        sim._log(f"fix balance: imbalance {before:.4g} -> {after:.4g}")


class FixAveGrid(Fix):
    """fix ave/grid Nevery Nrepeat Nfreq Nx Ny Nz value ... [norm all]
    (src/fix_ave_grid.cpp, atom mode; tpumd/md/fix_ave.py:433-529): at
    each sample step (the Nrepeat steps Nevery apart that end at a
    multiple of Nfreq) every atom of the group adds its values to the cell
    it sits in; at the multiple of Nfreq the window's sums become the
    cells' averages and start again.  Values: vx, vy, vz, density/number,
    density/mass, mass and temp.  Everything stays on the device, in
    float64; the state is (step, sums (cells, values), counts (cells,),
    averages (nz, ny, nx, values), mean counts (nz, ny, nx)), zero until
    the first window closes, as the reference dumps zeros then."""

    name = "ave/grid"
    needs_step = True
    VALUES = ("vx", "vy", "vz", "density/number", "density/mass", "mass",
              "temp")

    def __init__(self, nevery, nrepeat, nfreq, nx, ny, nz, inputs,
                 norm="all"):
        self.nevery, self.nrepeat, self.nfreq = (int(nevery), int(nrepeat),
                                                 int(nfreq))
        self.dims = (int(nx), int(ny), int(nz))
        self.inputs = list(inputs)
        bad = [v for v in self.inputs if v not in self.VALUES]
        if bad or norm != "all":
            raise NotImplementedError(
                f"fix ave/grid values {bad} or norm {norm} are not ported "
                f"(values {' '.join(self.VALUES)}; norm all)")

    def _due(self, step):
        if step <= 0 or step % self.nevery:
            return False
        r = step % self.nfreq
        return r == 0 or r >= self.nfreq - (self.nrepeat - 1) * self.nevery

    def init_state(self, s, ctx):
        nx, ny, nz = self.dims
        z = dict(dtype=torch.float64, device=s.x.device)
        nv = len(self.inputs)
        return (0, torch.zeros((nx * ny * nz, nv), **z),
                torch.zeros(nx * ny * nz, **z),
                torch.zeros((nz, ny, nx, nv), **z),
                torch.zeros((nz, ny, nx), **z))

    def set_step(self, fstate, istep):
        return (istep,) + tuple(fstate[1:])

    def end_of_step(self, s, fstate, ctx):
        step, sums, count, grid, gcount = fstate
        if not self._due(step):
            return s, fstate
        nx, ny, nz = self.dims
        dims = torch.tensor([nx, ny, nz], device=s.x.device)
        sel = self.group_sel(s)
        lo, prd = s.box.lo.double(), s.box.lengths.double()
        rel = (s.x.double() - lo) / prd
        rel = rel - torch.floor(rel)
        cell = torch.minimum((rel * dims).long(), dims - 1)
        flat = (cell[:, 2] * ny + cell[:, 1]) * nx + cell[:, 0]
        flat = torch.where(sel, flat, 0)
        w = sel.double()
        m = ctx.mass_per_atom(s).double()
        v = s.v.double()
        vals = {"density/number": torch.ones_like(m), "mass": m,
                "density/mass": m, "temp": m * torch.sum(v * v, dim=1),
                "vx": v[:, 0], "vy": v[:, 1], "vz": v[:, 2]}
        count = count.index_add(0, flat, w)
        sums = sums.index_add(0, flat, torch.stack(
            [vals[k] for k in self.inputs], dim=1) * w[:, None])
        if step % self.nfreq == 0:
            grid, gcount = self._average(sums, count, prd, ctx)
            sums, count = torch.zeros_like(sums), torch.zeros_like(count)
        return s, (step, sums, count, grid, gcount)

    def _average(self, sums, count, prd, ctx):
        """The closed window's averages and mean counts, (nz, ny, nx, ...)."""
        nx, ny, nz = self.dims
        u = ctx.units
        rep = float(self.nrepeat)
        binvol = torch.prod(prd / torch.tensor(
            [nx, ny, nz], dtype=torch.float64, device=prd.device))
        cols = []
        for k, name in enumerate(self.inputs):
            sk = sums[:, k]
            if name == "density/number":
                cols.append(sk / (binvol * rep))
            elif name == "density/mass":
                cols.append(sk * u.mv2d / (binvol * rep))
            elif name == "temp":
                dof = self.dimension * count * u.boltz
                cols.append(torch.where(count > 0, u.mvv2e * sk
                                        / torch.clamp(dof, min=1e-300), 0.0))
            else:
                cols.append(torch.where(count > 0, sk / torch.clamp(
                    count, min=1.0), 0.0))
        return (torch.stack(cols, dim=1).reshape(nz, ny, nx, -1),
                (count / rep).reshape(nz, ny, nx))

    def grid_data(self, sim, which, index=None):
        """(nz, ny, nx) float64 host array of dump grid's data[index] or
        count."""
        fs = fix_state(sim, self)
        if fs is None:
            return np.zeros(self.dims[::-1])
        if which == "count":
            return fs[4].cpu().numpy()
        return fs[3][..., (index or 1) - 1].cpu().numpy()

    def output(self, sim):
        return self.grid_data(sim, "data")

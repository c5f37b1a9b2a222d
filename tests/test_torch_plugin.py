"""plugin load|list|clear in the port: a user pair style from a Python
file that registers with ``tpumd_torch.models.registry``.

tests/golden/plugin/pair_plugin.py imports tpumd, so the test writes the
torch counterpart of its spring/contact style into tmp_path.  The port's
run with it gives the analytic energy of the sc lattice and the same rows
as tpumd loading the golden file.
"""

import contextlib
import io
import os
import sys

import pytest
import torch

from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "plugin")

PLUGIN = '''
import numpy as np
import torch

from tpumd_torch.models.base import PairStyle
from tpumd_torch.models.registry import register_pair


@register_pair("spring/contact")
class PairSpringContact(PairStyle):
    """E = k (r - rc)^2 for r < rc."""

    name = "spring/contact"

    def settings(self, cut):
        self.cut_global = float(cut)
        self.k = np.zeros((self.ntypes + 1, self.ntypes + 1))

    def coeff(self, ilo, ihi, jlo, jhi, k, *rest):
        for i in range(ilo, ihi + 1):
            for j in range(max(jlo, i), jhi + 1):
                self.k[i, j] = self.k[j, i] = float(k)
                self._setflag[i, j] = True

    def init(self):
        self.drop_tables()

    @property
    def max_cutoff(self):
        return self.cut_global

    def pair_fn(self, r2, itype, jtype):
        (k,) = self.pair_coeffs(r2, itype, jtype, "k")
        r = torch.sqrt(r2)
        inside = r < self.cut_global
        e = torch.where(inside, k * (r - self.cut_global) ** 2, 0.0)
        fpair = torch.where(inside, -2.0 * k * (r - self.cut_global)
                            / torch.clamp(r, min=1e-30), 0.0)
        return fpair, e


__tpumd_styles__ = ("spring/contact",)
'''

DECK = """
units           lj
atom_style      atomic
plugin          load pair_plugin.py
lattice         sc 1.2
region          box block 0 4 0 4 0 4
create_box      1 box
create_atoms    1 box
mass            1 1.0
velocity        all create 0.5 4711 loop geom
pair_style      spring/contact 1.3
pair_coeff      1 1 25.0
neighbor        0.3 bin
fix             1 all nve
thermo          5
run             20
"""


def _rows(sim):
    return [ln.split() for ln in sim.log_lines
            if ln.split() and ln.split()[0].isdigit()]


def test_plugin_pair_style_equals_tpumd(tmp_path):
    from tpumd.script.parser import LammpsScript as JScript
    (tmp_path / "pair_plugin.py").write_text(PLUGIN)
    t = TScript(device="cpu", dtype=torch.float64)
    t.data_dir = str(tmp_path)
    with contextlib.redirect_stdout(sys.stderr):
        t.run_string(DECK.replace("run             20", "run 0"))
    a = (1.0 / 1.2) ** (1.0 / 3.0)
    n = t.sim.natoms
    assert t.sim.last_thermo["epair"] * n == pytest.approx(
        0.5 * n * 6 * 25.0 * (a - 1.3) ** 2, rel=1e-10)
    with contextlib.redirect_stdout(sys.stderr):
        t.run_string("run 20\n")
    j = JScript(data_dir=GOLDEN)
    with contextlib.redirect_stdout(sys.stderr):
        j.run_string(DECK)
    # the run 0 row first, then the run of 20 steps
    ours, theirs = _rows(t.sim)[1:], _rows(j.sim)
    assert [r[0] for r in ours] == [r[0] for r in theirs]
    for a_, b_ in zip(ours, theirs):
        assert [float(v) for v in a_[1:]] == pytest.approx(
            [float(v) for v in b_[1:]], rel=1e-7)


def test_plugin_list_and_clear(tmp_path):
    (tmp_path / "pair_plugin.py").write_text(PLUGIN)
    t = TScript(device="cpu", dtype=torch.float64)
    t.data_dir = str(tmp_path)
    buf = io.StringIO()
    with redirect(buf):
        t.run_string("plugin load pair_plugin.py\nplugin list\n"
                     "info styles\n")
    out = buf.getvalue()
    assert "Loaded plugin pair_plugin.py: 1 styles" in out
    assert "plugin tpumd_plugin_pair_plugin: spring/contact" in out
    assert "spring/contact" in out.split("pair styles:")[1]
    t.run_string("plugin clear")
    buf = io.StringIO()
    with redirect(buf):
        t.run_string("plugin list")
    assert buf.getvalue() == ""
    with pytest.raises(Exception, match="plugin"):
        t.run_string("plugin load missing.py")


def redirect(buf):
    return contextlib.redirect_stdout(buf)

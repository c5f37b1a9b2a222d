"""The output remainders of the port on the CPU in float64: the local
computes with dump local and cfg, fix ave/grid with dump grid, binary
dumps, thermo_style multi, thermo_modify lost, dump image and movie, and
fix nvt's state through a restart file.

* tests/golden/dump_local, ave_grid and bindump verbatim against the
  reference binary's files at tpumd's tests' tolerances
  (tests/test_dump_local.py 2e-5, test_ave_grid.py 1e-5,
  test_bindump.py: every header byte, the step-0 snapshot byte for byte).
* thermo_style multi with thermo_modify lost warn, atoms leaving a fixed
  face: every printed line equals tpumd's but the CPU seconds.
* dump image: the port's PPM against tpumd's of the same deck, pixel by
  pixel (at most 0.5 % of the pixels differ, by at most one level in
  255 where both draw the same atom); dump movie: one P6 frame a snapshot.
* A run with fix nvt cut by write_restart and read_restart gives the
  uninterrupted run's rows (tpumd restarts the chains from zero).
"""

import contextlib
import os
import re
import sys

import numpy as np
import pytest
import torch

from tpumd_torch import remainder_goldens as rg
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

LJ = """
units           lj
atom_style      atomic
lattice         fcc 0.8442
region          box block 0 4 0 4 0 4
create_box      1 box
create_atoms    1 box
mass            1 1.0
velocity        all create 1.44 87287 loop geom
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
neigh_modify    every 1 delay 0 check yes
"""


def port(text, data_dir=None):
    t = TScript(device="cpu", dtype=torch.float64)
    t.data_dir = str(data_dir or ".")
    with contextlib.redirect_stdout(sys.stderr):
        t.run_string(text)
    return t


def tpumd(text, data_dir=None):
    from tpumd.script.parser import LammpsScript as JScript
    j = JScript(data_dir=str(data_dir or "."))
    with contextlib.redirect_stdout(sys.stderr):
        j.run_string(text)
    return j


@pytest.mark.parametrize("name", ("dump_local", "ave_grid", "bindump"))
def test_output_golden_against_reference(name, tmp_path):
    script = rg.run(GOLD, name, str(tmp_path), "cpu", torch.float64)
    assert rg.failures(GOLD, name, script, str(tmp_path)) == []


def test_ave_grid_keeps_its_sums_on_the_device(tmp_path):
    """fix ave/grid samples inside the segments: it ends none of them."""
    script = rg.run(GOLD, "ave_grid", str(tmp_path), "cpu", torch.float64)
    fx = next(f for f in script.sim.fixes if f.name == "ave/grid")
    assert fx.host_every == 0 and fx.needs_step
    assert fx.grid_data(script.sim, "count").sum() == pytest.approx(864.0)


def _lines(sim):
    return [re.sub(r"CPU = .*\(sec\)", "CPU", ln) for ln in sim.log_lines
            if not ln.startswith(("Loop time", "Performance"))]


def test_thermo_multi_and_lost_equal_tpumd():
    deck = (LJ.replace("units           lj",
                       "units           lj\nboundary        f p p")
            .replace("1.44 87287", "3.0 87287")
            + "fix 1 all nve\nthermo_style multi\nthermo_modify lost warn\n"
              "thermo 10\nrun 30\n")
    t, j = port(deck), tpumd(deck)
    assert _lines(t.sim) == _lines(j.sim)
    assert sum("WARNING: Lost atoms" in ln for ln in t.sim.log_lines) == 3
    assert sum(ln.startswith("TotEng") for ln in t.sim.log_lines) == 4
    quiet = port(deck.replace("lost warn", "lost ignore"))
    assert not any("WARNING" in ln for ln in quiet.sim.log_lines)
    with pytest.raises(RuntimeError, match="Lost atoms"):
        port(deck.replace("lost warn", "lost error"))


def _ppm(path):
    with open(path, "rb") as fh:
        raw = fh.read()
    head = raw.split(b"\n", 3)
    w, h = (int(v) for v in head[1].split())
    return np.frombuffer(head[3], np.uint8).reshape(h, w, 3)


def test_dump_image_equals_tpumd(tmp_path):
    deck = (LJ + "fix 1 all nve\ndump 1 all image 2 img.*.ppm type type "
            "size 128 128 zoom 1.4\ndump 2 all movie 2 movie.ppm type type "
            "size 64 64\nrun 4\n")
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    port(deck, tmp_path / "t")
    tpumd(deck, tmp_path / "j")
    for step in (0, 2, 4):
        a = _ppm(tmp_path / "t" / f"img.{step}.ppm").astype(int)
        b = _ppm(tmp_path / "j" / f"img.{step}.ppm").astype(int)
        assert a.shape == b.shape == (128, 128, 3)
        differ = np.any(a != b, axis=2)
        assert differ.mean() <= 0.005, step
        assert (a > 0).any()
    with open(tmp_path / "t" / "movie.ppm", "rb") as fh:
        movie = fh.read()
    assert movie.count(b"P6\n64 64\n255\n") == 3
    assert len(movie) == 3 * (len(b"P6\n64 64\n255\n") + 64 * 64 * 3)


def test_restart_keeps_fix_nvt_chains(tmp_path):
    """write_restart after 20 steps, read_restart with the same fix nvt:
    the next 20 rows equal the uninterrupted run's."""
    nvt = "fix th all nvt temp 1.0 1.0 0.5\nthermo 5\n"
    whole = port(LJ + nvt + "run 20\nrun 20\n")
    port(LJ + nvt + f"run 20\nwrite_restart {tmp_path}/r.npz\n")
    again = port("units lj\natom_style atomic\npair_style lj/cut 2.5\n"
                 f"read_restart {tmp_path}/r.npz\n"
                 "pair_coeff 1 1 1.0 1.0 2.5\nneighbor 0.3 bin\n"
                 "neigh_modify every 1 delay 0 check yes\n" + nvt + "run 20\n")

    def rows(sim):
        out = {}
        for ln in sim.log_lines:
            p = ln.split()
            if p and p[0].isdigit():
                out[int(p[0])] = [float(v) for v in p[1:]]
        return out
    a, b = rows(whole.sim), rows(again.sim)
    assert sorted(b) == [20, 25, 30, 35, 40]
    for step in (25, 30, 35, 40):
        np.testing.assert_allclose(b[step], a[step], rtol=1e-9, atol=1e-12)
    fresh = port("units lj\natom_style atomic\npair_style lj/cut 2.5\n"
                 f"read_restart {tmp_path}/r.npz\n"
                 "pair_coeff 1 1 1.0 1.0 2.5\nneighbor 0.3 bin\n"
                 "neigh_modify every 1 delay 0 check yes\n"
                 + nvt.replace("fix th", "fix other") + "run 20\n")
    assert rows(fresh.sim)[40] != pytest.approx(a[40], rel=1e-9)

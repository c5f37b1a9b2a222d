"""The port's chunk family against tpumd's.

The chunk_family water deck (tests/golden/chunk_family: charmm + PPPM on
the grid, B5's plain version) with more chunk computes added runs through
tpumd and the port on the CPU in float64 with its fix ave/time lines
dropped, and every compute of md/compute_chunk.py, the chunk computes of
compute_extra.py (reduce/chunk, chunk/spread/atom), property/chunk,
dipole and dipole/chunk, fragment/atom and aggregate/atom (the bonds of the
waters) and the style energies (pair, bond, angle, dihedral, improper) is
compared at steps 0 and 10 to 1e-10 of its
largest value; chunk IDs and counts exactly.  fix ave/chunk's file on a
bin/1d chunking equals tpumd's.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

EXTRA = """
compute         cb all chunk/atom bin/1d z lower 3.0
compute         ctp all chunk/atom type
compute         pc all property/chunk ca count id
compute         pcb all property/chunk cb count
compute         tnc all temp/chunk ca
compute         tcc all temp/chunk cb temp com yes
compute         vb all vcm/chunk cb
compute         kea all ke/atom
compute         rc all reduce/chunk ca sum c_kea
compute         rcm all reduce/chunk cb max vx
compute         sp all chunk/spread/atom ca c_c1[3] c_c3
compute         dip all dipole
compute         dipg all dipole geometry
compute         dc all dipole/chunk ca
compute         fr all fragment/atom
compute         ag all aggregate/atom 1.2
compute         eb all bond
compute         ea all angle
compute         ed all dihedral
compute         ei all improper
compute         ep all pair lj/charmm/coul/long
"""
# (ID, integer-valued)
IDS = [("c1", False), ("c2", False), ("c3", False), ("c4", False),
       ("c5", False), ("c6", False), ("c7", False), ("c8", False),
       ("c9", False), ("cm", False), ("ct", True), ("cn", False),
       ("cg", False), ("ca", True), ("cb", True), ("ctp", True),
       ("pc", True), ("pcb", True), ("tnc", False), ("tcc", False),
       ("vb", False), ("rc", False), ("rcm", False), ("sp", False),
       ("dip", False), ("dipg", False), ("dc", False), ("fr", True),
       ("ag", True), ("eb", False), ("ea", False), ("ed", False),
       ("ei", False), ("ep", False)]


def deck():
    text = open(os.path.join(GOLD, "chunk_family", "in.chk")).read()
    text = "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith("fix             a"))
    pre, _ = text.rsplit("\nrun", 1)
    return pre + EXTRA


@pytest.fixture(scope="module")
def values(tmp_path_factory):
    d = tmp_path_factory.mktemp("chunk")
    shutil.copy(os.path.join(GOLD, "chunk_family", "data.water"), d)
    j = JScript(data_dir=str(d))
    t = TScript(device="cpu", dtype=torch.float64)
    t.data_dir = str(d)
    out = {}
    for steps in ("run 0", "run 10"):
        j.run_string(deck() + steps if steps == "run 0" else steps)
        t.run_string(deck() + steps if steps == "run 0" else steps)
        out[j.sim.step] = (
            {cid: np.asarray(j.sim.computes[cid].evaluate(j.sim))
             for cid, _ in IDS},
            {cid: t.sim.computes[cid](t.sim).cpu().numpy()
             for cid, _ in IDS},
            {cid: getattr(t.sim.computes[cid], "nchunk", None)
             for cid in ("ca", "cb", "ctp")},
            {cid: getattr(j.sim.computes[cid], "nchunk", None)
             for cid in ("ca", "cb", "ctp")})
    return out


@pytest.mark.parametrize("step", [0, 10])
@pytest.mark.parametrize("cid,integer", IDS, ids=[c for c, _ in IDS])
def test_chunk_compute_matches_tpumd(cid, integer, step, values):
    want_all, got_all, tn, jn = values[step]
    got = np.asarray(got_all[cid], np.float64)
    want = np.asarray(want_all[cid], np.float64)
    assert got.shape == want.shape, (cid, got.shape, want.shape)
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * scale)
    assert tn == jn


def test_ave_chunk_file_equals_tpumd(tmp_path):
    """fix ave/chunk on bin/1d chunks of a water box: the file's rows."""
    shutil.copy(os.path.join(GOLD, "chunk_family", "data.water"), tmp_path)
    lines = deck() + f"""
compute         ke all ke/atom
fix             ac all ave/chunk 2 3 10 cb vx c_ke density/number &
                file {tmp_path}/{{w}}.out
run             20
"""
    j = JScript(data_dir=str(tmp_path))
    j.run_string(lines.format(w="j"))
    t = TScript(device="cpu", dtype=torch.float64)
    t.data_dir = str(tmp_path)
    t.run_string(lines.format(w="t"))
    a = np.loadtxt(tmp_path / "t.out")
    b = np.loadtxt(tmp_path / "j.out")
    assert a.shape == b.shape == (2, 1 + 3 * t.sim.computes["cb"].nchunk)
    np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8)

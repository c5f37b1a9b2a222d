"""The port's neb command and fix neb (md/neb.py) against tpumd's, on the
CPU in f64: tests/test_neb.py's vacancy hop in 3^3 fcc cells at 0.85
(107 atoms, the atom at (a/2, a/2, 0) hopping into the vacancy at the
origin, 8 images).

* Short stages (N1 = 20, then N2 = 10 with the climber) whose band
  equals tpumd's to 1e-10 (up to whole box lengths: tpumd wraps the band
  at every iteration, the port at each image's rebuild).
* A cross-check of the port's converged 8-image hop (neb 0.0 1.0e-6 400
  900 100) against tpumd's figures of that run, written out here (-m slow
  runs tpumd, ~190 s, to check them): the barriers and image energies to
  1e-8, the reaction coordinates to 1e-5, the same climber; the physics
  invariants of tpumd's test: |F_neb| < ftol at the climber, EBF = EBR
  (the hop's mirror symmetry) to 1e-6, the end images' energies equal, the
  climber at rd 0.5.  The live comparison of a converged hop, both
  packages run, is test_torch_neb_hop.py's (4 images, ftol 1e-4).
* The projection alone (``_neb_project``) against tpumd's on a random band
  to 1e-13, with and without a climber, on a subgroup.
* read_neb_file's errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumd.md import neb as jneb
from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.md import neb as tneb
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)
ALAT = (4 / 0.85) ** (1 / 3.0)
HEAD = """
units           lj
atom_style      atomic
boundary        p p p
lattice         fcc 0.85
region          box block 0 3 0 3 0 3
create_box      1 box
create_atoms    1 box
mass            1 1.0
region          vac sphere 0.05 0.05 0.0 0.18
delete_atoms    region vac
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
"""


def final_file(tmp_path):
    """The final-coordinates file: the hopping atom at the vacancy site."""
    sc = TScript(device="cpu", dtype=torch.float64)
    sc.run_string(HEAD)
    sc._finalize_atoms()
    s = sc.sim.state
    d = (s.x.double() - torch.tensor([0.5 * ALAT, 0.5 * ALAT, 0.0])).abs()
    i = int(torch.argmin(d.max(dim=1).values))
    assert float(d[i].max()) < 1e-6
    path = tmp_path / "final.neb"
    path.write_text(f"1\n{int(s.tag[i])} 0.0 0.0 0.0\n")
    return path


def run_both(tmp_path, n1, n2, nevery):
    path = final_file(tmp_path)
    deck = HEAD + (f"fix 1 all neb 1.0\nneb 0.0 1.0e-6 {n1} {n2} {nevery} "
                   f"final {path} replicas 8\n")
    j = JScript()
    j.run_string(deck)
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string(deck)
    # tpumd's band in its rows; the port's in tag order
    tag = np.asarray(jax.device_get(j.sim.state.tag))
    jres = dict(j.neb_result)
    band = np.zeros_like(jres["band_x"])
    band[:, tag - 1] = jres["band_x"]
    jres["band_x"] = band
    return jres, t.neb_result


def test_neb_short_stage_band(tmp_path):
    j, t = run_both(tmp_path, 20, 10, 10)
    # tpumd wraps the band into the box at every iteration, the port at
    # each image's rebuild: the positions agree up to whole box lengths
    ell = 3 * ALAT
    d = t["band_x"] - j["band_x"]
    d -= ell * np.round(d / ell)
    np.testing.assert_allclose(d, 0.0, rtol=0, atol=1e-10)
    np.testing.assert_allclose(t["energies"], j["energies"], rtol=1e-12)
    assert t["climber"] == j["climber"]
    assert t["iterations"] == 30 and t["evaluations"] == 8 * 33


# tpumd's converged hop (neb 0.0 1.0e-6 400 900 100, replicas 8) on the
# CPU in f64, from test_neb_hop_tpumd_reference (-m slow: tpumd's band
# takes ~190 s there, rebuilding every image's matrix every iteration)
TPUMD_HOP = {
    "ebf": 1.9988161538525446, "ebr": 1.998816153852431, "climber": 3,
    "energies": [-724.1400908401775, -723.479856738769, -722.5866470264859,
                 -722.141274686325, -722.3643949534701, -722.9482756123114,
                 -723.7593336394375, -724.1400908401774],
    "rd": [0.0, 0.1658859298995687, 0.3317718601283507, 0.49765779050198844,
           0.6232431807864718, 0.7488286597336458, 0.8744142884890104, 1.0],
    "step": 600}


def hop(tmp_path, pkg):
    path = final_file(tmp_path)
    sc = (JScript() if pkg == "tpumd"
          else TScript(device="cpu", dtype=torch.float64))
    sc.run_string(HEAD + "fix 1 all neb 1.0\nneb 0.0 1.0e-6 400 900 100 "
                  f"final {path} replicas 8\n")
    return sc.neb_result


@pytest.mark.slow
def test_neb_hop_tpumd_reference(tmp_path):
    j = hop(tmp_path, "tpumd")
    for k, v in TPUMD_HOP.items():
        np.testing.assert_allclose(j[k], v, rtol=1e-12, atol=0)


def test_neb_converged_hop(tmp_path):
    """The port's converged hop against tpumd's: the energies (second
    order in the positions) to 1e-8; the reaction coordinates (first
    order, on a band converged to |F| < 1e-6) to 1e-5 (they agree to
    1.2e-6)."""
    j, t = TPUMD_HOP, hop(tmp_path, "port")
    # tpumd's climbing stage stops at 600 iterations (|F| 1.28e-6 at 500),
    # the port's at 500 or 600: the criterion sits at the last digits
    assert t["climber"] == j["climber"] and t["step"] in (500, 600)
    for k in ("ebf", "ebr"):
        assert t[k] == pytest.approx(j[k], rel=1e-8), k
    np.testing.assert_allclose(t["energies"], j["energies"], rtol=1e-8)
    np.testing.assert_allclose(t["rd"], j["rd"], rtol=0, atol=1e-5)
    assert t["fmax_atom"] < 1.0e-6
    assert t["ebf"] > 0.05
    assert abs(t["ebf"] - t["ebr"]) < 1e-6 * max(abs(t["ebf"]), 1.0)
    e = t["energies"]
    assert abs(e[0] - e[-1]) < 1e-6 * abs(e[0])
    assert abs(t["rd"][t["climber"]] - 0.5) < 0.05
    assert int(np.argmax(e)) == t["climber"]


@pytest.mark.parametrize("climber", [-1, 2])
def test_neb_project_against_tpumd(climber):
    rng = np.random.default_rng(7)
    R, N = 5, 40
    ell = np.array([5.0, 6.0, 7.0])
    x = rng.uniform(0, 1, (R, N, 3)) * ell
    f = rng.normal(size=(R, N, 3))
    e = rng.normal(size=R)
    gsel = rng.uniform(size=N) < 0.7
    box = type("B", (), {"lengths": jnp.asarray(ell),
                         "periodic": (True, True, False)})()
    want = jneb._neb_project(jnp.asarray(x), jnp.asarray(f), jnp.asarray(e),
                             box, jnp.asarray(gsel), 1.3, jnp.int32(climber))
    got = tneb._neb_project(torch.as_tensor(x), torch.as_tensor(f),
                            torch.as_tensor(e), torch.as_tensor(ell),
                            torch.tensor([True, True, False]),
                            torch.as_tensor(gsel), 1.3, climber)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.device_get(want)),
                               rtol=0, atol=1e-13)


def test_read_neb_file(tmp_path):
    p = tmp_path / "f.neb"
    p.write_text("# final\n2\n5 1.0 2.0 3.0\n7 4 5 6 # tail\n")
    tags, xyz = tneb.read_neb_file(str(p), 10)
    assert tags.tolist() == [5, 7] and xyz[1].tolist() == [4.0, 5.0, 6.0]
    p.write_text("3\n5 1.0 2.0 3.0\n")
    with pytest.raises(ValueError, match="incorrectly formatted"):
        tneb.read_neb_file(str(p), 10)

"""The port's fix hyper/global and hyper command (md/fix_hyper.py) against
tpumd's, on the CPU in f64 (tests/test_tad_hyper.py's deck: 3^3 fcc cells
at 1.0, T 0.2, ``fix h all hyper/global 1.3 0.3 0.4 0.4``).

* The analytic bias of test_hyper_bias_force_analytic: one atom moved along
  a bond (with a sideways part, so that its collinear partner bond loses
  the largest-strain race); the bias force on the bond's two atoms equal to
  2 Vmax e / q^2 / r0 / r times the bond vector, in both packages, to
  1e-12; every other atom untouched; the hyper time advanced by
  exp(beta Vbias) dt.
* The hyper command's statistics (t_hyper, boost, nbias, nobias,
  negstrain, ave_boost, nevent) equal to tpumd's to 1e-10, with the bias
  and with fix-ID NULL; the bond lists equal as sets of tag pairs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.core.state import tag_rows
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)
DECK = """
units           lj
atom_style      atomic
lattice         fcc 1.0
region          box block 0 3 0 3 0 3
create_box      1 box
create_atoms    1 box
mass            1 1.0
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
neigh_modify    delay 0 every 1 check yes
velocity        all create 0.2 87287 loop geom
fix             1 all nve
{extra}
compute         ev all event/displace 0.5
"""
HYPER = "fix h all hyper/global 1.3 0.3 0.4 0.4"


def build(pkg, extra=""):
    sc = (JScript() if pkg == "tpumd"
          else TScript(device="cpu", dtype=torch.float64))
    sc.run_string(DECK.format(extra=extra))
    sc._finalize_atoms()
    sc.sim.verbose = False
    sc.sim.thermo_every = 0
    return sc


def test_hyper_bias_force_analytic():
    q, vmax, beta = 0.3, 0.4, 1.0 / 0.4
    # tpumd: its bond list by row; the first bond's atoms by tag
    jsc = build("tpumd", HYPER)
    jsim = jsc.sim
    jsim.setup()
    jfx = [f for f in jsim.fixes if f.name == "hyper/global"][0]
    jfs = jfx.build_bonds(jsim, jsim._carry)
    js = jsim._carry[0]
    jtag = np.asarray(jax.device_get(js.tag))
    bi, bj = int(jfs["bi"][0]), int(jfs["bj"][0])
    ti, tj = int(jtag[bi]), int(jtag[bj])
    ell = np.asarray(jax.device_get(js.box.lengths), np.float64)
    x_tag = np.zeros((jtag.shape[0], 3))
    x_tag[jtag - 1] = np.asarray(jax.device_get(js.x), np.float64)
    d = x_tag[ti - 1] - x_tag[tj - 1]
    d -= np.round(d / ell) * ell
    uhat = d / np.linalg.norm(d)
    perp = np.cross(uhat, [0.0, 0.0, 1.0])
    if np.linalg.norm(perp) < 0.5:
        perp = np.cross(uhat, [0.0, 1.0, 0.0])
    perp /= np.linalg.norm(perp)
    x_tag[ti - 1] += 0.05 * uhat + 0.02 * perp
    d = x_tag[ti - 1] - x_tag[tj - 1]
    d -= np.round(d / ell) * ell
    r0 = float(jfs["r0"][0])
    ebias = (np.linalg.norm(d) - r0) / r0
    expected = 2.0 * vmax * ebias / q ** 2 / r0 / np.linalg.norm(d) * d
    forces = {}
    # tpumd's post_force
    s2 = js.replace(x=jnp.asarray(x_tag[jtag - 1]), f=jnp.zeros_like(js.f))
    s3, fs = jfx.post_force(s2, jfs, jsim._ctx)
    f = np.zeros_like(x_tag)
    f[jtag - 1] = np.asarray(jax.device_get(s3.f))
    forces["tpumd"] = (f, float(fs["t_hyper"]), int(fs["nbias"]))
    # the port's, its bond list by tag
    tsc = build("port", HYPER)
    tsim = tsc.sim
    tsim.setup()
    tfx = [f for f in tsim.fixes if f.name == "hyper/global"][0]
    tfs = tfx.build_bonds(tsim, tsim._carry)
    ts = tsim._carry[0]
    pairs = set(zip(tfs["ti"].tolist(), tfs["tj"].tolist()))
    nb = int(np.asarray(jfs["bvalid"]).sum())
    jpairs = {tuple(sorted((int(jtag[a]), int(jtag[b])))) for a, b in zip(
        np.asarray(jfs["bi"])[:nb], np.asarray(jfs["bj"])[:nb])}
    assert pairs == jpairs
    rows = tag_rows(ts.tag, tsim.natoms)
    x = ts.x.clone()
    x[rows] = torch.as_tensor(x_tag)
    s3, fs = tfx.post_force(ts.replace(x=x, f=torch.zeros_like(ts.f)), tfs,
                            tsim._ctx)
    forces["port"] = (s3.f[rows].numpy(), float(fs["t_hyper"]),
                      int(fs["nbias"]))
    vbias = vmax * (1.0 - ebias ** 2 / q ** 2)
    for pkg, (f, t_hyper, nbias) in forces.items():
        np.testing.assert_allclose(f[ti - 1], expected, rtol=1e-9)
        np.testing.assert_allclose(f[tj - 1], -expected, rtol=1e-9)
        f[[ti - 1, tj - 1]] = 0.0
        assert np.abs(f).max() == 0.0, pkg
        assert t_hyper == pytest.approx(np.exp(beta * vbias) * 0.005,
                                        rel=1e-12)
        assert nbias == 1
    np.testing.assert_allclose(forces["port"][0], forces["tpumd"][0],
                               rtol=0, atol=1e-12)


KEYS = ("t_hyper", "boost", "nbias", "nobias", "negstrain", "ave_boost",
        "nevent", "steps")


@pytest.mark.parametrize("fix", ["h", "NULL"])
def test_hyper_stats_against_tpumd(fix):
    out = {}
    for pkg in ("tpumd", "port"):
        sc = build(pkg, HYPER if fix == "h" else "")
        sc.execute(f"hyper 40 10 {fix} ev min 1e-6 1e-6 200 200")
        out[pkg] = sc.hyper_stats
        assert sc.sim.step == 40
    t, j = out["port"], out["tpumd"]
    for k in KEYS:
        if k in j:
            assert t[k] == pytest.approx(j[k], rel=1e-10, abs=1e-12), k
    if fix == "h":
        assert t["boost"] > 1.0 and t["t_hyper"] > 40 * 0.005
        assert t["nevent"] == 0 and t["nbias"] + t["nobias"] == 40
    else:
        assert t["boost"] == 1.0 and t["t_hyper"] == pytest.approx(0.2)

"""The port's converged vacancy hop against tpumd's, both run here on the
CPU in f64: tests/test_neb.py's hop in 3^3 fcc cells at 0.85 (107 atoms)
on a band of 4 images, ``neb 0.0 1.0e-4 400 900 50``, where both packages
converge to |F_neb| < ftol in a few hundred iterations (tpumd's band
rebuilds every image's matrix at every iteration, so its run at 8 images
and ftol 1e-6 takes minutes; test_torch_neb.py holds the port's 8-image
hop against tpumd's figures of that run).

The same stage-1 and climbing iteration counts and the same climber; the
barriers, the image energies and the reaction coordinates to 1e-8; then
tpumd's physics invariants on the port's band.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_neb import HEAD, final_file
from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.script.parser import LammpsScript as TScript

torch.set_num_threads(2)
NEB = "fix 1 all neb 1.0\nneb 0.0 1.0e-4 400 900 50 final {} replicas 4\n"


@pytest.fixture(scope="module")
def hops(tmp_path_factory):
    deck = HEAD + NEB.format(final_file(tmp_path_factory.mktemp("hop")))
    j = JScript()
    j.run_string(deck)
    t = TScript(device="cpu", dtype=torch.float64)
    t.run_string(deck)
    jres = {k: jax.device_get(v) for k, v in j.neb_result.items()
            if k != "band_x"}
    return jres, t.neb_result


def test_neb_hop_iterations_and_climber(hops):
    j, t = hops
    assert t["climber"] == j["climber"] == 1
    assert t["step"] == j["step"]
    assert t["stage1"]["step"] == j["stage1"]["step"]


@pytest.mark.parametrize("key", ["ebf", "ebr", "energies", "rd"])
def test_neb_hop_figures(hops, key):
    j, t = hops
    if key == "rd":
        np.testing.assert_allclose(t[key], j[key], rtol=0, atol=1e-8)
    else:
        np.testing.assert_allclose(t[key], j[key], rtol=1e-8, atol=0)


def test_neb_hop_invariants(hops):
    _, t = hops
    e = t["energies"]
    assert t["fmax_atom"] < 1.0e-4
    assert 1.0 < t["ebf"] < 3.0
    assert abs(t["ebf"] - t["ebr"]) < 1e-6 * abs(t["ebf"])
    assert abs(e[0] - e[-1]) < 1e-6 * abs(e[0])
    assert abs(t["rd"][t["climber"]] - 0.5) < 0.05
    assert int(np.argmax(e)) == t["climber"]

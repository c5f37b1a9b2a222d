"""The port's C API shim (tpumd_torch/capi/tpumd_capi.c over
tpumd_torch/capi/bridge.py) against tpumd's (tpumd/capi), both built here
with gcc and loaded by ctypes into this process, on the CPU in f64.

Every call of tpumd's tests/test_capi.py, on its decks, through both
libraries: the values equal (arrays to 1e-12).  The port's instance opens
with ``--device cpu --dtype f64`` (its default is the card); tpumd's shim
ignores its arguments.  Then the Fortran module's ``bind(c, name=...)``
symbols, each in the port's C source and in its built library, and no
import of tpumd or jax anywhere in tpumd_torch/ or chip_smoke.py.
"""

import ctypes
import os
import re

import numpy as np
import pytest

from tpumd.capi.build import build as jbuild
from tpumd_torch.capi.build import SRC, build as tbuild

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P, C, I, D = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_double
DP = ctypes.POINTER(ctypes.c_double)
FN = ctypes.CFUNCTYPE(None, P, ctypes.c_int64, I,
                      ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(DP),
                      ctypes.POINTER(DP))
ARGS = [b"lmp", b"--device", b"cpu", b"--dtype", b"f64"]

DECK = b"""
units lj
atom_style atomic
lattice fcc 0.8442
region box block 0 4 0 4 0 4
create_box 1 box
create_atoms 1 box
mass 1 1.0
velocity all create 1.44 87287 loop geom
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0 2.5
neighbor 0.3 bin
neigh_modify delay 0 every 5 check no
fix 1 all nve
run 10
"""


def declare(lib):
    sigs = {
        "lammps_open_no_mpi": (P, [I, P, P]),
        "lammps_command": (None, [P, C]),
        "lammps_commands_string": (None, [P, C]),
        "lammps_get_natoms": (D, [P]),
        "lammps_get_thermo": (D, [P, C]),
        "lammps_extract_atom": (P, [P, C]),
        "lammps_gather_atoms": (None, [P, C, I, I, P]),
        "lammps_version": (I, [P]),
        "lammps_close": (None, [P]),
        "lammps_extract_compute": (P, [P, C, I, I]),
        "lammps_extract_variable": (P, [P, C, C]),
        "lammps_set_variable": (I, [P, C, C]),
        "lammps_extract_box": (None, [P] + [DP] * 5
                               + [ctypes.POINTER(I)] * 2),
        "lammps_extract_setting": (I, [P, C]),
        "lammps_create_atoms": (I, [P, I, ctypes.POINTER(I),
                                    ctypes.POINTER(I), DP, DP,
                                    ctypes.POINTER(I), I]),
        "lammps_has_error": (I, [P]),
        "lammps_get_last_error_message": (I, [P, C, I]),
        "lammps_free": (None, [P]),
        "lammps_set_fix_external_callback": (None, [P, C, P, P]),
        "lammps_fix_external_get_force": (P, [P, C]),
        "lammps_fix_external_set_energy_global": (None, [P, C, D]),
        "lammps_extract_fix": (P, [P, C, I, I, I, I]),
        "lammps_has_style": (I, [P, C, C]),
        "lammps_style_count": (I, [P, C]),
        "lammps_style_name": (I, [P, C, I, C, I]),
        "lammps_has_id": (I, [P, C, C]),
        "lammps_id_count": (I, [P, C]),
        "lammps_id_name": (I, [P, C, I, C, I]),
        "lammps_variable_info": (I, [P, I, C, I]),
        "lammps_memory_usage": (None, [P, DP]),
        "lammps_gather_atoms_subset": (None, [P, C, I, I, I,
                                              ctypes.POINTER(I), P]),
        "lammps_scatter_atoms_subset": (None, [P, C, I, I, I,
                                               ctypes.POINTER(I), P]),
        "lammps_extract_global": (P, [P, C]),
        "lammps_extract_global_datatype": (I, [P, C]),
        "lammps_extract_atom_datatype": (I, [P, C]),
        "lammps_last_thermo": (P, [P, C, I]),
        "lammps_find_pair_neighlist": (I, [P, C, I, I, I]),
        "lammps_neighlist_num_elements": (I, [P, I]),
        "lammps_neighlist_element_neighbors": (
            None, [P, I, I, ctypes.POINTER(I), ctypes.POINTER(I),
                   ctypes.POINTER(ctypes.POINTER(I))]),
        "lammps_python_api_version": (I, []),
        "lammps_has_gpu_device": (I, []),
        "lammps_fix_external_set_vector_length": (None, [P, C, I]),
        "lammps_fix_external_set_vector": (None, [P, C, I, D]),
        "lammps_gather": (None, [P, C, I, I, P]),
        "lammps_scatter_atoms": (None, [P, C, I, I, P]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    d = tmp_path_factory.mktemp("capi")
    return {"tpumd": declare(ctypes.CDLL(jbuild(str(d)))),
            "port": declare(ctypes.CDLL(tbuild(str(d / "port"))))}


def open_(lib):
    argv = (ctypes.c_char_p * len(ARGS))(*ARGS)
    h = lib.lammps_open_no_mpi(len(ARGS), ctypes.cast(argv, P), None)
    assert h
    return h


def dbl(p):
    return ctypes.cast(p, DP)[0]


def drive(lib):
    out = {}
    h = open_(lib)
    out["version"] = lib.lammps_version(h)
    lib.lammps_commands_string(h, DECK)
    out["natoms"] = lib.lammps_get_natoms(h)
    out["pe"] = lib.lammps_get_thermo(h, b"pe")
    xptr = lib.lammps_extract_atom(h, b"x")
    rows = ctypes.cast(xptr, ctypes.POINTER(DP))
    out["x0_finite"] = all(np.isfinite([rows[0][i] for i in range(3)]))
    buf = (ctypes.c_double * (256 * 3))()
    lib.lammps_gather_atoms(h, b"x", 1, 3, buf)
    out["x"] = np.frombuffer(buf, np.float64).reshape(256, 3).copy()
    lib.lammps_command(h, b"run 5")
    out["step"] = lib.lammps_get_thermo(h, b"step")
    lib.lammps_gather_atoms(h, b"x", 1, 3, buf)
    out["x15"] = np.frombuffer(buf, np.float64).reshape(256, 3).copy()
    lib.lammps_close(h)
    return out


def wave2(lib):
    out = {}
    h = open_(lib)
    lib.lammps_commands_string(h, b"""
units lj
atom_style atomic
region box block 0 10 0 10 0 10
create_box 1 box
mass 1 1.0
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0 2.5
""")
    n = 4
    ids = (ctypes.c_int * n)(4, 3, 2, 1)
    typ = (ctypes.c_int * n)(1, 1, 1, 1)
    pos = [1.0, 1.0, 1.0, 2.2, 1.0, 1.0, 1.0, 2.2, 1.0, 5.0, 5.0, 5.0]
    x = (ctypes.c_double * (3 * n))(*pos)
    v = (ctypes.c_double * (3 * n))(*([0.01] * 12))
    out["created"] = lib.lammps_create_atoms(h, n, ids, typ, x, v, None, 0)
    lib.lammps_commands_string(h, b"""
velocity all set 0.0 0.0 0.0
fix 1 all nve
variable a equal 3.0*2
variable nm string hello
compute t all temp
thermo_style custom step temp c_t pe
run 2
""")
    out["natoms"] = lib.lammps_get_natoms(h)
    buf = (ctypes.c_double * (3 * n))()
    lib.lammps_gather_atoms(h, b"x", 1, 3, buf)
    out["x"] = np.frombuffer(buf, np.float64).reshape(n, 3).copy()
    p = lib.lammps_extract_variable(h, b"a", None)
    out["a"] = dbl(p)
    lib.lammps_free(p)
    p = lib.lammps_extract_variable(h, b"nm", None)
    out["nm"] = ctypes.cast(p, ctypes.c_char_p).value
    lib.lammps_free(p)
    out["set"] = lib.lammps_set_variable(h, b"nm", b"world")
    p = lib.lammps_extract_variable(h, b"nm", None)
    out["nm2"] = ctypes.cast(p, ctypes.c_char_p).value
    lib.lammps_free(p)
    p = lib.lammps_extract_compute(h, b"t", 0, 0)
    out["t"] = dbl(p)
    out["temp"] = lib.lammps_get_thermo(h, b"temp")
    lo, hi = (ctypes.c_double * 3)(), (ctypes.c_double * 3)()
    xy, yz, xz = D(), D(), D()
    per, chg = (ctypes.c_int * 3)(), I()
    lib.lammps_extract_box(h, lo, hi, ctypes.byref(xy), ctypes.byref(yz),
                           ctypes.byref(xz), per, ctypes.byref(chg))
    out["box"] = (list(lo), list(hi), xy.value, yz.value, xz.value,
                  list(per), chg.value)
    out["settings"] = [lib.lammps_extract_setting(h, k) for k in (
        b"natoms", b"ntypes", b"triclinic", b"bogus", b"dimension",
        b"box_exist", b"nlocal", b"q_flag")]
    out["err0"] = lib.lammps_has_error(h)
    lib.lammps_command(h, b"bogus_command 1 2 3")
    out["err1"] = lib.lammps_has_error(h)
    msg = ctypes.create_string_buffer(256)
    out["msg_rc"] = lib.lammps_get_last_error_message(h, msg, 256)
    out["msg_has_cmd"] = b"bogus_command" in msg.value
    out["err2"] = lib.lammps_has_error(h)
    lib.lammps_close(h)
    return out


def fix_external(lib):
    out = {"seen": []}

    @FN
    def force_cb(caller, step, nlocal, ids, x, fext):
        out["seen"].append((int(step), int(nlocal)))
        for i in range(nlocal):
            fext[i][0], fext[i][1], fext[i][2] = 0.05, 0.0, -0.02

    h = open_(lib)
    lib.lammps_commands_string(h, DECK.replace(b"run 10", b"run 0")
                               + b"\nfix ext all external pf/callback 1 1\n")
    lib.lammps_set_fix_external_callback(h, b"ext",
                                         ctypes.cast(force_cb, P), None)
    lib.lammps_fix_external_set_energy_global(h, b"ext", 1.5)
    lib.lammps_command(h, b"run 10")
    p = lib.lammps_extract_fix(h, b"ext", 0, 0, 0, 0)
    out["energy"] = dbl(p)
    lib.lammps_free(p)
    buf = (ctypes.c_double * (256 * 3))()
    lib.lammps_gather_atoms(h, b"v", 1, 3, buf)
    out["v"] = np.frombuffer(buf, np.float64).reshape(256, 3).copy()
    fp = lib.lammps_fix_external_get_force(h, b"ext")
    rows = ctypes.cast(fp, ctypes.POINTER(DP))
    rows[0][0] = 0.1
    out["row0"] = rows[0][0]
    lib.lammps_close(h)
    return out


def wave3(lib):
    out = {}
    lmp = open_(lib)
    lib.lammps_commands_string(lmp, b"units lj\natom_style bond")
    out["styles"] = [lib.lammps_has_style(lmp, b"pair", s)
                     for s in (b"lj/cut", b"meam", b"nope")]
    out["npair_ge_40"] = lib.lammps_style_count(lmp, b"pair") >= 40
    buf = ctypes.create_string_buffer(64)
    out["name_rc"] = lib.lammps_style_name(lmp, b"pair", 0, buf, 64)
    out["name_nonempty"] = len(buf.value) > 0
    out["kspace"] = lib.lammps_config_has_package(b"KSPACE")
    out["npkg"] = lib.lammps_config_package_count()
    out["gzip"] = lib.lammps_config_has_gzip_support()
    img = lib.lammps_encode_image_flags(1, -2, 3)
    flags = (ctypes.c_int * 3)()
    lib.lammps_decode_image_flags(img, flags)
    out["flags"] = list(flags)
    for line in b"""lattice fcc 0.8442
region box block 0 4 0 4 0 4
create_box 1 box
create_atoms 1 box
mass 1 1.0
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0 2.5
fix f1 all nve
compute c1 all ke
variable alpha equal 1.5""".splitlines():
        lib.lammps_command(lmp, line)
    out["has_f1"] = lib.lammps_has_id(lmp, b"fix", b"f1")
    out["ncompute"] = lib.lammps_id_count(lmp, b"compute")
    lib.lammps_id_name(lmp, b"compute", 0, buf, 64)
    out["cname"] = buf.value
    lib.lammps_variable_info(lmp, 0, buf, 64)
    out["vname"] = buf.value
    ids = (ctypes.c_int * 2)(1, 3)
    sub = (ctypes.c_double * 6)()
    lib.lammps_gather_atoms_subset(lmp, b"x", 1, 3, 2, ids, sub)
    out["sub"] = list(sub)
    sub2 = (ctypes.c_double * 6)(*[v + 0.01 for v in sub])
    lib.lammps_scatter_atoms_subset(lmp, b"x", 1, 3, 2, ids, sub2)
    lib.lammps_gather_atoms_subset(lmp, b"x", 1, 3, 2, ids, sub)
    out["sub2"] = list(sub)
    mem = (ctypes.c_double * 3)()
    lib.lammps_memory_usage(lmp, mem)
    out["mem"] = mem[0] > 0
    lib.lammps_close(lmp)
    return out


def wave4(lib):
    out = {}
    h = open_(lib)
    lib.lammps_commands_string(h, DECK)
    out["dt_type"] = lib.lammps_extract_global_datatype(h, b"dt")
    out["dt"] = dbl(lib.lammps_extract_global(h, b"dt"))
    out["ts_type"] = lib.lammps_extract_global_datatype(h, b"ntimestep")
    out["ts"] = ctypes.cast(lib.lammps_extract_global(h, b"ntimestep"),
                            ctypes.POINTER(ctypes.c_int64))[0]
    out["bogus_type"] = lib.lammps_extract_global_datatype(h, b"bogus")
    out["atom_types"] = [lib.lammps_extract_atom_datatype(h, k)
                         for k in (b"x", b"type")]
    out["th_step"] = ctypes.cast(lib.lammps_last_thermo(h, b"step", 0),
                                 ctypes.POINTER(ctypes.c_int64))[0]
    nf = ctypes.cast(lib.lammps_last_thermo(h, b"num", 0),
                     ctypes.POINTER(ctypes.c_int))[0]
    out["th_num_ge_3"] = nf >= 3
    kw = lib.lammps_last_thermo(h, b"keyword", 0)
    out["th_kw"] = bool(ctypes.cast(kw, ctypes.c_char_p).value)
    idx = lib.lammps_find_pair_neighlist(h, b"lj/cut", 1, 0, 0)
    out["idx"] = idx
    out["eam_idx"] = lib.lammps_find_pair_neighlist(h, b"eam", 1, 0, 0)
    n = lib.lammps_neighlist_num_elements(h, idx)
    out["nelem"] = n
    iatom, numneigh = I(), I()
    neighbors = ctypes.POINTER(I)()
    lists = []
    for e in range(n):
        lib.lammps_neighlist_element_neighbors(
            h, idx, e, ctypes.byref(iatom), ctypes.byref(numneigh),
            ctypes.byref(neighbors))
        lists.append((iatom.value, sorted(neighbors[k]
                                          for k in range(numneigh.value))))
    out["lists"] = lists
    total = sum(len(js) for _, js in lists)
    out["per_atom_ok"] = 70 < 2 * total / n < 85
    buf = (ctypes.c_double * (256 * 3))()
    lib.lammps_gather(h, b"x", 1, 3, buf)
    out["gather"] = np.frombuffer(buf, np.float64).copy()
    lib.lammps_command(h, b"fix ext all external pf/array 1")
    lib.lammps_fix_external_set_vector_length(h, b"ext", 3)
    lib.lammps_fix_external_set_vector(h, b"ext", 2, 7.5)
    out["vec"] = dbl(lib.lammps_extract_fix(h, b"ext", 0, 1, 1, 0))
    out["api"] = lib.lammps_python_api_version()
    out["gpu"] = lib.lammps_has_gpu_device()
    out["plugins"] = lib.lammps_plugin_count() >= 0
    lib.lammps_close(h)
    return out


def same(a, b, path="", tol=1e-12):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=path)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            same(a[k], b[k], f"{path}.{k}", tol)
    elif isinstance(a, float) and isinstance(b, float):
        assert a == pytest.approx(b, rel=tol, abs=tol), path
    else:
        assert a == b, path


@pytest.mark.parametrize("scenario", [drive, wave2, fix_external, wave3,
                                      wave4], ids=lambda f: f.__name__)
def test_capi_against_tpumd(libs, scenario):
    got = scenario(libs["port"])
    want = scenario(libs["tpumd"])
    if scenario is wave4:
        # the device answer differs by design: the port reports a CUDA
        # card, tpumd a non-CPU JAX backend; neither has one here
        assert got.pop("gpu") == want.pop("gpu") == 0
    same(got, want)
    if scenario is drive:
        assert got["version"] == 20230802 and got["natoms"] == 256.0
        assert -8.0 < got["pe"] < -4.0 and got["step"] == 15.0
    if scenario is wave2:
        assert got["x"][3, 0] == pytest.approx(1.0, abs=0.2)
        assert (got["a"], got["nm"], got["nm2"]) == (6.0, b"hello",
                                                     b"world")
        assert got["err1"] == 1 and got["err2"] == 0
    if scenario is fix_external:
        assert [s for s, _ in got["seen"]][:3] == [0, 1, 2]
        assert got["energy"] == 1.5


def test_port_shim_keeps_one_array_a_key(libs):
    """A driver that gathers and extracts x every step holds one host copy
    of x, not one a call: gathers are copied out and not kept, extract_atom
    keeps its latest array under its name."""
    from tpumd_torch.capi import bridge
    lib = libs["port"]
    h = open_(lib)
    lib.lammps_commands_string(h, DECK)
    hid = max(bridge._instances)
    buf = (ctypes.c_double * (3 * 256))()
    for _ in range(5):
        lib.lammps_command(h, b"run 1")
        lib.lammps_gather_atoms(h, b"x", 1, 3, buf)
        rows = ctypes.cast(lib.lammps_extract_atom(h, b"x"),
                           ctypes.POINTER(DP))
    assert list(bridge._buffers[hid]) == [("atom", "x")]
    kept = bridge._buffers[hid][("atom", "x")]
    assert [rows[7][k] for k in range(3)] == kept[7].tolist()
    lib.lammps_close(h)
    assert hid not in bridge._buffers


def test_fortran_bindings_in_port_shim(libs):
    f90 = open(os.path.join(ROOT, "fortran", "tpumd.f90")).read()
    csrc = open(SRC).read()
    bound = set(re.findall(r"bind\(c, name='(\w+)'\)", f90))
    assert len(bound) >= 10
    for sym in bound:
        assert re.search(rf"\b{sym}\s*\(", csrc), sym
        assert hasattr(libs["port"], sym), sym


def test_port_imports_neither_tpumd_nor_jax():
    pat = re.compile(r"^\s*(import|from)\s+(tpumd|jax)\b(?!_torch)",
                     re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "tpumd_torch")):
        files += [os.path.join(base, n) for n in names
                  if n.endswith((".py", ".c"))]
    bad = [f for f in files if pat.search(open(f).read())]
    assert not bad
    assert '"tpumd_torch.capi.bridge"' in open(SRC).read()

"""Python side of the port's C API shim (tpumd_capi.c beside this file; the
port of tpumd/capi/bridge.py).

Keeps a registry of embedded ``tpumd_torch.api.TpuMD`` instances addressed
by integer handles; every C ``lammps_*`` call forwards here.  Mirrors the
contract of the reference C library (src/library.h:123-253,
src/library.cpp).  ``lammps_open_no_mpi``'s arguments take the command
line's ``--device cpu|cuda`` (cuda by default) and ``--dtype f32|f64`` (f32
by default).  Arrays handed to C are host copies, never pointers into
device memory.  Those whose pointer C hands on (extract_atom,
extract_compute, extract_global, last_thermo, the neighbour rows, fix
external's force) are kept, one for each handle and key, until the next
call of that key or the handle's close, as the reference's pointers into
its own storage stay valid until it changes; those that C copies out at
once (the gathers, extract_fix, extract_variable) are not kept."""

from __future__ import annotations

import numpy as np

_instances: dict[int, object] = {}
_next = [1]
_buffers: dict[int, dict] = {}   # per handle: key -> the kept host array


def _open_args(cmdargs):
    """(device, dtype) from lammps_open's arguments; the other flags of
    the command line are accepted and ignored."""
    import torch
    args = list(cmdargs or [])
    device, dtype = "cuda", torch.float32
    for i, a in enumerate(args[:-1]):
        if a == "--device":
            device = args[i + 1]
        elif a == "--dtype":
            dtype = torch.float64 if args[i + 1] == "f64" else torch.float32
    if device not in ("cpu", "cuda"):
        raise ValueError(f"--device {device}: cpu or cuda")
    return device, dtype


def open_instance(cmdargs=None) -> int:
    from tpumd_torch.api import TpuMD
    device, dtype = _open_args(cmdargs)
    h = _next[0]
    _next[0] += 1
    _instances[h] = TpuMD(device=device, dtype=dtype)
    _buffers[h] = {}
    return h


def close_instance(h: int):
    _instances.pop(h, None)
    _buffers.pop(h, None)


def command(h: int, cmd: str):
    _instances[h].command(cmd)


def commands_string(h: int, text: str):
    _instances[h].commands_string(text)


def file(h: int, path: str):
    _instances[h].file(path)


def get_natoms(h: int) -> float:
    return float(_instances[h].get_natoms())


def get_thermo(h: int, name: str) -> float:
    return float(_instances[h].get_thermo(name))


def extract_global(h: int, name: str):
    """Returns (kind, value): kind 0 = double scalar, 1 = int scalar."""
    lmp = _instances[h]
    sim = lmp.sim
    lo, hi = lmp.extract_box()
    vals = {
        "dt": (0, float(sim.dt)),
        "natoms": (1, int(sim.natoms)),
        "ntypes": (1, int(sim.ntypes)),
        "ntimestep": (1, int(sim.step)),
        **{f"box{c}lo": (0, float(lo[k])) for k, c in enumerate("xyz")},
        **{f"box{c}hi": (0, float(hi[k])) for k, c in enumerate("xyz")},
    }
    if name not in vals:
        raise KeyError(name)
    return vals[name]


def _c_array(arr):
    """A per-atom array as C reads it: doubles or 32-bit ints, whatever the
    run's dtype (an f32 run's positions are widened)."""
    arr = np.asarray(arr)
    return np.ascontiguousarray(
        arr, np.float64 if arr.dtype.kind == "f" else np.int32)


def extract_atom(h: int, name: str):
    """Returns a C-contiguous host copy, kept until the next extract_atom
    of name or the handle's close; the C side wraps (N,3) arrays in a
    row-pointer table."""
    arr = _c_array(_instances[h].extract_atom(name))
    return _pin(h, ("atom", name), arr)


def gather_atoms(h: int, name: str):
    """A host copy in tag order, which C copies into the caller's buffer
    before it returns."""
    return _c_array(_instances[h].gather_atoms(name))


def scatter_atoms(h: int, name: str, arr):
    _instances[h].scatter_atoms(name, np.asarray(arr))


def run(h: int, nsteps: int):
    _instances[h].run(int(nsteps))


def version() -> int:
    return 20230802  # parity contract: reference LAMMPS_VERSION "2 Aug 2023"


# --------------------------------------------------------------- wave 2
# computes / fixes / variables / box / settings / create_atoms / errors
# (src/library.h:123-253).  An array whose pointer C hands out is kept
# under its key (replacing the key's previous one) so the pointer stays
# valid until the next call of that key.

def _pin(h, key, arr):
    arr = np.ascontiguousarray(arr)
    _buffers[h][key] = arr
    return arr


def extract_compute(h: int, cid: str, style: int, type: int):
    """Returns a float (global scalar) or a pinned double array."""
    out = _instances[h].extract_compute(cid, style, type)
    if isinstance(out, float):
        return out
    return _pin(h, ("compute", cid, style, type),
                np.asarray(out, dtype=np.float64))


def extract_fix(h: int, fid: str, style: int, type: int,
                nrow: int, ncol: int):
    """A float or a double array, which C copies into memory the caller
    frees."""
    out = _instances[h].extract_fix(fid, style, type, nrow, ncol)
    if isinstance(out, float):
        return out
    return np.ascontiguousarray(out, dtype=np.float64)


def extract_variable(h: int, name: str):
    """Returns (kind, value): kind 0 = double, 1 = string, 2 = array (C
    copies each into memory the caller frees)."""
    out = _instances[h].extract_variable(name)
    if isinstance(out, str):
        return (1, out)
    if isinstance(out, float):
        return (0, out)
    return (2, np.ascontiguousarray(out, dtype=np.float64))


def set_variable(h: int, name: str, value: str) -> int:
    return _instances[h].set_variable(name, value)


def extract_box(h: int):
    lo, hi, xy, yz, xz, per, change = _instances[h].extract_box_full()
    return ([float(v) for v in lo], [float(v) for v in hi],
            xy, yz, xz, per, change)


def reset_box(h: int, boxlo, boxhi, xy: float, yz: float, xz: float):
    _instances[h].reset_box(list(boxlo), list(boxhi), xy, yz, xz)


def extract_setting(h: int, name: str) -> int:
    return _instances[h].extract_setting(name)


def create_atoms(h: int, n: int, ids, types, x, v) -> int:
    ids = None if ids is None else np.asarray(ids, np.int64)
    v = None if v is None else np.asarray(v, np.float64)
    return _instances[h].create_atoms(
        int(n), ids, np.asarray(types, np.int64), np.asarray(x, np.float64),
        v)


def has_error(h: int) -> int:
    return int(_instances[h].has_error())


def get_last_error_message(h: int) -> str:
    return _instances[h].get_last_error_message()


def command_noraise(h: int, cmd: str) -> int:
    """command() that records the error instead of propagating (the C
    library contract: caller polls lammps_has_error)."""
    try:
        _instances[h].command(cmd)
        return 0
    except Exception:  # noqa: BLE001  (recorded in script.last_error)
        return -1


# ----------------------------------------------------------- fix external
def fix_external_get_force(h: int, fid: str):
    return _instances[h].fix_external_get_force(fid)


def fix_external_set_energy_global(h: int, fid: str, eng: float):
    _instances[h].fix_external_set_energy_global(fid, eng)


def fix_external_set_virial_global(h: int, fid: str, virial):
    _instances[h].fix_external_set_virial_global(fid, list(virial))


def set_fix_external_callback_addr(h: int, fid: str, fnaddr: int,
                                   calleraddr: int):
    """Register a C callback by raw function-pointer address.  Signature
    (src/library.h FixExternalFnPtr):
        void (*)(void *caller, int64 step, int nlocal,
                 int32 *ids, double **x, double **fexternal)
    The row-pointer tables are built per call via ctypes."""
    import ctypes

    FN = ctypes.CFUNCTYPE(
        None, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)))
    cfn = FN(fnaddr)
    caller = ctypes.c_void_p(calleraddr) if calleraddr else None

    def pyfn(caller_ignored, step, nlocal, ids, x, fext):
        ids = np.ascontiguousarray(ids, dtype=np.int32)
        x = np.ascontiguousarray(x, dtype=np.float64)
        idp = ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        dp = ctypes.POINTER(ctypes.c_double)
        xrows = (dp * nlocal)(*[
            ctypes.cast(x.ctypes.data + 24 * i, dp) for i in range(nlocal)])
        frows = (dp * nlocal)(*[
            ctypes.cast(fext.ctypes.data + 24 * i, dp)
            for i in range(nlocal)])
        cfn(caller, step, nlocal, idp, xrows, frows)

    _instances[h].set_fix_external_callback(fid, pyfn, caller=None)


# --------------------------------------------------------------- wave 3
def commands_list(h: int, cmds):
    for c in cmds:
        _instances[h].command(c)


def is_running(h: int) -> int:
    return 0   # library calls are only possible between runs here


def force_timeout(h: int):
    # Timer::force_timeout analog: next run stops at its first segment
    _instances[h].sim.timer_timeout = 0.0


def memory_usage(h: int):
    import resource
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024.0
    return [rss, rss, rss]


def get_os_info() -> str:
    import platform
    return f"{platform.system()} {platform.release()} {platform.machine()}"


_PACKAGES = ("KSPACE", "MOLECULE", "RIGID", "GRANULAR", "MANYBODY",
             "MEAM", "REPLICA", "CLASS2", "EXTRA-PAIR", "EXTRA-COMPUTE",
             "EXTRA-FIX", "COMPRESS")


def config_has_package(name: str) -> int:
    return int(name in _PACKAGES)


def config_package_count() -> int:
    return len(_PACKAGES)


def config_package_name(idx: int) -> str:
    return _PACKAGES[idx] if 0 <= idx < len(_PACKAGES) else ""


def _style_table(category: str):
    from tpumd_torch.models import registry
    # the style modules register at their import, which the factories
    # trigger
    try:
        registry.create_pair_style("", 1, ())
    except NotImplementedError:
        pass
    if category in registry._BONDED_STYLES:
        try:
            registry.create_bonded_style(category, "", (), 1)
        except NotImplementedError:
            pass
        return registry._BONDED_STYLES[category]
    if category == "pair":
        return registry._PAIR_STYLES
    if category == "atom":
        from tpumd_torch.core.atomvec import STYLES
        return STYLES
    return {}


def has_style(h: int, category: str, name: str) -> int:
    return int(name in _style_table(category))


def style_count(h: int, category: str) -> int:
    return len(_style_table(category))


def style_name(h: int, category: str, idx: int) -> str:
    names = sorted(_style_table(category))
    return names[idx] if 0 <= idx < len(names) else ""


def _ids(h: int, category: str):
    lmp = _instances[h]
    sim = lmp.sim
    script = sim.script
    if category == "fix":
        return [getattr(fx, "id", "") for fx in sim.fixes]
    if category == "compute":
        return list(sim.computes)
    if category == "group":
        return list(sim.groups)
    if category == "region":
        return list(script.regions) if script else []
    if category == "variable":
        return list(script.variables) if script else []
    if category == "dump":
        return [d.id for d in sim.dumps]
    if category == "molecule":
        return list(sim.molecules)
    return []


def has_id(h: int, category: str, name: str) -> int:
    return int(name in _ids(h, category))


def id_count(h: int, category: str) -> int:
    return len(_ids(h, category))


def id_name(h: int, category: str, idx: int) -> str:
    ids = _ids(h, category)
    return ids[idx] if 0 <= idx < len(ids) else ""


def variable_info(h: int, idx: int):
    """(name, style-string) of the idx-th defined variable."""
    script = _instances[h].sim.script
    names = list(script.variables)
    if not 0 <= idx < len(names):
        return ("", "")
    name = names[idx]
    return (name, script.variables[name][0])


def gather_tuples(h: int, kind: str):
    """Flat int32 [type a1 a2 ...] rows (lammps_gather_bonds/angles/
    dihedrals/impropers, src/library.cpp)."""
    sim = _instances[h]._ready()
    arr = sim.topology.get(kind)
    if arr is None:
        out = np.zeros((0,), np.int32)
    else:
        out = np.ascontiguousarray(np.asarray(arr), np.int32).reshape(-1)
    return out, int(0 if arr is None else len(arr))


def _ready(h: int):
    lmp = _instances[h]
    lmp._ready()
    return lmp


# --------------------------------------------------------------- wave 4
# neighbor-list access, generic gather/scatter, last_thermo, datatype
# queries, plugin info, fix-external per-atom/vector channels
# (src/library.h:152-258).

# LAMMPS C library datatype constants (src/library.h:48-55)
LAMMPS_NONE, LAMMPS_INT, LAMMPS_INT_2D = -1, 0, 1
LAMMPS_DOUBLE, LAMMPS_DOUBLE_2D = 2, 3
LAMMPS_INT64, LAMMPS_INT64_2D, LAMMPS_STRING = 4, 5, 6

_ATOM_DTYPES = {
    "x": LAMMPS_DOUBLE_2D, "v": LAMMPS_DOUBLE_2D, "f": LAMMPS_DOUBLE_2D,
    "omega": LAMMPS_DOUBLE_2D, "torque": LAMMPS_DOUBLE_2D,
    "mu": LAMMPS_DOUBLE_2D,
    "q": LAMMPS_DOUBLE, "radius": LAMMPS_DOUBLE, "rmass": LAMMPS_DOUBLE,
    "mass": LAMMPS_DOUBLE,
    "type": LAMMPS_INT, "mask": LAMMPS_INT, "tag": LAMMPS_INT,
    "id": LAMMPS_INT, "molecule": LAMMPS_INT, "image": LAMMPS_INT,
}

_GLOBAL_DTYPES = {
    "dt": LAMMPS_DOUBLE, "natoms": LAMMPS_INT64, "ntypes": LAMMPS_INT,
    "ntimestep": LAMMPS_INT64,
    "boxxlo": LAMMPS_DOUBLE, "boxylo": LAMMPS_DOUBLE,
    "boxzlo": LAMMPS_DOUBLE, "boxxhi": LAMMPS_DOUBLE,
    "boxyhi": LAMMPS_DOUBLE, "boxzhi": LAMMPS_DOUBLE,
}


def extract_atom_datatype(h: int, name: str) -> int:
    return _ATOM_DTYPES.get(name, LAMMPS_NONE)


def extract_global_datatype(h: int, name: str) -> int:
    return _GLOBAL_DTYPES.get(name, LAMMPS_NONE)


def extract_variable_datatype(h: int, name: str) -> int:
    try:
        out = _instances[h].extract_variable(name)
    except Exception:  # noqa: BLE001
        return LAMMPS_NONE
    if isinstance(out, str):
        return LAMMPS_STRING
    if isinstance(out, float):
        return LAMMPS_DOUBLE
    return LAMMPS_DOUBLE   # atom-style variables eval to double arrays


def extract_global_typed(h: int, name: str):
    """A kept 1-element array matching the declared datatype (the C side
    hands out its data pointer)."""
    kind, value = extract_global(h, name)
    dt = _GLOBAL_DTYPES.get(name)
    np_dt = {LAMMPS_DOUBLE: np.float64, LAMMPS_INT: np.int32,
             LAMMPS_INT64: np.int64}[dt]
    return _pin(h, ("global", name), np.asarray([value], np_dt))


def python_api_version() -> int:
    return 2


def get_mpi_comm(h: int) -> int:
    return -1   # no MPI support (lammps_get_mpi_comm contract)


def has_gpu_device() -> int:
    import torch
    return int(torch.cuda.is_available())


def get_gpu_device_info() -> str:
    import torch
    if not torch.cuda.is_available():
        return ""
    return "\n".join(f"Device {i}: {torch.cuda.get_device_name(i)} (cuda)"
                     for i in range(torch.cuda.device_count()))


def _all_plugins():
    out = []
    for lmp in _instances.values():
        sc = getattr(lmp.sim, "script", None)
        out.extend(getattr(sc, "_plugins", {}) if sc else [])
    return out


def plugin_count() -> int:
    return len(_all_plugins())


def plugin_name(idx: int):
    """(style, name) of the idx-th loaded plugin."""
    plugins = _all_plugins()
    if not 0 <= idx < len(plugins):
        return ("", "")
    return ("python", plugins[idx])


# last_thermo: {step,num,keyword,type,data} views over the cached thermo
# row (src/library.cpp:857 lammps_last_thermo)
def last_thermo(h: int, what: str, idx: int):
    sim = _instances[h].sim
    row = getattr(sim, "last_thermo", None) or {}
    keys = [k for k in row if np.isscalar(row[k]) or np.ndim(row[k]) == 0]
    key = ("thermo", what, idx)
    if what == "step":
        return _pin(h, key, np.asarray([int(sim.step)], np.int64))
    if what == "num":
        return _pin(h, key, np.asarray([len(keys)], np.int32))
    if what == "keyword":
        return keys[idx] if 0 <= idx < len(keys) else None
    if what == "type":
        if not 0 <= idx < len(keys):
            return None
        isint = keys[idx] in ("step", "elapsed", "atoms")
        return _pin(h, key, np.asarray(
            [LAMMPS_INT64 if isint else LAMMPS_DOUBLE], np.int32))
    if what == "data":
        if not 0 <= idx < len(keys):
            return None
        val = row[keys[idx]]
        if keys[idx] in ("step", "elapsed", "atoms"):
            return _pin(h, key, np.asarray([int(val)], np.int64))
        return _pin(h, key, np.asarray([float(val)], np.float64))
    return None


# generic gather/scatter: same per-atom properties as gather_atoms (the
# reference's lammps_gather family also handles fix/compute/custom
# properties; per-atom extras registered through the AtomVec field
# registry are resolved by gather_atoms already)
def gather(h: int, name: str):
    return gather_atoms(h, name)


def gather_concat(h: int, name: str):
    return gather_atoms(h, name)


def gather_subset(h: int, name: str, ids):
    return gather_atoms_subset(h, name, ids)


def scatter(h: int, name: str, arr):
    scatter_atoms(h, name, arr)


def scatter_subset(h: int, name: str, ids, arr):
    scatter_atoms_subset(h, name, ids, arr)


# ------------------------------------------------- neighbor-list access
_neigh_cache: dict = {}


def _neighlist(h: int):
    sim = _instances[h].sim
    key = (h, int(sim.step), int(sim.natoms))
    cached = _neigh_cache.get(h)
    if cached is not None and cached[0] == key:
        return cached[1]
    lists = _instances[h].neighlist_half()
    _neigh_cache[h] = (key, lists)
    return lists


def find_pair_neighlist(h: int, style: str, exact: int, nsub: int,
                        request: int) -> int:
    sim = _instances[h].sim
    if sim.pair is None:
        return -1
    pname = getattr(sim.pair, "name", "")
    if exact:
        ok = pname == style
    else:
        ok = style in pname
    return 0 if ok else -1


def find_fix_neighlist(h: int, fid: str, request: int) -> int:
    return -1   # no fix owns a separate request here


def find_compute_neighlist(h: int, cid: str, request: int) -> int:
    return -1


def neighlist_num_elements(h: int, idx: int) -> int:
    if idx != 0:
        return -1
    return len(_neighlist(h))


def neighlist_element_neighbors(h: int, idx: int, element: int):
    """(iatom, kept int32 neighbor array) or (-1, empty)."""
    lists = _neighlist(h)
    key = ("neighbors", idx, element)
    if idx != 0 or not 0 <= element < len(lists):
        return (-1, _pin(h, key, np.zeros((0,), np.int32)))
    i, js = lists[element]
    return (int(i), _pin(h, key, np.ascontiguousarray(js, np.int32)))


# -------------------------------------------- fix external wave-4 extras
def fix_external_set_energy_peratom(h: int, fid: str, eatom):
    _instances[h].fix_external_set_energy_peratom(fid, eatom)


def fix_external_set_virial_peratom(h: int, fid: str, vatom):
    _instances[h].fix_external_set_virial_peratom(fid, vatom)


def fix_external_set_vector_length(h: int, fid: str, n: int):
    _instances[h].fix_external_set_vector_length(fid, n)


def fix_external_set_vector(h: int, fid: str, idx: int, val: float):
    _instances[h].fix_external_set_vector(fid, idx, val)


def gather_atoms_subset(h: int, name: str, ids):
    _ready(h)
    a = np.asarray(gather_atoms(h, name))   # tag order; (n,3) or (n,)
    idx = np.asarray(ids, np.int64) - 1
    return np.ascontiguousarray(a[idx]).reshape(-1)


def scatter_atoms_subset(h: int, name: str, ids, arr):
    lmp = _ready(h)
    cur = np.asarray(gather_atoms(h, name)).copy()
    idx = np.asarray(ids, np.int64) - 1
    vals = np.asarray(arr)
    cur[idx] = vals.reshape((len(idx),) + cur.shape[1:])
    scatter_atoms(h, name, cur)

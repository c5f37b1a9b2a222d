/* The port's C API shim: drop-in `lammps_*` symbols (those of
 * src/library.h:123-253 that calling programs use, and every symbol that
 * fortran/tpumd.f90 binds) backed by the embedded Python engine through
 * tpumd_torch/capi/bridge.py; the port of tpumd/capi/tpumd_capi.c.
 *
 * Build:  python tpumd_torch/capi/build.py
 *         -> build/tpumd_torch/libtpumd_torch-<source hash>.so
 * Usage from C mirrors the reference:
 *     char *args[] = {"lmp", "--device", "cuda"};
 *     void *lmp = lammps_open_no_mpi(3, args, NULL);
 *     lammps_command(lmp, "units lj");
 *     double n = lammps_get_natoms(lmp);
 *     lammps_close(lmp);
 * The arguments take --device cpu|cuda (cuda by default) and --dtype
 * f32|f64 (f32 by default).  Loaded into a process that already runs
 * Python (a ctypes caller), the shim reuses that interpreter through
 * PyGILState; it starts one only in a process that has none.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

static PyObject *bridge = NULL;
static int we_initialized = 0;

typedef struct {
    long handle;
    /* row-pointer tables and scalars handed out by extract_* (freed at
     * close); one for each key, replaced by the next call of that key */
    void **rowtabs;
    char **rowkeys;
    int nrowtabs;
} tpumd_handle;

static int ensure_python(void) {
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
        we_initialized = 1;
    }
    return 1;
}

static PyObject *get_bridge(void) {
    if (bridge == NULL) {
        bridge = PyImport_ImportModule("tpumd_torch.capi.bridge");
        if (bridge == NULL) {
            PyErr_Print();
            fprintf(stderr, "tpumd_capi: cannot import "
                            "tpumd_torch.capi.bridge (is tpumd_torch on "
                            "PYTHONPATH?)\n");
        }
    }
    return bridge;
}

#define ENTER PyGILState_STATE gst; ensure_python(); gst = PyGILState_Ensure()
#define LEAVE PyGILState_Release(gst)

static PyObject *callb(const char *fn, const char *fmt, ...) {
    PyObject *b = get_bridge();
    if (!b) return NULL;
    PyObject *func = PyObject_GetAttrString(b, fn);
    if (!func) { PyErr_Print(); return NULL; }
    va_list va;
    va_start(va, fmt);
    PyObject *args = Py_VaBuildValue(fmt, va);
    va_end(va);
    PyObject *out = PyObject_CallObject(func, args);
    Py_XDECREF(args);
    Py_DECREF(func);
    if (!out) PyErr_Print();
    return out;
}

void *lammps_open_no_mpi(int argc, char **argv, void **ptr) {
    ENTER;
    /* the arguments as a list of str (--device, --dtype) */
    PyObject *args = PyList_New(0);
    for (int i = 0; i < argc && argv; i++) {
        PyObject *a = PyUnicode_FromString(argv[i]);
        if (a) { PyList_Append(args, a); Py_DECREF(a); }
    }
    PyObject *out = callb("open_instance", "(O)", args);
    Py_DECREF(args);
    tpumd_handle *h = NULL;
    if (out) {
        h = (tpumd_handle *)calloc(1, sizeof(tpumd_handle));
        h->handle = PyLong_AsLong(out);
        Py_DECREF(out);
    }
    LEAVE;
    if (ptr) *ptr = h;
    return h;
}

void lammps_close(void *handle) {
    tpumd_handle *h = (tpumd_handle *)handle;
    if (!h) return;
    ENTER;
    PyObject *out = callb("close_instance", "(l)", h->handle);
    Py_XDECREF(out);
    LEAVE;
    for (int i = 0; i < h->nrowtabs; i++) {
        free(h->rowtabs[i]);
        free(h->rowkeys[i]);
    }
    free(h->rowtabs);
    free(h->rowkeys);
    free(h);
}

void lammps_command(void *handle, const char *cmd) {
    tpumd_handle *h = (tpumd_handle *)handle;
    ENTER;
    /* the C library contract records the error for lammps_has_error
     * rather than propagating (src/library.cpp try/catch blocks) */
    PyObject *out = callb("command_noraise", "(ls)", h->handle, cmd);
    Py_XDECREF(out);
    LEAVE;
}

void lammps_commands_string(void *handle, const char *str) {
    tpumd_handle *h = (tpumd_handle *)handle;
    ENTER;
    PyObject *out = callb("commands_string", "(ls)", h->handle, str);
    Py_XDECREF(out);
    LEAVE;
}

void lammps_file(void *handle, const char *path) {
    tpumd_handle *h = (tpumd_handle *)handle;
    ENTER;
    PyObject *out = callb("file", "(ls)", h->handle, path);
    Py_XDECREF(out);
    LEAVE;
}

double lammps_get_natoms(void *handle) {
    tpumd_handle *h = (tpumd_handle *)handle;
    double n = -1.0;
    ENTER;
    PyObject *out = callb("get_natoms", "(l)", h->handle);
    if (out) { n = PyFloat_AsDouble(out); Py_DECREF(out); }
    LEAVE;
    return n;
}

double lammps_get_thermo(void *handle, const char *name) {
    tpumd_handle *h = (tpumd_handle *)handle;
    double v = 0.0;
    ENTER;
    PyObject *out = callb("get_thermo", "(ls)", h->handle, name);
    if (out) { v = PyFloat_AsDouble(out); Py_DECREF(out); }
    LEAVE;
    return v;
}

int lammps_version(void *handle) {
    (void)handle;
    int v = 0;
    ENTER;
    PyObject *out = callb("version", "()");
    if (out) { v = (int)PyLong_AsLong(out); Py_DECREF(out); }
    LEAVE;
    return v;
}

/* keep a table handed out under key alive on the handle until the next
 * call with the same key (which frees it) or lammps_close: the contract of
 * the reference's pointers into its own storage, and a handle that extracts
 * every step holds one table a key, not one a call */
static void *remember_rowtab(tpumd_handle *h, const char *key, void *tab) {
    for (int i = 0; i < h->nrowtabs; i++) {
        if (!strcmp(h->rowkeys[i], key)) {
            free(h->rowtabs[i]);
            h->rowtabs[i] = tab;
            return tab;
        }
    }
    h->rowtabs = (void **)realloc(h->rowtabs,
                                  (h->nrowtabs + 1) * sizeof(void *));
    h->rowkeys = (char **)realloc(h->rowkeys,
                                  (h->nrowtabs + 1) * sizeof(char *));
    h->rowkeys[h->nrowtabs] = strdup(key);
    h->rowtabs[h->nrowtabs++] = tab;
    return tab;
}

/* numpy array -> raw data pointer + shape via the buffer protocol */
static void *array_data(PyObject *arr, Py_ssize_t *n0, Py_ssize_t *n1) {
    Py_buffer view;
    if (PyObject_GetBuffer(arr, &view, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT))
        { PyErr_Print(); return NULL; }
    if (n0) *n0 = view.ndim > 0 ? view.shape[0] : 0;
    if (n1) *n1 = view.ndim > 1 ? view.shape[1] : 0;
    void *data = view.buf;
    PyBuffer_Release(&view);   /* the bridge keeps the array, or the caller
                                  copies it out while it holds it */
    return data;
}

/* lammps_extract_atom: (N,3) doubles -> double** row table; (N,) -> ptr.
 * The buffer is a HOST COPY of the live atoms' rows in the engine's
 * current order (the grid's slots change at every re-bin), kept until the
 * next lammps_extract_atom of that name or lammps_close: it is never
 * device memory, and writing into it changes nothing (lammps_scatter_atoms
 * edits the atoms). */
void *lammps_extract_atom(void *handle, const char *name) {
    tpumd_handle *h = (tpumd_handle *)handle;
    void *result = NULL;
    ENTER;
    PyObject *out = callb("extract_atom", "(ls)", h->handle, name);
    if (out) {
        Py_ssize_t n0 = 0, n1 = 0;
        void *data = array_data(out, &n0, &n1);
        Py_DECREF(out);        /* bridge holds a reference */
        if (data && n1 == 3) {
            char key[256];
            double **rows = (double **)malloc(n0 * sizeof(double *));
            for (Py_ssize_t i = 0; i < n0; i++)
                rows[i] = (double *)data + 3 * i;
            snprintf(key, sizeof key, "atom/%s", name);
            result = remember_rowtab(h, key, rows);
        } else {
            result = data;
        }
    }
    LEAVE;
    return result;
}

/* simplified gather/scatter: full arrays in tag order, double or int */
void lammps_gather_atoms(void *handle, const char *name, int type,
                         int count, void *data) {
    tpumd_handle *h = (tpumd_handle *)handle;
    ENTER;
    PyObject *out = callb("gather_atoms", "(ls)", h->handle, name);
    if (out) {
        Py_buffer view;
        if (!PyObject_GetBuffer(out, &view, PyBUF_C_CONTIGUOUS)) {
            memcpy(data, view.buf, view.len);
            PyBuffer_Release(&view);
        } else {
            PyErr_Print();
        }
        Py_DECREF(out);
    }
    (void)type; (void)count;
    LEAVE;
}

/* ---------------------------------------------------------------------
 * wave 2: computes / fixes / variables / box / settings / create_atoms /
 * error state / fix external (src/library.h:123-253 contracts)
 * ------------------------------------------------------------------- */

/* build a double** row table over a kept (N,W) array, kept under key */
static void *rows_over(tpumd_handle *h, const char *key, void *data,
                       Py_ssize_t n0, Py_ssize_t w) {
    double **rows = (double **)malloc(n0 * sizeof(double *));
    for (Py_ssize_t i = 0; i < n0; i++)
        rows[i] = (double *)data + w * i;
    return remember_rowtab(h, key, rows);
}

/* unwrap: float -> handle-owned malloc'd double; array -> kept data
 * pointer (double** rows when 2-D) */
static void *unwrap_numeric(tpumd_handle *h, const char *key, PyObject *out,
                            int want_rows) {
    void *result = NULL;
    if (PyFloat_Check(out) || PyLong_Check(out)) {
        double *p = (double *)malloc(sizeof(double));
        *p = PyFloat_AsDouble(out);
        result = remember_rowtab(h, key, p);
    } else {
        Py_ssize_t n0 = 0, n1 = 0;
        void *data = array_data(out, &n0, &n1);
        if (data && n1 > 0 && want_rows)
            result = rows_over(h, key, data, n0, n1);
        else
            result = data;
    }
    return result;
}

void *lammps_extract_compute(void *handle, const char *id, int style,
                             int type) {
    tpumd_handle *h = (tpumd_handle *)handle;
    void *result = NULL;
    ENTER;
    PyObject *out = callb("extract_compute", "(lsii)", h->handle, id,
                          style, type);
    if (out) {
        char key[256];
        snprintf(key, sizeof key, "compute/%s/%d/%d", id, style, type);
        result = unwrap_numeric(h, key, out, type == 2);
        Py_DECREF(out);
    }
    LEAVE;
    return result;
}

/* reference: global fix data is malloc'd, caller frees via lammps_free */
void *lammps_extract_fix(void *handle, const char *id, int style, int type,
                         int nrow, int ncol) {
    tpumd_handle *h = (tpumd_handle *)handle;
    void *result = NULL;
    ENTER;
    PyObject *out = callb("extract_fix", "(lsiiii)", h->handle, id, style,
                          type, nrow, ncol);
    if (out) {
        if (PyFloat_Check(out) || PyLong_Check(out)) {
            double *p = (double *)malloc(sizeof(double));
            *p = PyFloat_AsDouble(out);
            result = p;
        } else {
            Py_ssize_t n0 = 0, n1 = 0;
            void *data = array_data(out, &n0, &n1);
            if (data) {
                size_t bytes = (size_t)n0 * (n1 ? n1 : 1) * sizeof(double);
                double *p = (double *)malloc(bytes);
                memcpy(p, data, bytes);
                result = p;
            }
        }
        Py_DECREF(out);
    }
    LEAVE;
    return result;
}

/* equal-style -> malloc'd double* (caller frees); string -> strdup;
 * atom-style -> malloc'd double array */
void *lammps_extract_variable(void *handle, const char *name,
                              const char *group) {
    tpumd_handle *h = (tpumd_handle *)handle;
    void *result = NULL;
    (void)group;
    ENTER;
    PyObject *out = callb("extract_variable", "(ls)", h->handle, name);
    if (out) {
        long kind = PyLong_AsLong(PyTuple_GetItem(out, 0));
        PyObject *val = PyTuple_GetItem(out, 1);
        if (kind == 0) {
            double *p = (double *)malloc(sizeof(double));
            *p = PyFloat_AsDouble(val);
            result = p;
        } else if (kind == 1) {
            result = strdup(PyUnicode_AsUTF8(val));
        } else {
            Py_ssize_t n0 = 0, n1 = 0;
            void *data = array_data(val, &n0, &n1);
            if (data) {
                size_t bytes = (size_t)n0 * sizeof(double);
                double *p = (double *)malloc(bytes);
                memcpy(p, data, bytes);
                result = p;
            }
        }
        Py_DECREF(out);
    }
    LEAVE;
    return result;
}

int lammps_set_variable(void *handle, const char *name, const char *str) {
    tpumd_handle *h = (tpumd_handle *)handle;
    int rc = -1;
    ENTER;
    PyObject *out = callb("set_variable", "(lss)", h->handle, name, str);
    if (out) { rc = (int)PyLong_AsLong(out); Py_DECREF(out); }
    LEAVE;
    return rc;
}

void lammps_extract_box(void *handle, double *boxlo, double *boxhi,
                        double *xy, double *yz, double *xz,
                        int *periodicity, int *box_change) {
    tpumd_handle *h = (tpumd_handle *)handle;
    ENTER;
    PyObject *out = callb("extract_box", "(l)", h->handle);
    if (out) {
        PyObject *lo = PyTuple_GetItem(out, 0);
        PyObject *hi = PyTuple_GetItem(out, 1);
        for (int i = 0; i < 3; i++) {
            if (boxlo) boxlo[i] =
                PyFloat_AsDouble(PyList_GetItem(lo, i));
            if (boxhi) boxhi[i] =
                PyFloat_AsDouble(PyList_GetItem(hi, i));
        }
        if (xy) *xy = PyFloat_AsDouble(PyTuple_GetItem(out, 2));
        if (yz) *yz = PyFloat_AsDouble(PyTuple_GetItem(out, 3));
        if (xz) *xz = PyFloat_AsDouble(PyTuple_GetItem(out, 4));
        if (periodicity) {
            PyObject *per = PyTuple_GetItem(out, 5);
            for (int i = 0; i < 3; i++)
                periodicity[i] =
                    (int)PyLong_AsLong(PyList_GetItem(per, i));
        }
        if (box_change) *box_change =
            (int)PyLong_AsLong(PyTuple_GetItem(out, 6));
        Py_DECREF(out);
    }
    LEAVE;
}

void lammps_reset_box(void *handle, double *boxlo, double *boxhi,
                      double xy, double yz, double xz) {
    tpumd_handle *h = (tpumd_handle *)handle;
    ENTER;
    PyObject *out = callb("reset_box", "(l(ddd)(ddd)ddd)", h->handle,
                          boxlo[0], boxlo[1], boxlo[2],
                          boxhi[0], boxhi[1], boxhi[2], xy, yz, xz);
    Py_XDECREF(out);
    LEAVE;
}

int lammps_extract_setting(void *handle, const char *name) {
    tpumd_handle *h = (tpumd_handle *)handle;
    int v = -1;
    ENTER;
    PyObject *out = callb("extract_setting", "(ls)", h->handle, name);
    if (out) { v = (int)PyLong_AsLong(out); Py_DECREF(out); }
    LEAVE;
    return v;
}

int lammps_create_atoms(void *handle, int n, const int *id, const int *type,
                        const double *x, const double *v, const int *image,
                        int bexpand) {
    tpumd_handle *h = (tpumd_handle *)handle;
    int rc = -1;
    (void)image; (void)bexpand;
    ENTER;
    PyObject *ids = id ? PyList_New(n) : Py_NewRef(Py_None);
    PyObject *types = PyList_New(n);
    PyObject *xs = PyList_New(3 * (Py_ssize_t)n);
    PyObject *vs = v ? PyList_New(3 * (Py_ssize_t)n) : Py_NewRef(Py_None);
    for (int i = 0; i < n; i++) {
        if (id) PyList_SET_ITEM(ids, i, PyLong_FromLong(id[i]));
        PyList_SET_ITEM(types, i, PyLong_FromLong(type[i]));
        for (int k = 0; k < 3; k++) {
            PyList_SET_ITEM(xs, 3 * (Py_ssize_t)i + k,
                            PyFloat_FromDouble(x[3 * i + k]));
            if (v) PyList_SET_ITEM(vs, 3 * (Py_ssize_t)i + k,
                                   PyFloat_FromDouble(v[3 * i + k]));
        }
    }
    PyObject *out = callb("create_atoms", "(liOOOO)", h->handle, n,
                          ids, types, xs, vs);
    Py_DECREF(ids); Py_DECREF(types); Py_DECREF(xs); Py_DECREF(vs);
    if (out) { rc = (int)PyLong_AsLong(out); Py_DECREF(out); }
    LEAVE;
    return rc;
}

int lammps_has_error(void *handle) {
    tpumd_handle *h = (tpumd_handle *)handle;
    int v = 0;
    ENTER;
    PyObject *out = callb("has_error", "(l)", h->handle);
    if (out) { v = (int)PyLong_AsLong(out); Py_DECREF(out); }
    LEAVE;
    return v;
}

int lammps_get_last_error_message(void *handle, char *buffer,
                                  int buf_size) {
    tpumd_handle *h = (tpumd_handle *)handle;
    int had = 0;
    ENTER;
    PyObject *out = callb("get_last_error_message", "(l)", h->handle);
    if (out) {
        const char *msg = PyUnicode_AsUTF8(out);
        if (msg && msg[0]) {
            had = 1;
            if (buffer && buf_size > 0) {
                strncpy(buffer, msg, buf_size - 1);
                buffer[buf_size - 1] = '\0';
            }
        } else if (buffer && buf_size > 0) {
            buffer[0] = '\0';
        }
        Py_DECREF(out);
    }
    LEAVE;
    return had;
}

void lammps_free(void *ptr) { free(ptr); }

/* ------------------------------------------------------- fix external */
typedef void (*FixExternalFnPtr)(void *, int64_t, int, int *, double **,
                                 double **);

void lammps_set_fix_external_callback(void *handle, const char *id,
                                      FixExternalFnPtr funcptr, void *ptr) {
    tpumd_handle *h = (tpumd_handle *)handle;
    ENTER;
    PyObject *out = callb("set_fix_external_callback_addr", "(lsLL)",
                          h->handle, id, (long long)(intptr_t)funcptr,
                          (long long)(intptr_t)ptr);
    Py_XDECREF(out);
    LEAVE;
}

double **lammps_fix_external_get_force(void *handle, const char *id) {
    tpumd_handle *h = (tpumd_handle *)handle;
    void *result = NULL;
    ENTER;
    PyObject *out = callb("fix_external_get_force", "(ls)", h->handle, id);
    if (out) {
        Py_ssize_t n0 = 0, n1 = 0;
        void *data = array_data(out, &n0, &n1);
        if (data) {
            char key[256];
            snprintf(key, sizeof key, "fix_external/%s", id);
            result = rows_over(h, key, data, n0, 3);
        }
        Py_DECREF(out);
    }
    LEAVE;
    return (double **)result;
}

void lammps_fix_external_set_energy_global(void *handle, const char *id,
                                           double eng) {
    tpumd_handle *h = (tpumd_handle *)handle;
    ENTER;
    PyObject *out = callb("fix_external_set_energy_global", "(lsd)",
                          h->handle, id, eng);
    Py_XDECREF(out);
    LEAVE;
}

void lammps_fix_external_set_virial_global(void *handle, const char *id,
                                           double *virial) {
    tpumd_handle *h = (tpumd_handle *)handle;
    ENTER;
    PyObject *out = callb("fix_external_set_virial_global",
                          "(ls(dddddd))", h->handle, id, virial[0],
                          virial[1], virial[2], virial[3], virial[4],
                          virial[5]);
    Py_XDECREF(out);
    LEAVE;
}

void lammps_scatter_atoms(void *handle, const char *name, int type,
                          int count, void *data) {
    tpumd_handle *h = (tpumd_handle *)handle;
    ENTER;
    double n = 0.0;
    PyObject *nat = callb("get_natoms", "(l)", h->handle);
    if (nat) { n = PyFloat_AsDouble(nat); Py_DECREF(nat); }
    Py_ssize_t total = (Py_ssize_t)n * count;
    PyObject *list = PyList_New(total);
    for (Py_ssize_t i = 0; i < total; i++) {
        PyObject *v = (type == 1)
            ? PyLong_FromLong(((int *)data)[i])
            : PyFloat_FromDouble(((double *)data)[i]);
        PyList_SET_ITEM(list, i, v);
    }
    PyObject *out = callb("scatter_atoms", "(lsO)", h->handle, name, list);
    Py_DECREF(list);
    Py_XDECREF(out);
    LEAVE;
}

/* ------------------------------------------------------------- wave 3 */

void lammps_commands_list(void *handle, int ncmd, const char **cmds) {
    tpumd_handle *h = (tpumd_handle *)handle;
    ENTER;
    for (int i = 0; i < ncmd; i++) {
        PyObject *out = callb("command_noraise", "(ls)", h->handle,
                              cmds[i]);
        Py_XDECREF(out);
    }
    LEAVE;
}

void *lammps_open(int argc, char **argv, int comm, void **ptr) {
    (void)comm;
    return lammps_open_no_mpi(argc, argv, ptr);
}

void *lammps_open_fortran(int argc, char **argv, int comm) {
    (void)comm;
    return lammps_open_no_mpi(argc, argv, NULL);
}

void lammps_mpi_init(void) {}
void lammps_mpi_finalize(void) {}
void lammps_kokkos_finalize(void) {}
void lammps_python_finalize(void) {}
void lammps_flush_buffers(void *handle) { (void)handle; }

int lammps_is_running(void *handle) { (void)handle; return 0; }

void lammps_force_timeout(void *handle) {
    tpumd_handle *h = (tpumd_handle *)handle;
    ENTER;
    PyObject *out = callb("force_timeout", "(l)", h->handle);
    Py_XDECREF(out);
    LEAVE;
}

void lammps_memory_usage(void *handle, double *meminfo) {
    tpumd_handle *h = (tpumd_handle *)handle;
    ENTER;
    PyObject *out = callb("memory_usage", "(l)", h->handle);
    if (out) {
        for (int i = 0; i < 3; i++)
            meminfo[i] = PyFloat_AsDouble(PyList_GetItem(out, i));
        Py_DECREF(out);
    }
    LEAVE;
}

int lammps_get_os_info(char *buffer, int buf_size) {
    ENTER;
    PyObject *out = callb("get_os_info", "()");
    int n = 0;
    if (out) {
        const char *s = PyUnicode_AsUTF8(out);
        if (s) { strncpy(buffer, s, buf_size - 1);
                 buffer[buf_size - 1] = 0; n = (int)strlen(buffer); }
        Py_DECREF(out);
    }
    LEAVE;
    return n;
}

/* --- config introspection (static answers for this build) ----------- */
int lammps_config_has_mpi_support(void) { return 0; }
int lammps_config_has_gzip_support(void) { return 1; }
int lammps_config_has_png_support(void) { return 0; }
int lammps_config_has_jpeg_support(void) { return 0; }
int lammps_config_has_ffmpeg_support(void) { return 0; }
int lammps_config_has_exceptions(void) { return 1; }
int lammps_config_accelerator(const char *pkg, const char *cat,
                              const char *setting) {
    (void)cat; (void)setting;
    return strcmp(pkg, "TPU") == 0;   /* the whole engine IS the
                                         accelerator package */
}

int lammps_config_has_package(const char *name) {
    int v = 0;
    ENTER;
    PyObject *out = callb("config_has_package", "(s)", name);
    if (out) { v = (int)PyLong_AsLong(out); Py_DECREF(out); }
    LEAVE;
    return v;
}

int lammps_config_package_count(void) {
    int v = 0;
    ENTER;
    PyObject *out = callb("config_package_count", "()");
    if (out) { v = (int)PyLong_AsLong(out); Py_DECREF(out); }
    LEAVE;
    return v;
}

int lammps_config_package_name(int idx, char *buffer, int buf_size) {
    int n = 0;
    ENTER;
    PyObject *out = callb("config_package_name", "(i)", idx);
    if (out) {
        const char *s = PyUnicode_AsUTF8(out);
        if (s && s[0]) { strncpy(buffer, s, buf_size - 1);
                         buffer[buf_size - 1] = 0; n = 1; }
        Py_DECREF(out);
    }
    LEAVE;
    return n;
}

/* --- style / id introspection --------------------------------------- */
static int str_out(PyObject *out, char *buffer, int buf_size) {
    int n = 0;
    if (out) {
        const char *s = PyUnicode_AsUTF8(out);
        if (s && s[0]) { strncpy(buffer, s, buf_size - 1);
                         buffer[buf_size - 1] = 0; n = 1; }
        Py_DECREF(out);
    }
    return n;
}

int lammps_has_style(void *handle, const char *category, const char *name) {
    tpumd_handle *h = (tpumd_handle *)handle;
    int v = 0;
    ENTER;
    PyObject *out = callb("has_style", "(lss)", h->handle, category, name);
    if (out) { v = (int)PyLong_AsLong(out); Py_DECREF(out); }
    LEAVE;
    return v;
}

int lammps_style_count(void *handle, const char *category) {
    tpumd_handle *h = (tpumd_handle *)handle;
    int v = 0;
    ENTER;
    PyObject *out = callb("style_count", "(ls)", h->handle, category);
    if (out) { v = (int)PyLong_AsLong(out); Py_DECREF(out); }
    LEAVE;
    return v;
}

int lammps_style_name(void *handle, const char *category, int idx,
                      char *buffer, int buf_size) {
    tpumd_handle *h = (tpumd_handle *)handle;
    int n;
    ENTER;
    n = str_out(callb("style_name", "(lsi)", h->handle, category, idx),
                buffer, buf_size);
    LEAVE;
    return n;
}

int lammps_has_id(void *handle, const char *category, const char *name) {
    tpumd_handle *h = (tpumd_handle *)handle;
    int v = 0;
    ENTER;
    PyObject *out = callb("has_id", "(lss)", h->handle, category, name);
    if (out) { v = (int)PyLong_AsLong(out); Py_DECREF(out); }
    LEAVE;
    return v;
}

int lammps_id_count(void *handle, const char *category) {
    tpumd_handle *h = (tpumd_handle *)handle;
    int v = 0;
    ENTER;
    PyObject *out = callb("id_count", "(ls)", h->handle, category);
    if (out) { v = (int)PyLong_AsLong(out); Py_DECREF(out); }
    LEAVE;
    return v;
}

int lammps_id_name(void *handle, const char *category, int idx,
                   char *buffer, int buf_size) {
    tpumd_handle *h = (tpumd_handle *)handle;
    int n;
    ENTER;
    n = str_out(callb("id_name", "(lsi)", h->handle, category, idx),
                buffer, buf_size);
    LEAVE;
    return n;
}

int lammps_variable_info(void *handle, int idx, char *buffer,
                         int buf_size) {
    tpumd_handle *h = (tpumd_handle *)handle;
    int n = 0;
    ENTER;
    PyObject *out = callb("variable_info", "(li)", h->handle, idx);
    if (out) {
        PyObject *nm = PyTuple_GetItem(out, 0);
        const char *s = PyUnicode_AsUTF8(nm);
        if (s && s[0]) { strncpy(buffer, s, buf_size - 1);
                         buffer[buf_size - 1] = 0; n = 1; }
        Py_DECREF(out);
    }
    LEAVE;
    return n;
}

/* --- topology gathers ------------------------------------------------ */
static int gather_tuples_c(void *handle, const char *kind, void *data) {
    tpumd_handle *h = (tpumd_handle *)handle;
    int count = 0;
    ENTER;
    PyObject *out = callb("gather_tuples", "(ls)", h->handle, kind);
    if (out) {
        PyObject *arr = PyTuple_GetItem(out, 0);
        count = (int)PyLong_AsLong(PyTuple_GetItem(out, 1));
        Py_ssize_t n0 = 0;
        void *src = array_data(arr, &n0, NULL);
        if (src && data) memcpy(data, src, n0 * sizeof(int));
        Py_DECREF(out);
    }
    LEAVE;
    return count;
}

void lammps_gather_bonds(void *handle, void *data) {
    gather_tuples_c(handle, "bond", data);
}
void lammps_gather_angles(void *handle, void *data) {
    gather_tuples_c(handle, "angle", data);
}
void lammps_gather_dihedrals(void *handle, void *data) {
    gather_tuples_c(handle, "dihedral", data);
}
void lammps_gather_impropers(void *handle, void *data) {
    gather_tuples_c(handle, "improper", data);
}

/* concat == ordered gather on a single partition */
void lammps_gather_atoms_concat(void *handle, const char *name, int type,
                                int count, void *data) {
    lammps_gather_atoms(handle, name, type, count, data);
}

void lammps_gather_atoms_subset(void *handle, const char *name, int type,
                                int count, int ndata, int *ids,
                                void *data) {
    tpumd_handle *h = (tpumd_handle *)handle;
    (void)type;
    ENTER;
    PyObject *idlist = PyList_New(ndata);
    for (int i = 0; i < ndata; i++)
        PyList_SET_ITEM(idlist, i, PyLong_FromLong(ids[i]));
    PyObject *out = callb("gather_atoms_subset", "(lsO)", h->handle, name,
                          idlist);
    Py_DECREF(idlist);
    if (out) {
        Py_ssize_t n0 = 0;
        void *src = array_data(out, &n0, NULL);
        if (src) memcpy(data, src, (size_t)ndata * count * sizeof(double));
        Py_DECREF(out);
    }
    LEAVE;
}

void lammps_scatter_atoms_subset(void *handle, const char *name, int type,
                                 int count, int ndata, int *ids,
                                 void *data) {
    tpumd_handle *h = (tpumd_handle *)handle;
    (void)type;
    ENTER;
    PyObject *idlist = PyList_New(ndata);
    for (int i = 0; i < ndata; i++)
        PyList_SET_ITEM(idlist, i, PyLong_FromLong(ids[i]));
    PyObject *vals = PyList_New((Py_ssize_t)ndata * count);
    double *dd = (double *)data;
    for (Py_ssize_t i = 0; i < (Py_ssize_t)ndata * count; i++)
        PyList_SET_ITEM(vals, i, PyFloat_FromDouble(dd[i]));
    PyObject *out = callb("scatter_atoms_subset", "(lsOO)", h->handle,
                          name, idlist, vals);
    Py_DECREF(idlist);
    Py_DECREF(vals);
    Py_XDECREF(out);
    LEAVE;
}

/* --- image flag codecs (pure C, src/library.cpp:5432-5480) ---------- */
#define IMGMASK 1023
#define IMGMAX 512
#define IMGBITS 10
#define IMG2BITS 20

int lammps_encode_image_flags(int ix, int iy, int iz) {
    return (((int)(iz + IMGMAX) & IMGMASK) << IMG2BITS) |
           (((int)(iy + IMGMAX) & IMGMASK) << IMGBITS) |
           ((int)(ix + IMGMAX) & IMGMASK);
}

void lammps_decode_image_flags(int image, int *flags) {
    flags[0] = (image & IMGMASK) - IMGMAX;
    flags[1] = ((image >> IMGBITS) & IMGMASK) - IMGMAX;
    flags[2] = ((image >> IMG2BITS) & IMGMASK) - IMGMAX;
}

void lammps_error(void *handle, int error_type, const char *error_text) {
    (void)handle; (void)error_type;
    fprintf(stderr, "tpumd error: %s\n", error_text);
}

/* ---------------------------------------------------------------------
 * wave 4: extract_global + datatype queries, neighbor-list access,
 * generic gather/scatter, last_thermo, plugin info, fix-external
 * per-atom/vector channels (src/library.h:152-300 contracts)
 * ------------------------------------------------------------------- */

void *lammps_extract_global(void *handle, const char *name) {
    tpumd_handle *h = (tpumd_handle *)handle;
    void *result = NULL;
    ENTER;
    PyObject *out = callb("extract_global_typed", "(ls)", h->handle, name);
    if (out) {
        Py_ssize_t n0 = 0;
        result = array_data(out, &n0, NULL);
        Py_DECREF(out);
    }
    LEAVE;
    return result;
}

static int datatype_query(void *handle, const char *fn, const char *name) {
    tpumd_handle *h = (tpumd_handle *)handle;
    int result = -1;
    ENTER;
    PyObject *out = callb(fn, "(ls)", h->handle, name);
    if (out) {
        result = (int)PyLong_AsLong(out);
        Py_DECREF(out);
    }
    LEAVE;
    return result;
}

int lammps_extract_global_datatype(void *handle, const char *name) {
    return datatype_query(handle, "extract_global_datatype", name);
}

int lammps_extract_atom_datatype(void *handle, const char *name) {
    return datatype_query(handle, "extract_atom_datatype", name);
}

int lammps_extract_variable_datatype(void *handle, const char *name) {
    return datatype_query(handle, "extract_variable_datatype", name);
}

void *lammps_last_thermo(void *handle, const char *what, int index) {
    tpumd_handle *h = (tpumd_handle *)handle;
    void *result = NULL;
    ENTER;
    PyObject *out = callb("last_thermo", "(lsi)", h->handle, what, index);
    if (out && out != Py_None) {
        if (PyUnicode_Check(out)) {
            /* keyword: hand out a handle-owned copy of the string */
            const char *s = PyUnicode_AsUTF8(out);
            char *copy = strdup(s ? s : ""), key[64];
            snprintf(key, sizeof key, "thermo_keyword/%d", index);
            result = remember_rowtab(h, key, copy);
        } else {
            Py_ssize_t n0 = 0;
            result = array_data(out, &n0, NULL);
        }
    }
    Py_XDECREF(out);
    LEAVE;
    return result;
}

/* generic gather/scatter family: same properties as the _atoms family */
void lammps_gather(void *handle, const char *name, int type, int count,
                   void *data) {
    lammps_gather_atoms(handle, name, type, count, data);
}

void lammps_gather_concat(void *handle, const char *name, int type,
                          int count, void *data) {
    lammps_gather_atoms(handle, name, type, count, data);
}

void lammps_gather_subset(void *handle, const char *name, int type,
                          int count, int ndata, int *ids, void *data) {
    lammps_gather_atoms_subset(handle, name, type, count, ndata, ids,
                               data);
}

void lammps_scatter(void *handle, const char *name, int type, int count,
                    void *data) {
    lammps_scatter_atoms(handle, name, type, count, data);
}

void lammps_scatter_subset(void *handle, const char *name, int type,
                           int count, int ndata, int *ids, void *data) {
    lammps_scatter_atoms_subset(handle, name, type, count, ndata, ids,
                                data);
}

/* ------------------------------------------------ neighbor-list access */
int lammps_find_pair_neighlist(void *handle, const char *style, int exact,
                               int nsub, int request) {
    tpumd_handle *h = (tpumd_handle *)handle;
    int result = -1;
    ENTER;
    PyObject *out = callb("find_pair_neighlist", "(lsiii)", h->handle,
                          style, exact, nsub, request);
    if (out) {
        result = (int)PyLong_AsLong(out);
        Py_DECREF(out);
    }
    LEAVE;
    return result;
}

int lammps_find_fix_neighlist(void *handle, const char *id, int request) {
    tpumd_handle *h = (tpumd_handle *)handle;
    int result = -1;
    ENTER;
    PyObject *out = callb("find_fix_neighlist", "(lsi)", h->handle, id,
                          request);
    if (out) {
        result = (int)PyLong_AsLong(out);
        Py_DECREF(out);
    }
    LEAVE;
    return result;
}

int lammps_find_compute_neighlist(void *handle, const char *id,
                                  int request) {
    tpumd_handle *h = (tpumd_handle *)handle;
    int result = -1;
    ENTER;
    PyObject *out = callb("find_compute_neighlist", "(lsi)", h->handle,
                          id, request);
    if (out) {
        result = (int)PyLong_AsLong(out);
        Py_DECREF(out);
    }
    LEAVE;
    return result;
}

int lammps_neighlist_num_elements(void *handle, int idx) {
    tpumd_handle *h = (tpumd_handle *)handle;
    int result = -1;
    ENTER;
    PyObject *out = callb("neighlist_num_elements", "(li)", h->handle,
                          idx);
    if (out) {
        result = (int)PyLong_AsLong(out);
        Py_DECREF(out);
    }
    LEAVE;
    return result;
}

void lammps_neighlist_element_neighbors(void *handle, int idx, int element,
                                        int *iatom, int *numneigh,
                                        int **neighbors) {
    tpumd_handle *h = (tpumd_handle *)handle;
    *iatom = -1;
    *numneigh = 0;
    *neighbors = NULL;
    ENTER;
    PyObject *out = callb("neighlist_element_neighbors", "(lii)",
                          h->handle, idx, element);
    if (out && PyTuple_Check(out)) {
        *iatom = (int)PyLong_AsLong(PyTuple_GET_ITEM(out, 0));
        PyObject *arr = PyTuple_GET_ITEM(out, 1);
        Py_ssize_t n0 = 0;
        void *data = array_data(arr, &n0, NULL);
        if (data) {
            *numneigh = (int)n0;
            *neighbors = (int *)data;
        }
    }
    Py_XDECREF(out);
    LEAVE;
}

/* ------------------------------------------ fix external wave-4 extras */
void lammps_fix_external_set_energy_peratom(void *handle, const char *id,
                                            double *eng) {
    tpumd_handle *h = (tpumd_handle *)handle;
    ENTER;
    double n = 0.0;
    {
        PyObject *nat = callb("get_natoms", "(l)", h->handle);
        if (nat) { n = PyFloat_AsDouble(nat); Py_DECREF(nat); }
    }
    int nn = (int)n;
    PyObject *vals = PyList_New(nn);
    for (int i = 0; i < nn; i++)
        PyList_SET_ITEM(vals, i, PyFloat_FromDouble(eng[i]));
    PyObject *out = callb("fix_external_set_energy_peratom", "(lsO)",
                          h->handle, id, vals);
    Py_DECREF(vals);
    Py_XDECREF(out);
    LEAVE;
}

void lammps_fix_external_set_virial_peratom(void *handle, const char *id,
                                            double **virial) {
    tpumd_handle *h = (tpumd_handle *)handle;
    ENTER;
    double n = 0.0;
    {
        PyObject *nat = callb("get_natoms", "(l)", h->handle);
        if (nat) { n = PyFloat_AsDouble(nat); Py_DECREF(nat); }
    }
    int nn = (int)n;
    PyObject *vals = PyList_New((Py_ssize_t)nn * 6);
    for (int i = 0; i < nn; i++)
        for (int c = 0; c < 6; c++)
            PyList_SET_ITEM(vals, (Py_ssize_t)i * 6 + c,
                            PyFloat_FromDouble(virial[i][c]));
    PyObject *out = callb("fix_external_set_virial_peratom", "(lsO)",
                          h->handle, id, vals);
    Py_DECREF(vals);
    Py_XDECREF(out);
    LEAVE;
}

void lammps_fix_external_set_vector_length(void *handle, const char *id,
                                           int len) {
    tpumd_handle *h = (tpumd_handle *)handle;
    ENTER;
    PyObject *out = callb("fix_external_set_vector_length", "(lsi)",
                          h->handle, id, len);
    Py_XDECREF(out);
    LEAVE;
}

void lammps_fix_external_set_vector(void *handle, const char *id, int idx,
                                    double val) {
    tpumd_handle *h = (tpumd_handle *)handle;
    ENTER;
    PyObject *out = callb("fix_external_set_vector", "(lsid)", h->handle,
                          id, idx, val);
    Py_XDECREF(out);
    LEAVE;
}

/* ----------------------------------------------------- misc wave-4 info */
int lammps_python_api_version(void) { return 2; }

int lammps_get_mpi_comm(void *handle) { (void)handle; return -1; }

int lammps_has_gpu_device(void) {
    ENTER;
    int result = 0;
    PyObject *out = callb("has_gpu_device", "()");
    if (out) { result = (int)PyLong_AsLong(out); Py_DECREF(out); }
    LEAVE;
    return result;
}

void lammps_get_gpu_device_info(char *buffer, int buf_size) {
    ENTER;
    PyObject *out = callb("get_gpu_device_info", "()");
    if (out) {
        const char *s = PyUnicode_AsUTF8(out);
        if (s) { strncpy(buffer, s, buf_size - 1); buffer[buf_size - 1] = 0; }
        Py_DECREF(out);
    }
    LEAVE;
}

int lammps_plugin_count(void) {
    ENTER;
    int result = 0;
    PyObject *out = callb("plugin_count", "()");
    if (out) { result = (int)PyLong_AsLong(out); Py_DECREF(out); }
    LEAVE;
    return result;
}

int lammps_plugin_name(int idx, char *stylebuf, char *namebuf,
                       int buf_size) {
    ENTER;
    int result = 0;
    PyObject *out = callb("plugin_name", "(i)", idx);
    if (out && PyTuple_Check(out)) {
        const char *st = PyUnicode_AsUTF8(PyTuple_GET_ITEM(out, 0));
        const char *nm = PyUnicode_AsUTF8(PyTuple_GET_ITEM(out, 1));
        if (st && nm && st[0]) {
            strncpy(stylebuf, st, buf_size - 1);
            stylebuf[buf_size - 1] = 0;
            strncpy(namebuf, nm, buf_size - 1);
            namebuf[buf_size - 1] = 0;
            result = 1;
        }
    }
    Py_XDECREF(out);
    LEAVE;
    return result;
}

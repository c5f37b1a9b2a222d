"""Shared by the port's DPD and kspace parity tests: a deck run by tpumd
and by the port on the CPU in float64, both on the matrix engine, with
every thermo row kept at full precision."""

import contextlib
import os

import numpy as np
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch.script.parser import LammpsScript as TScript


def record_rows(sim):
    """Keep every thermo row's full-precision values by step."""
    rows = {}
    fn = sim._vals_from_packed

    def wrapped(vals_h):
        out = fn(vals_h)
        rows[out["step"]] = dict(out)
        return out
    sim._vals_from_packed = wrapped
    return rows


def by_tag(t, tag):
    """Rows of t in tag order (real atoms only)."""
    tag = np.asarray(tag)
    order = np.argsort(tag)
    return np.asarray(t)[order][tag[order] > 0]


def both(text, data_dir=None):
    """(tpumd script, port script, tpumd rows, port rows, tpumd step-0
    forces by tag, port's) of a deck run by both, on the matrix engine in
    float64: its set-up lines, run 0, then its run line."""
    pre, runline = text.rsplit("\nrun", 1)
    out = []
    for script in (JScript(**({"data_dir": data_dir} if data_dir else {})),
                   TScript(device="cpu", dtype=torch.float64)):
        if data_dir and isinstance(script, TScript):
            script.data_dir = data_dir
        with contextlib.redirect_stdout(open(os.devnull, "w")):
            script.run_string(pre)
            script.sim.neighbor_mode = "matrix"
            rows = record_rows(script.sim)
            script.run_string("run 0")
            f0 = by_tag(script.sim.state.f, script.sim.state.tag)
            script.run_string("run" + runline)
        out.append((script, rows, f0))
    (js, jrows, jf0), (ts, trows, tf0) = out
    return js, ts, jrows, trows, jf0, tf0


ROW_KEYS = ("temp", "epair", "evdwl", "ecoul", "elong", "emol", "etotal",
            "press")


def assert_rows_equal(trows, jrows, rel=1e-10):
    assert sorted(trows) == sorted(jrows) and trows
    for step in jrows:
        for k in ROW_KEYS:
            a, b = trows[step][k], float(jrows[step][k])
            assert abs(a - b) <= rel * max(abs(b), 1.0), (step, k, a, b)

"""The bonded styles' member gathers: every member of a style's tuples in
one gather (``models/bonded.py::members``), on the CPU.

The merged gather of the (M, arity) member columns equals the gathers of
each member alone bit for bit, for every arity, through the matrix
engine's ``gather_rows`` (P1's wrapper, its plain version here) and the
grid's ``take_rows``; a per-tag column read at several members at once
(``member_column``, the types and charges of a CHARMM dihedral's ends)
equals the reads one member at a time; and dihedral's in.di (CHARMM
dihedrals, whose weighted 1-4 pairs read those columns) through the port
on the matrix engine prints tpumd's rows to 1e-9."""

import contextlib
import os
import types

import numpy as np
import pytest
import torch

from tpumd.script.parser import LammpsScript as JScript
from tpumd_torch import bonded_goldens as bg
from tpumd_torch.models.bonded import member_column, members, take_rows
from tpumd_torch.ops import gather
from tpumd_torch.ops.gather import gather_rows

torch.set_num_threads(2)

GOLD = os.path.join(os.path.dirname(__file__), "golden")
TAKES = {"gather_rows": (gather_rows, torch.int32),
         "take_rows": (take_rows, torch.int64)}


@pytest.mark.parametrize("take_name", list(TAKES))
@pytest.mark.parametrize("arity", [2, 3, 4])
def test_merged_member_gather_equals_per_member(arity, take_name):
    take, index = TAKES[take_name]
    rng = np.random.default_rng(170 + arity)
    n, m = 200, 333
    x = torch.as_tensor(rng.standard_normal((n, 3)))
    tuples = torch.as_tensor(np.concatenate(
        [rng.integers(1, 4, (m, 1)), rng.integers(0, n, (m, arity))],
        axis=1), dtype=index)
    calls = []

    def counted(table, idx):
        calls.append(tuple(idx.shape))
        return take(table, idx)
    plain0 = gather.counts.plain_calls
    mem, xs = members(types.SimpleNamespace(arity=arity), (x, None, None),
                      tuples, counted)
    assert calls == [(m, arity)]
    if take is gather_rows:
        assert gather.counts.plain_calls == plain0 + 1
    assert len(xs) == arity
    for k in range(arity):
        one = tuples[:, 1 + k].contiguous()
        assert torch.equal(mem[:, k], one)
        assert torch.equal(xs[k], take(x, one))
        assert torch.equal(xs[k], x[one.long()])
    typ = torch.as_tensor(rng.integers(1, 5, n), dtype=torch.int32)
    q = torch.as_tensor(rng.standard_normal(n))
    ends = mem[:, 0::arity - 1].contiguous()
    for col in (typ, q):
        both = member_column(take, col, ends)
        assert both.shape == (m, 2)
        for k, c in enumerate((0, arity - 1)):
            assert torch.equal(both[:, k], member_column(
                take, col, mem[:, c].contiguous()))
            assert torch.equal(both[:, k], col[mem[:, c].long()])


def test_dihedral_golden_equals_tpumd(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "tpumd").mkdir()
    port = bg.run(GOLD, "di", str(tmp_path / "port"), "cpu", torch.float64)
    assert not port.sim._ctx.is_cellgrid
    path = bg.stage(GOLD, "di", str(tmp_path / "tpumd"))
    ref = JScript(data_dir=str(tmp_path / "tpumd"))
    with open(path) as fh, contextlib.redirect_stdout(open(os.devnull,
                                                           "w")):
        ref.run_string(fh.read())
    got, want = port.sim.last_thermo, ref.sim.last_thermo
    keys = [k for k in ("temp", "epair", "emol", "etotal", "press", "ebond",
                        "eangle", "edihed", "eimp") if k in want]
    assert "edihed" in keys or "emol" in keys
    for k in keys:
        assert got[k] == pytest.approx(float(want[k]), rel=1e-9,
                                       abs=1e-10), k

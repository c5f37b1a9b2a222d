"""P1, the row gather of the matrix neighbor engine: the port's plain
version against numpy and against the TPU kernel's body.

``ops/gather.py::gather_rows`` takes its plain version on CPU tensors (the
CUDA kernel ``csrc/row_gather.cu`` is held to it on the card in
tests/test_torch_cuda_kernels.py).  Here:

* the plain version equals numpy's ``table[idx]`` bit for bit for f32, f64
  and int32 tables of widths 1, 5, 12, 16 and 128, with (M,) and (M, K)
  indices that include the last row;
* it equals the body of tools/probes/gather_probe.py::k_tala
  (``jnp.take_along_axis`` with the index broadcast over the lanes) run
  in ``pallas_call`` under ``pltpu.force_tpu_interpret_mode()`` at a small
  shape: a 256x128 f32 table, 1,024 indices, blocks of 256 rows.  The
  probe module times its kernels when imported, so the three-line body is
  rebuilt here;
* the wrapper refuses what the kernel does not take, the same on the CPU
  as on the card, and counts its plain calls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tpumd_torch.ops import gather as p1

DTYPES = {"f32": (np.float32, torch.float32),
          "f64": (np.float64, torch.float64),
          "i32": (np.int32, torch.int32)}


@pytest.mark.parametrize("width", [1, 5, 12, 16, 128])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_gather_equals_numpy(dtype, width):
    npt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(width)
    rows = 97
    if npt is np.int32:
        table = rng.integers(-2**31, 2**31 - 1, (rows, width), dtype=np.int64
                             ).astype(np.int32)
    else:
        table = rng.standard_normal((rows, width)).astype(npt)
    t = torch.as_tensor(table, dtype=tdt)
    for shape in ((300,), (40, 7)):
        idx = rng.integers(0, rows, shape).astype(np.int32)
        idx.reshape(-1)[-1] = rows - 1      # the largest index
        idx.reshape(-1)[0] = 0
        n0 = p1.counts.plain_calls
        out = p1.gather_rows(t, torch.as_tensor(idx))
        assert p1.counts.plain_calls == n0 + 1
        assert out.dtype == tdt and tuple(out.shape) == shape + (width,)
        np.testing.assert_array_equal(out.numpy(), table[idx])


def test_plain_gather_equals_the_probe_kernel():
    n_rows, lanes, m, bm = 256, 128, 1024, 256
    rng = np.random.default_rng(0)
    table = rng.standard_normal((n_rows, lanes)).astype(np.float32)
    idx = rng.integers(0, n_rows, m).astype(np.int32)
    idx[-1] = n_rows - 1

    def k_tala(t_ref, i_ref, o_ref):
        o_ref[...] = jnp.take_along_axis(t_ref[...], i_ref[...], axis=0)

    with pltpu.force_tpu_interpret_mode():
        ref = pl.pallas_call(
            k_tala, grid=(m // bm,),
            in_specs=[pl.BlockSpec((n_rows, lanes), lambda i: (0, 0)),
                      pl.BlockSpec((bm, lanes), lambda i: (i, 0))],
            out_specs=pl.BlockSpec((bm, lanes), lambda i: (i, 0)),
            out_shape=jax.ShapeDtypeStruct((m, lanes), jnp.float32),
        )(jnp.asarray(table),
          jnp.broadcast_to(jnp.asarray(idx)[:, None], (m, lanes)))
    out = p1.gather_rows(torch.as_tensor(table), torch.as_tensor(idx))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(np.asarray(ref), table[idx])


@pytest.mark.parametrize("bad", ["int64 index", "3-D index", "1-D table",
                                 "int64 table", "strided table"])
def test_gather_refuses_what_the_kernel_does_not_take(bad):
    table = torch.zeros((8, 4))
    idx = torch.zeros(5, dtype=torch.int32)
    table, idx = {
        "int64 index": (table, idx.long()),
        "3-D index": (table, idx.reshape(5, 1, 1)),
        "1-D table": (table[:, 0].contiguous(), idx),
        "int64 table": (table.long(), idx),
        "strided table": (table[:, :2], idx)}[bad]
    with pytest.raises(ValueError, match="gather_rows"):
        p1.gather_rows(table, idx)

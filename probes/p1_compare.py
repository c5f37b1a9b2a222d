"""P1, the row gather (``ops/gather.py::gather_rows``), at the shapes the
main paths give it, timed beside an older tree's P1 in the same process.

Run from the repository root, on the card:
``python3 probes/p1_compare.py [--parent DIR] [--variants] [--diagnose]
[--json PATH]``, for example with an older commit unpacked by ``git
archive`` into a git-ignored directory: ``python3 probes/p1_compare.py
--parent build/parent``.

The shapes: the gather probe's (tools/probes/gather_probe.py, L = 128 and
16 f32), each of ``chip_smoke.P1_MAIN_SHAPES`` with random indices, and
the inputs that the matrix engine really hands to P1 on IN_SALT32K and
IN_HYB32K (recorded at their f32 set-ups by ``chip_smoke.recording_p1``):
the packed j rows of both, and the tag-order view of IN_HYB32K at its
first dihedral style's tuples, all four members at once and the first
member alone.  At each shape the kernel is held bit for bit against its
plain version, then timed with ``chip_smoke.cuda_ms`` in the order
parent, this tree, this tree, parent (this tree twice without --parent),
beside ``torch.index_select`` on the same tensors, the bound (the table,
the indices and the output, each moved once, at 3.35 TB/s) and the host
microseconds of each wrapper's call (``chip_smoke.host_us``).

DIR's P1 is its own ``csrc/row_gather.cu``, built here with its entry
point renamed (``build/p1_compare/``), behind its own ``ops/gather.py``.
--variants adds this tree's kernel built again with constants of its
narrow copy rewritten (``VARIANTS``), timed in the same turns.

--diagnose adds, at the two packed-row shapes: the index statistics
(padding share, distinct 128-byte lines of the table a warp of 32
consecutive indices touches), each P1 with every index 0 (every table
read one line) and with the indices sorted, and the card's floors for the
output alone: a fill of a tensor of the output's size and a copy of one.

Prints a line per shape (with --json PATH also writes the numbers to
PATH) and ends with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import re
import subprocess
import sys
import tempfile
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# variants of this tree's narrow copy: constants of row_gather.cu
# rewritten (--variants)
VARIANTS = {
    "t256": {"kThreads": "256"},
    "rpt2": {"kMaxRowsPerThread": "2"},
    "minblocks528": {"kMinBlocks": "528"},
}


def built_gather(src: Path, tag: str, gather_py: Path, consts=None):
    """A gather module of gather_py whose kernel is src (its constants
    rewritten by consts) built with the entry point renamed
    tpumd_row_gather_<tag>, into build/p1_compare/."""
    from tpumd_torch.ops import _build
    text = src.read_text()
    for name, value in (consts or {}).items():
        text, n = re.subn(rf"(constexpr [\w ]+ {name} = )[^;]+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise SystemExit(f"p1_compare: no constant {name} in {src}")
    out = ROOT / "build" / "p1_compare"
    out.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(text.encode()).hexdigest()[:12]
    cu = out / f"{tag}_{digest}.cu"
    so = cu.with_suffix(".so")
    if not so.exists():
        cu.write_text(text)
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
             f"-Dtpumd_row_gather=tpumd_row_gather_{tag}", "-o", str(so),
             str(cu)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    bound = {}

    def kernel_function(name, argtypes, restype=ctypes.c_int):
        if name not in bound:
            fn = getattr(lib, f"{name}_{tag}")
            fn.argtypes, fn.restype = argtypes, restype
            bound[name] = fn
        return bound[name]
    mod = _load(gather_py, f"gather_{tag}")
    mod._build = types.SimpleNamespace(kernel_function=kernel_function)
    return mod


def recorded_inputs():
    """{name: (table, idx)} of the matrix engine's real P1 inputs on
    IN_SALT32K and IN_HYB32K at their f32 set-ups."""
    from tpumd_torch import bench_targets as bt
    got = {}
    seen = {}
    salt = cs.salt_setup(bt.IN_SALT32K, torch.float32)
    with cs.recording_p1(seen):
        salt.run_string("run 0")
    n = salt.sim.natoms
    got["IN_SALT32K packed j rows"] = next(
        v for (d, t, _), v in seen.items() if d == torch.float32
        and t == (n, 5))
    del salt
    seen = {}
    with tempfile.TemporaryDirectory() as tmpdir:
        data = Path(tmpdir) / "data.hyb"
        bt.hyb_cell(data)
        hyb = cs.hyb_setup(data, bt.HYB32K_REPLICAS, torch.float32)
        with cs.recording_p1(seen):
            hyb.run_string("run 0")
    n = hyb.sim.natoms
    got["IN_HYB32K packed j rows"] = [
        v for (d, t, i), v in seen.items() if d == torch.float32
        and t[0] == n and t[1] in (4, 5) and len(i) == 2 and i[0] == n][-1]
    view = next(v for (d, t, i), v in seen.items()
                if d == torch.float32 and t == (n, 3))[0]
    style, tuples = next((st, t) for st, t in hyb.sim._bonded_dev
                         if st.kind == "dihedral")
    mem = tuples[:, 1:1 + style.arity].contiguous()
    got["IN_HYB32K dihedral members (M, 4)"] = (view, mem)
    got["IN_HYB32K dihedral member (M,)"] = (view,
                                             mem[:, 0].contiguous())
    del hyb
    torch.cuda.empty_cache()
    return got


def all_shapes(gen):
    shapes = {}
    for width in (128, 16):
        table = torch.randn((cs.P1_ROWS, width), generator=gen,
                            device="cuda")
        idx = torch.randint(0, cs.P1_ROWS, (cs.P1_GATHERED,), generator=gen,
                            device="cuda", dtype=torch.int32)
        shapes[f"probe L={width}"] = (table, idx)
    for c in cs.P1_MAIN_SHAPES:
        d, r, w, sh = c[:4]
        shapes[f"main {str(d)[6:]} {r} x {w} at {sh}"] = cs.p1_case(
            gen, d, r, w, sh)
    shapes.update(recorded_inputs())
    return shapes


def index_stats(table, idx) -> dict:
    """Padding share (an index equal to its row of the (N, K) matrix) and
    the distinct 128-byte table lines 32 consecutive indices touch."""
    row_bytes = table.shape[1] * table.element_size()
    flat = idx.reshape(-1).long()
    out = {}
    if idx.dim() == 2:
        own = torch.arange(idx.shape[0], device=idx.device)[:, None]
        out["padding_share"] = float((idx == own).float().mean())
    m = flat.numel() // 32 * 32
    first = (flat[:m] * row_bytes // 128).view(-1, 32)
    last = ((flat[:m] * row_bytes + row_bytes - 1) // 128).view(-1, 32)
    lines = torch.cat([first, last], dim=1).sort(dim=1).values
    out["lines_per_warp"] = float(
        (1 + (lines[:, 1:] != lines[:, :-1]).sum(dim=1)).float().mean())
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--diagnose", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--json", type=Path)
    args = ap.parse_args()
    smi = cs.environment()
    from tpumd_torch.ops import _build, gather
    lib = _build.load()
    print(f"[p1] build {'cached' if lib.cached else 'cold'} "
          f"{lib.seconds:.2f} s; ptxas: " + " | ".join(
              ln.strip() for ln in lib.ptxas_log.splitlines()
              if "row_gather" in ln or "Used" in ln)[-2000:], flush=True)
    here = ROOT / "tpumd_torch"
    kerns = {"parent": gather}
    if args.parent:
        kerns["parent"] = built_gather(
            args.parent / "tpumd_torch" / "csrc" / "row_gather.cu", "parent",
            args.parent / "tpumd_torch" / "ops" / "gather.py")
    kerns["this tree"] = gather
    if args.variants:
        for tag, consts in VARIANTS.items():
            try:
                kerns[tag] = built_gather(here / "csrc" / "row_gather.cu",
                                          tag, here / "ops" / "gather.py",
                                          consts)
            except RuntimeError as err:
                print(f"[p1] variant {tag}: {err}", flush=True)
    other = kerns["parent"]
    gen = torch.Generator(device="cuda").manual_seed(2026)
    shapes = all_shapes(gen)
    results = {}
    for name, (table, idx) in shapes.items():
        ref = gather.gather_rows_plain(table, idx)
        for tag, mod in kerns.items():
            out = mod.gather_rows(table, idx)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(f"{name}: {tag} differs from plain")
        del out, ref

        def fn(mod):
            return lambda: mod.gather_rows(table, idx)
        order = list(kerns) + list(kerns)[::-1]
        times = {}
        for tag in order:
            times.setdefault(tag, []).append(cs.cuda_ms(fn(kerns[tag]), 200))
        t = times["parent"][:1] + times["this tree"] + times["parent"][1:]
        lib_ms = cs.cuda_ms(lambda: torch.index_select(
            table, 0, idx.view(-1)), 200)
        nbytes = (table.numel() * table.element_size() + 4 * idx.numel()
                  + idx.numel() * table.shape[1] * table.element_size())
        bound_ms, _ = cs.roof(0, nbytes)
        # host us a call: five rounds of 100 calls each, the least and the
        # median
        host = {}
        for tag in ("parent", "this tree"):
            rounds = sorted(cs.host_us(fn(kerns[tag])) for _ in range(5))
            host[tag] = (rounds[0], rounds[2])
        r = {"table": list(table.shape), "dtype": str(table.dtype)[6:],
             "idx": list(idx.shape), "parent_ms": [t[0], t[3]],
             "ms": [t[1], t[2]], "index_select_ms": lib_ms,
             "bound_ms": bound_ms, "bytes": nbytes,
             "host_us_parent": host["parent"], "host_us": host["this tree"],
             "variants_ms": {k: v for k, v in times.items()
                             if k not in ("parent", "this tree")}}
        print(f"[p1] {name}: table {tuple(table.shape)} "
              f"{r['dtype']}, idx {tuple(idx.shape)}: parent {t[0]:.4f} / "
              f"{t[3]:.4f} ms, this tree {t[1]:.4f} / {t[2]:.4f} ms, "
              f"index_select {lib_ms:.4f} ms, bound {bound_ms:.6f} ms "
              f"({nbytes} B); host us a call (least, median of 5 rounds): "
              f"parent {host['parent'][0]:.1f}, {host['parent'][1]:.1f}; "
              f"this tree {host['this tree'][0]:.1f}, "
              f"{host['this tree'][1]:.1f}" + "".join(
                  f"; {k} " + " / ".join(f"{x:.4f}" for x in v) + " ms"
                  for k, v in r["variants_ms"].items()), flush=True)
        if args.diagnose and "packed" in name:
            r.update(index_stats(table, idx))
            out = torch.empty(tuple(idx.shape) + (table.shape[1],),
                              dtype=table.dtype, device="cuda")
            src = torch.empty_like(out)
            zeros = torch.zeros_like(idx)
            srt = idx.view(-1).sort().values.view(idx.shape).contiguous()
            r["fill_ms"] = cs.cuda_ms(lambda: out.fill_(1.0), 200)
            r["copy_ms"] = cs.cuda_ms(lambda: out.copy_(src), 200)
            for tag, ix in (("zeros", zeros), ("sorted", srt)):
                r[f"{tag}_ms"] = [cs.cuda_ms(
                    lambda m=m, ix=ix: m.gather_rows(table, ix), 200)
                    for m in (other, gather)]
            print(f"[p1] {name} diagnosis: " + ", ".join(
                f"{k} {v}" for k, v in r.items()
                if k not in ("table", "dtype", "idx")), flush=True)
            del out, src, zeros, srt
        results[name] = r
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(
            {"card": smi, "parent": str(args.parent), "shapes": results},
            indent=1))
    print(smi, flush=True)


if __name__ == "__main__":
    main()

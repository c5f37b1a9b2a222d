"""The slices of several checkouts of the repo on one card, timed alike:
each slice's kernel times beside their plain versions, and its 32k deck's
timesteps/s, device busy and operations a step.

Run from the repository root:
``python3 probes/tree_compare.py [--phases P,...] DIR [DIR ...]``, for
example with an older commit unpacked by ``git archive`` into a
git-ignored directory:
``python3 probes/tree_compare.py build/parent . . build/parent``.

Each DIR runs in a process of its own (each imports its own
``tpumd_torch``), in the order given.  The process builds DIR's kernels,
loads DIR's ``chip_smoke.py``, gives it this checkout's
``chip_smoke.cuda_ms`` (CUDA events around many calls queued behind a spin
kernel) where its own timer differs, and runs DIR's phases of each slice
named in --phases (default all, in this order): lj (``lj_kernel_vs_plain``,
B1 against its plain versions, timed, and ``main_path``, the 32k in.lj
deck: gates, 500 timed steps, a profile of 100 steps), eam
(``eam_kernels_vs_plain``, B3 and B4, and ``eam_main_path``), chain
(``fene_kernel_vs_plain``, B2, and ``chain_main_path``), chute
(``gran_kernel_vs_plain``, B6, and ``chute_main_path``) and rhodo
(``charmm_kernel_vs_plain``, B5 and the list build, and
``rhodo_main_path``), whose lines it prints under a header naming DIR; a
check of DIR's own that fails is printed, and its next slice runs.  Ends
with the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import inspect
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("lj", "eam", "chain", "chute", "rhodo")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one(tree: Path, phases):
    """DIR's kernel phases and main paths of the slices in phases."""
    sys.path.insert(0, str(tree))
    timer = _load(ROOT / "chip_smoke.py", "smoke_timer").cuda_ms
    smoke = _load(tree / "chip_smoke.py", "smoke_tree")
    if "ahead" not in inspect.signature(smoke.cuda_ms).parameters:
        # an older chip_smoke.py times plain versions over at most 10
        # calls, which may wait on the card, and kernels over 50 or more
        smoke.cuda_ms = lambda fn, reps: timer(fn, reps, ahead=reps >= 50)
    import tpumd_torch
    if Path(tpumd_torch.__file__).resolve().parents[1] != tree.resolve():
        raise AssertionError(f"imported {tpumd_torch.__file__}, not the "
                             f"package of {tree}")
    from tpumd_torch.ops import _build
    lib = _build.load()
    smi = smoke.environment()
    print(f"[tree] {tree}: build {'cached' if lib.cached else 'cold'} "
          f"{lib.seconds:.2f} s", flush=True)
    times = {}

    def run(slice_name, kernel, main):
        """A slice's kernel phase and main path; a check of DIR's that
        fails is printed and the next slice runs."""
        try:
            out = kernel()
            times.update(out)
            main()
        except AssertionError as err:
            print(f"[tree] {tree}: {slice_name}: DIR's check failed: {err}",
                  flush=True)

    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        if "lj" in phases:
            run("lj", lambda: {"B1": smoke.lj_kernel_vs_plain()},
                lambda: smoke.main_path(smi))
        if "eam" in phases:
            run("eam", lambda: dict(zip(("B3", "B4"),
                                        smoke.eam_kernels_vs_plain(tmp))),
                lambda: smoke.eam_main_path(tmp, smi))
        if "chain" in phases:
            run("chain", lambda: {"B2": smoke.fene_kernel_vs_plain(tmp)},
                lambda: smoke.chain_main_path(tmp, smi))
        if "chute" in phases:
            run("chute", lambda: {"B6": smoke.gran_kernel_vs_plain(
                tmp, lib.ptxas_log)}, lambda: smoke.chute_main_path(tmp, smi))
        if "rhodo" in phases:
            run("rhodo", lambda: {"B5": smoke.charmm_kernel_vs_plain(
                lib.ptxas_log)[0]}, lambda: smoke.rhodo_main_path(smi))
    print(f"[tree] {tree}: " + ", ".join(
        f"{k} {v['ms']:.4f} ms (plain {v['plain_ms']:.4f})"
        for k, v in sorted(times.items())), flush=True)


def main():
    args = sys.argv[1:]
    if len(args) >= 2 and args[0] == "--one":
        one(Path(args[1]), args[2].split(","))
        return
    phases = PHASES
    if len(args) >= 2 and args[0] == "--phases":
        phases = tuple(args[1].split(","))
        args = args[2:]
        if not set(phases) <= set(PHASES):
            raise SystemExit(f"tree_compare: phases of {PHASES}")
    trees = [Path(a) for a in args]
    if not trees:
        raise SystemExit(__doc__)
    for tree in trees:
        if not (tree / "chip_smoke.py").is_file():
            raise SystemExit(f"tree_compare: no chip_smoke.py in {tree}")
    for tree in trees:
        print(f"== {tree}", flush=True)
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--one", str(tree.resolve()), ",".join(phases)],
                       check=True, cwd=tree)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)


if __name__ == "__main__":
    main()

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
check of DIR's own that fails is printed, and its next slice runs.  Each
list build that DIR's ``time_build`` checks and times is then timed again
alike on every tree, by this checkout's ``cuda_ms`` with DIR's own
wrapper: the kernel alone (its hold and status words made once, as a
re-bin makes them; ``kernel_ms``) and the whole wrapper call (the hold
made anew; ``call_ms``), each the lesser of two rounds of 50 calls, so
that trees whose ``chip_smoke.py`` time the build differently compare on
one measure.  Then a line of DIR's kernel times: B1-B6, each deck's list
build and the refresh's gate and rebuilding call where the main path
times them.  Ends with the card's name and power limit.
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


def _alike(time_build, timer):
    """DIR's time_build, followed by the build's kernel_ms and call_ms
    timed alike on every tree (the module's head comment)."""
    def timed(name, bargs, *args, **kwargs):
        out = time_build(name, bargs, *args, **kwargs)
        from tpumd_torch.ops.cellgrid_pairlist import cellgrid_pairlist, \
            new_stat, pairlist_hold
        hold = pairlist_hold(*bargs[:5], bargs[6], *bargs[8:10], keep=False)
        stat = new_stat(bargs[0].device)
        out["kernel_ms"] = min(timer(lambda: cellgrid_pairlist(
            *bargs, stat=stat, hold=hold), 50) for _ in range(2))
        out["call_ms"] = min(timer(lambda: cellgrid_pairlist(*bargs), 50)
                             for _ in range(2))
        print(f"[tree] {name} build timed alike: kernel alone "
              f"{out['kernel_ms']:.4f} ms, the whole call "
              f"{out['call_ms']:.4f} ms", flush=True)
        return out
    return timed


def one(tree: Path, phases):
    """DIR's kernel phases and main paths of the slices in phases."""
    sys.path.insert(0, str(tree))
    timer = _load(ROOT / "chip_smoke.py", "smoke_timer").cuda_ms
    smoke = _load(tree / "chip_smoke.py", "smoke_tree")
    if "ahead" not in inspect.signature(smoke.cuda_ms).parameters:
        # an older chip_smoke.py times plain versions over at most 10
        # calls, which may wait on the card, and kernels over 50 or more
        smoke.cuda_ms = lambda fn, reps: timer(fn, reps, ahead=reps >= 50)
    smoke.time_build = _alike(smoke.time_build, timer)
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

    def run(slice_name, kernel, main, deck=None):
        """A slice's kernel phase and main path (with deck, the list's
        upkeep that the main path timed: main returns it); a check of
        DIR's that fails is printed and the next slice runs."""
        try:
            times.update(kernel())
            upkeep = main()
            if deck is not None:
                times.update({f"{deck} {k}": v for k, v in upkeep.items()})
        except AssertionError as err:
            print(f"[tree] {tree}: {slice_name}: DIR's check failed: {err}",
                  flush=True)

    def chain():
        b2 = smoke.fene_kernel_vs_plain(tmp)
        return {"B2": b2, "chain build": b2["list"]}

    def chute():
        b6 = smoke.gran_kernel_vs_plain(tmp, lib.ptxas_log)
        return {"B6": b6, "chute build": b6["list"]}

    def rhodo():
        b5, build = smoke.charmm_kernel_vs_plain(lib.ptxas_log)
        return {"B5": b5, "rhodo_class build": build}

    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        if "lj" in phases:
            run("lj", lambda: {"B1": smoke.lj_kernel_vs_plain()},
                lambda: smoke.main_path(smi)["upkeep"], "in.lj")
        if "eam" in phases:
            run("eam", lambda: dict(zip(("B3", "B4"),
                                        smoke.eam_kernels_vs_plain(tmp))),
                lambda: smoke.eam_main_path(tmp, smi)[2]["upkeep"], "eam")
        if "chain" in phases:
            run("chain", chain, lambda: smoke.chain_main_path(tmp, smi))
        if "chute" in phases:
            run("chute", chute, lambda: smoke.chute_main_path(tmp, smi))
        if "rhodo" in phases:
            run("rhodo", rhodo, lambda: smoke.rhodo_main_path(smi)["upkeep"],
                "rhodo_class")
    print(f"[tree] {tree}: " + ", ".join(
        f"{k} {v['ms']:.4f} ms"
        + (f" (timed alike: the kernel alone {v['kernel_ms']:.4f}, the "
           f"whole call {v['call_ms']:.4f})" if "kernel_ms" in v else "")
        + f" (plain {v['plain_ms']:.4f})"
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

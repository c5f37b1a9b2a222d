"""The chain and chute slices of several checkouts of the repo on one card,
timed alike: B2's and B6's kernel times beside their plain versions, and
the two 32k decks' timesteps/s, device busy and operations a step.

Run from the repository root:
``python3 probes/tree_compare.py DIR [DIR ...]``, for example with an
older commit unpacked by ``git archive`` into a git-ignored directory:
``python3 probes/tree_compare.py build/parent . . build/parent``.

Each DIR runs in a process of its own (each imports its own
``tpumd_torch``), in the order given.  The process builds DIR's kernels,
loads DIR's ``chip_smoke.py``, gives it this checkout's
``chip_smoke.cuda_ms`` (CUDA events around many calls queued behind a spin
kernel) where its own timer differs, and runs DIR's phases
``fene_kernel_vs_plain`` (B2 against its plain versions, timed),
``chain_main_path``, ``gran_kernel_vs_plain`` (B6) and
``chute_main_path`` (gates, 500 timed steps, a profile of 100 steps),
whose lines it prints under a header naming DIR.  Ends with the card's
name and power limit.
"""

from __future__ import annotations

import importlib.util
import inspect
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one(tree: Path):
    """DIR's B2 and B6 phases and chain and chute main paths."""
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
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        fene = smoke.fene_kernel_vs_plain(tmp)
        smoke.chain_main_path(tmp, smi)
        gran = smoke.gran_kernel_vs_plain(tmp, lib.ptxas_log)
        smoke.chute_main_path(tmp, smi)
    print(f"[tree] {tree}: B2 {fene['ms']:.4f} ms (plain "
          f"{fene['plain_ms']:.4f}), B6 {gran['ms']:.4f} ms (plain "
          f"{gran['plain_ms']:.4f})", flush=True)


def main():
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        one(Path(sys.argv[2]))
        return
    trees = [Path(a) for a in sys.argv[1:]]
    if not trees:
        raise SystemExit(__doc__)
    for tree in trees:
        if not (tree / "chip_smoke.py").is_file():
            raise SystemExit(f"tree_compare: no chip_smoke.py in {tree}")
    for tree in trees:
        print(f"== {tree}", flush=True)
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--one", str(tree.resolve())], check=True, cwd=tree)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)


if __name__ == "__main__":
    main()

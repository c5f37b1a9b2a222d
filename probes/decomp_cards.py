"""The decomposed runs of ``chip_smoke.py``'s ``decomp_path`` across every
card of the host, beside the one-card lj864 run of the same call.

Run from the repository root on a host with several cards:
``python3 probes/decomp_cards.py``.  It builds the
kernels, runs ``chip_smoke.script_lj864_path`` (the one-card lj864 run:
its step-0 row and timesteps/s) and then ``chip_smoke.decomp_run_phase``
with min(4, the card count) NCCL ranks, one card each, and prints the
phase's lines and its launch counts.
"""

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    import torch
    import chip_smoke as cs
    from tpumd_torch.ops import _build
    smi = cs.environment()
    _build.load()
    print(f"cards {torch.cuda.device_count()}", flush=True)
    one = cs.script_lj864_path(smi)
    with tempfile.TemporaryDirectory() as d:
        print(cs.decomp_run_phase(Path(d), smi, one), flush=True)


if __name__ == "__main__":
    main()

"""LJ + FENE over the cell grid's pair list, on the CPU.

Generated chain decks (``bench_targets.chain_data`` + ``IN_CHAIN``: FENE
bead-spring chains, special_bonds fene, lj/cut 1.12 shifted, cutneigh
1.52) after set-up on the port, f64:

* "500": 20 chains of 25 on a 5^3 grid, as set up;
* "60": 6 chains of 10 on a 2^3 grid, as set up (every neighbour cell met
  at two images);
* "stretched": the 60-atom deck with the first bond stretched to 2 sigma,
  past cutneigh, so the list does not hold it (bond_fene takes it up to
  2 R0, the clamp of its log argument reached);
* "across_face": the 500-atom deck moved by half the box along x and
  wrapped, so bonds straddle the periodic x face.

* The set-up's list codes exactly the bond partners within cutneigh at 1,
  and the bond slots name the partners.
* The plain list sweep equals the stencil oracle ``lj_fene_cellgrid_plain``
  (forces to 1e-12 of max|f|, lj and bond energies and virial to 1e-12
  relative) with every energy/virial flag.
* On the chain slice the run takes only the list path: one plain build
  per grid set-up and rebuild, one list sweep per force evaluation, no
  stencil sweep and no refresh (its schedule checks every step); in.lj
  sweeps a list of its own, without bond slots, and no LJ+FENE kernel.
"""

import numpy as np
import pytest
import torch

from tpumd_torch.bench_targets import IN_CHAIN, IN_LJ, chain_data
from tpumd_torch.ops import cellgrid as cg
from tpumd_torch.ops import cellgrid_pairlist as bpl
from tpumd_torch.ops import lj_cellgrid as b1
from tpumd_torch.ops import lj_fene_cellgrid as b2
from tpumd_torch.script.parser import LammpsScript

torch.set_num_threads(2)

DECKS = {"500": (500, 25), "60": (60, 10), "stretched": (60, 10),
         "across_face": (500, 25)}
FLAGS = ((1, 1), (0, 0), (1, 0), (0, 1))


def _script(tmp_path, natoms, chain_len):
    path = tmp_path / "data.chain"
    chain_data(path, natoms, chain_len)
    script = LammpsScript(device="cpu", dtype=torch.float64)
    script.run_string(IN_CHAIN.format(data=path))
    script.sim.verbose = False
    return script


def _stretched(x, L, a, b, r=2.0):
    """x with row b moved to distance r of row a: of 256 seeded directions
    the one farthest from every other atom, wrapped into the box."""
    u = np.random.default_rng(4).normal(size=(256, 3))
    cand = x[a] + r * u / np.linalg.norm(u, axis=1, keepdims=True)
    others = np.delete(x, [a, b], axis=0)
    d = cand[:, None, :] - others[None]
    d -= L * np.round(d / L)
    best = cand[np.argmax(np.linalg.norm(d, axis=-1).min(1))]
    out = x.copy()
    out[b] = best % L
    return out


def _grid(tmp_path, case):
    """(sim, grid-ordered state, grid state) of a case after set-up; the
    moved cases are re-binned by the set-up's own grid code."""
    script = _script(tmp_path, *DECKS[case])
    script.run_string("run 0")
    sim = script.sim
    s, neigh, _ = sim._carry
    if case in ("500", "60"):
        return sim, s, neigh
    c = cg.compact_state(s, neigh.valid, sim.natoms)
    x, tag = c.x.numpy(), c.tag.numpy()
    L = c.box.lengths.numpy()
    if case == "stretched":
        rows = {int(t): k for k, t in enumerate(tag)}
        x = _stretched(x, L, rows[2], rows[1])
    else:
        x = x.copy()
        x[:, 0] = (x[:, 0] + 0.5 * L[0]) % L[0]
    s, neigh = sim._grid_setup(c.replace(x=torch.as_tensor(x)))
    return sim, s, neigh


def _bond_d(s, neigh):
    """(minimum-image distances, raw |dx|) of every bond seen from each of
    its atoms."""
    bs = neigh.bond_slots
    i, k = torch.nonzero(bs >= 0, as_tuple=True)
    j = bs[i, k].long()
    raw = s.x[i] - s.x[j]
    L = s.box.lengths
    d = raw - L * torch.round(raw / L)
    return d.norm(dim=1), raw[:, 0].abs()


@pytest.mark.parametrize("case", sorted(DECKS))
def test_plain_list_sweep_matches_stencil_oracle(case, tmp_path):
    sim, s, neigh = _grid(tmp_path, case)
    cfg = sim._neigh_cfg
    assert cfg.cutneigh == pytest.approx(1.52)
    assert (min(cfg.nx, cfg.ny, cfg.nz) == 2) == (DECKS[case][0] == 60)
    # the bond slots hold the partners' tags; code 1 marks exactly the
    # partners within cutneigh
    bs = neigh.bond_slots
    named = torch.where(bs >= 0, s.tag[bs.long().clamp(min=0)], 0)
    assert torch.equal(named, s.bond_tags)
    j, code = bpl.unpack(neigh.pairs)
    live = (torch.arange(neigh.pairs.shape[1])[None, :]
            < neigh.npairs[:, None])
    partner = (j[..., None] == bs[:, None, :]).any(-1)
    assert torch.equal((code == 1) & live, partner & live)
    assert int((code[live] == 1).sum()) > 0
    dist, raw = _bond_d(s, neigh)
    if case == "stretched":
        long = dist > cfg.cutneigh
        assert int(long.sum()) == 2
        assert float(dist[long].max()) == pytest.approx(2.0, rel=1e-12)
        # the stretched bond is not in the list
        assert int((partner & live & (code == 1)).sum()) == int(
            (dist <= cfg.cutneigh).sum())
    if case == "across_face":
        assert int((raw > 0.5 * float(s.box.lengths[0])).sum()) >= 10
    lj = sim.pair.kernel_coeffs()
    fene = sim._ctx.kernel_bond.kernel_coeffs()
    for ef, vf in FLAGS:
        out = b2.lj_fene_pairlist_plain(s.x, s.box, lj, fene, ef, vf,
                                        neigh.pairs, neigh.npairs, bs)
        ref = b2.lj_fene_cellgrid_plain(s.x, neigh.valid, s.tag,
                                        s.bond_tags, s.box, cfg, lj, fene,
                                        ef, vf)
        fmax = float(ref[0].abs().max())
        assert float((out[0] - ref[0]).abs().max()) <= 1e-12 * fmax
        for a, b in zip(out[1:], ref[1:]):
            assert (a is None) == (b is None)
            if b is not None:
                assert float((a - b).abs().max()) <= 1e-12 * float(
                    b.abs().max())
        if ef:
            assert float(out[3]) > 10 * abs(float(out[1]))


def test_chain_takes_the_list_path_and_in_lj_does_not(tmp_path,
                                                      monkeypatch):
    """20 steps of the 500-atom chain deck (rebuilds on the displacement
    check every few steps): a plain build per grid set-up and rebuild, a
    list sweep per force evaluation, no stencil sweep, no refresh; then
    in.lj on a 4^3 lattice takes B1's list path, not the chain's: a list
    without bond slots, no LJ+FENE sweep."""
    calls = []

    def stencil(*a, **k):
        calls.append(1)
        raise AssertionError("the chain deck swept the stencil")
    monkeypatch.setattr(b2, "lj_fene_cellgrid_plain", stencil)
    monkeypatch.setattr(b2, "cellgrid_pair_sums", stencil)
    for c in (b1.counts, b2.counts, bpl.counts, bpl.refresh_counts):
        c.reset()
    script = _script(tmp_path, 500, 25)
    script.run_string("run 20")
    sim = script.sim
    rebuilds = int(sim._carry[1].nbuilds) - 1
    assert rebuilds >= 2
    # set-up, 20 in-step evaluations and the final thermo evaluation
    assert b2.counts.plain_calls == 1 + 20 + 1
    assert bpl.counts.plain_calls == sim.grid_setups + rebuilds
    assert not calls and b1.counts.plain_calls == 0
    assert b2.counts.kernel_launches == bpl.counts.kernel_launches == 0
    assert not sim._ctx.pairlist_refresh
    assert bpl.refresh_counts.plain_calls == 0 and sim.list_refreshes == 0
    # the box is fixed: the rebuild check carries no box corners
    assert sim._carry[1].lohold is None and sim._carry[1].hihold is None
    n0, m0 = bpl.counts.plain_calls, b2.counts.plain_calls
    lj = LammpsScript(device="cpu", dtype=torch.float64)
    lj.run_string(IN_LJ.format(n=4) + "run 20\n")
    neigh = lj.sim._carry[1]
    assert lj.sim._ctx.pairlist_k > 0 and neigh.bond_slots is None
    assert bpl.counts.plain_calls > n0 and b1.counts.plain_calls > 0
    assert b2.counts.plain_calls == m0

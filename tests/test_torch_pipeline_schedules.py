"""paddle_tpu_torch's pipeline schedules against the JAX package's
(``distributed/pipeline_schedules.py``).

* ``schedule_grid`` equals the reference's exactly for S in {2, 4} and
  m in {2, 4, 8}, with and without zero bubble, and the zero-bubble grid
  has strictly fewer idle (device, tick) slots, with every unit once
  (``tests/test_pipeline_schedules.py:345``).
* The executor's unit placement at v = 1 is that grid.
* On 4 gloo ranks, the executor (1F1B, interleaved, zero bubble, GPipe)
  on the reference tests' toy pipeline (``_mlp_setup``: tanh layers
  between an embedding and a CE head) gives the sequential autograd
  loss and grads (2e-5 relative on the loss, 2e-4 + 2e-5 absolute on
  the grads, the reference tests' tolerances), and each device holds at
  most 2·v·S forward graphs at once, whatever m — the reference's ring
  of stage inputs (``tests/test_pipeline_schedules.py:97``).
"""
import numpy as np
import pytest
import torch

from paddle_tpu.distributed.pipeline_schedules import \
    schedule_grid as j_schedule_grid
from paddle_tpu_torch.distributed import pipeline_schedules as PS

import torch_hybrid_ranks as R


@pytest.mark.parametrize("zb", [False, True])
@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("S", [2, 4])
def test_schedule_grid_is_the_reference(S, m, zb):
    grid = PS.schedule_grid(S, m, zero_bubble=zb)
    assert grid == j_schedule_grid(S, m, zero_bubble=zb)
    if zb and m < S:    # the executor refuses it, as the reference's does
        with pytest.raises(ValueError, match="n_micro >= pp"):
            PS.placement(S, m, 1, "zb")
        return
    # the executor places its units on the same grid
    T, units = PS.placement(S, m, 1, "zb" if zb else "1f1b")
    assert T == len(grid[0])
    kinds = {"F": {"F"}, "B": {"B", "W"}, "Bx": {"B"}, "W": {"W"}}
    for s in range(S):
        for t in range(T):
            got = set()
            for kind, _, _ in units[s][t]:
                got |= kinds[kind]
            assert got == grid[s][t], (s, t)


@pytest.mark.parametrize("S,m", [(2, 4), (4, 8), (8, 8)])
def test_zero_bubble_grid_has_fewer_idle_ticks(S, m):
    def idle(grid):
        return sum(1 for row in grid for units in row if not units)

    def count(grid, u):
        return sum(u in units for row in grid for units in row)
    g1 = PS.schedule_grid(S, m)
    gz = PS.schedule_grid(S, m, zero_bubble=True)
    assert idle(gz) < idle(g1)
    assert (idle(g1), idle(gz)) == (idle(j_schedule_grid(S, m)),
                                    idle(j_schedule_grid(S, m, True)))
    for u in ("F", "B", "W"):
        assert count(g1, u) == count(gz, u) == S * m


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = R.RankPool(4, tmp_path_factory.mktemp("gloo"))
    yield pool
    pool.close()


def sequential(S, v, m):
    """The loss and grads of the same model by autograd in one process."""
    layers, embed, head, ids, lab = R.mlp_setup(S, v, m)
    ws = [torch.from_numpy(w).requires_grad_() for w in layers]
    fp = {"embed": torch.from_numpy(embed).requires_grad_()}
    lp = {"head": torch.from_numpy(head).requires_grad_()}
    stage_fn, first_fn, last_fn = R.mlp_fns()
    loss = sum(last_fn(lp, stage_fn([{"w": w} for w in ws],
                                    first_fn(fp, (torch.from_numpy(ids[j]),))),
                       (None, torch.from_numpy(lab[j])))
               for j in range(m))
    grads = torch.autograd.grad(loss, ws + [fp["embed"], lp["head"]])
    return float(loss.detach()), [g.numpy() for g in grads]


@pytest.mark.parametrize("S,v,m,schedule", [
    (4, 1, 4, "1f1b"), (2, 1, 5, "1f1b"), (4, 2, 8, "1f1b"),
    (2, 3, 4, "1f1b"), (2, 1, 12, "1f1b"), (4, 1, 4, "zb"),
    (2, 1, 5, "zb"), (2, 2, 4, "zb"), (2, 3, 6, "zb"), (4, 1, 6, "gpipe")])
def test_executor_matches_sequential(ranks, S, v, m, schedule):
    ref_loss, ref = sequential(S, v, m)
    out = ranks.run("mlp_pipeline", S=S, v=v, m=m, schedule=schedule)
    lps = 2
    for r in out:
        np.testing.assert_allclose(r["loss"], ref_loss, rtol=2e-5)
        np.testing.assert_allclose(r["d_embed"], ref[-2], rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(r["d_head"], ref[-1], rtol=2e-4,
                                   atol=2e-5)
        assert r["stats"]["max_in_flight"] <= (
            m if schedule == "gpipe" else 2 * v * S)
    for rank, r in enumerate(out):
        s = rank // (4 // S)
        for c, chunk in enumerate(r["d_stage"]):
            for i, g in enumerate(chunk):
                np.testing.assert_allclose(
                    g, ref[(c * S + s) * lps + i], rtol=2e-4, atol=2e-5)

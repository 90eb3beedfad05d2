"""The dense MoE on the experts stored along ``model`` (the sharded
serving steps, ``models.moe``), on four gloo ranks (tests/_dist_ranks.py,
``(data, model)`` = (2, 2)) against the reference's ``make_prefill_step``
/ ``make_serve_step`` on the same weights: reduced kimi-k2 (4 experts, a
shared expert) and reduced jamba-v0.1 (4 experts, capacity factor 16),
``moe_shard_map`` off, so that both the prefill and the decode steps run
the dense form.  Each ``model`` rank routes the global rows as the dense
form does, runs its 2 experts and sums its partial output over
``model``; the experts are gathered over ``data`` only.

* Every step's logits within the bars of
  tests/test_torch_sharded_steps_gathered.py (``ATOL`` 5e-6 of the
  reference's, at most ``FLIPS`` flipped link codes a step, the
  reference's link outputs carried by ``D.pinned_link``), greedy tokens
  equal to the reference's.
* The tally: no expert tensor all-gathered along ``model`` in any step;
  each is all-gathered over ``data`` as the rank's ``E / 2`` experts.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _dist_ranks as D  # noqa: E402

ATOL = 5e-6
FLIPS = 4
CASES = [("kimi-k2-1t-a32b", {}), ("jamba-v0.1-52b", {"capacity_factor": 16.0})]
IDS = [a for a, _ in CASES]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    return [D.reference_serve(arch, **over) for arch, over in CASES]


@pytest.fixture(scope="module")
def four_ranks(reference, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    runs = []
    for i, ((arch, over), ref) in enumerate(zip(CASES, reference)):
        torch.save(ref[2], tmp / f"links_{i}.pt")
        runs.append(dict(arch=arch, model_axis=2, cfg_over=over, forced=ref[1][:, :D.SERVE_STEPS].tolist(),
                         pinned=str(tmp / f"links_{i}.pt")))
    ranks = D.run_ranks("serve", 4, tmp, runs=runs)
    return [[r[i] for r in ranks] for i in range(len(runs))]


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_dense_moe_on_stored_experts_matches_the_reference(reference, four_ranks, case):
    ranks = four_ranks[case]
    D.same_on_every_rank(ranks)
    ref_logits, ref_tokens, _ = reference[case]
    for i, (got, want) in enumerate(zip(ranks[0]["logits"], ref_logits)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL, err_msg=f"step {i}")
    np.testing.assert_array_equal(torch.cat(ranks[0]["tokens"], dim=1).numpy(), ref_tokens)
    for r in ranks:
        assert len(r["flips"]) == D.SERVE_STEPS + 1 and max(r["flips"]) <= FLIPS, r["flips"]


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_no_expert_is_gathered_along_model(four_ranks, case):
    arch, over = CASES[case]
    cfg = D._cfg(arch, **over)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_dff or cfg.d_ff
    moe_layers = sum(spec.moe for spec in cfg.all_layers())
    whole = {(e, dd, f) for dd in (d, d // 2)} | {(e, f, dd) for dd in (d, d // 2)}
    for r in four_ranks[case]:
        for step in r["step_shapes"]:
            gathers = [(axes, shape) for kind, axes, shape in step if kind == "all-gather"]
            assert not [s for axes, s in gathers if axes == "model" and s in whole], gathers
            local = [s for axes, s in gathers if axes == "data" and s in {(e // 2, d, f), (e // 2, f, d)}]
            assert len(local) == 3 * moe_layers, (len(local), moe_layers)

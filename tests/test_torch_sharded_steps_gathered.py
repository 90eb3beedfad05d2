"""The layers the sharded serving steps run on gathered parameters under
``model`` 2 (ROADMAP A13d makes them tensor parallel), on four gloo ranks
(tests/_dist_ranks.py, ``(data, model)`` = (2, 2)) against the reference's
``make_prefill_step`` / ``make_serve_step`` on the same weights
(``params_to_jax``), as tests/test_torch_sharded_steps_ranks.py does for
qwen1.5-0.5b: a prompt of ``D.SERVE_P`` tokens into a cache of
``D.SERVE_S`` rows at batch ``D.SERVE_B``, then ``D.SERVE_STEPS`` decode
steps fed the reference's greedy tokens, with the cfg's serving link.

* reduced jamba-v0.1: Mamba layers (their ``conv`` / ``ssm`` states
  placed on ``model`` by ``rules.cache_pspecs``, gathered for the step and
  cut back after it) and MoE layers, expert-parallel in the prefill and
  dense in decode, on the experts stored along ``model`` (each rank's
  two, the partial outputs summed over ``model``); capacity factor 16, so that
  no token is dropped (capacity couples the tokens routed together, and
  the expert-parallel form routes a data rank's rows alone);
* reduced kimi-k2 with one KV head: attention whose KV heads ``model``
  does not divide (gathered, its cache on the head dim), a dense
  prologue, MoE layers (dense, on the stored experts, in both steps).

The split link's 8-bit codes are carried from the reference
(``D.pinned_link``: each step's link input within
``D.LINK_INPUT_TOL`` of the reference's, the port's link on the
reference's input within ``D.LINK_OUTPUT_ATOL`` of the reference's
output, the flipped codes counted): kimi's unsharded port
flips one code of its fifth decode step's activation at these seeds, which
moves that step's logits by 2.7e-3.  The port's unsharded steps run on the
same carried link as a second check.  Every step's logits within ``ATOL``
of both (measured: jamba 2.4e-6 from the reference and 1.5e-6 from the
unsharded port, |x| < 3.6, its 16 layers' f32 sums in another order; kimi
2.4e-6 and 0, |x| < 3.8), greedy tokens equal to the reference's; the
gathered layers' parameters and cache leaves show as gathers along
``model`` in the tally.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _dist_ranks as D  # noqa: E402

ATOL = 5e-6
# (arch, cfg overrides, moe_shard_map)
GATHERED = [("jamba-v0.1-52b", {"capacity_factor": 16.0}, True), ("kimi-k2-1t-a32b", {"num_kv_heads": 1}, False)]
IDS = [a for a, _, _ in GATHERED]
# At most this many flipped link codes a step (one code in 4096 elements).
FLIPS = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    """The reference's prefill and greedy decode on the port's weights, a
    case each: (logits, tokens, links)."""
    return [D.reference_serve(arch, **over) for arch, over, _ in GATHERED]


def _forced(ref):
    return ref[1][:, :D.SERVE_STEPS].tolist()


@pytest.fixture(scope="module")
def unsharded(reference):
    """The port's unsharded steps on the reference's link and tokens: (each
    step's logits, the flipped codes a step)."""
    out = []
    for (arch, over, _), ref in zip(GATHERED, reference):
        with D.pinned_link(ref[2]) as flips:
            logits = D.serve_run(D._cfg(arch, **over), forced=_forced(ref))[0]
        out.append((logits, flips))
    return out


@pytest.fixture(scope="module")
def four_ranks(reference, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    runs = []
    for i, ((a, over, e), ref) in enumerate(zip(GATHERED, reference)):
        torch.save(ref[2], tmp / f"links_{i}.pt")
        runs.append(dict(arch=a, model_axis=2, moe_shard_map=e, cfg_over=over, forced=_forced(ref),
                         pinned=str(tmp / f"links_{i}.pt")))
    ranks = D.run_ranks("serve", 4, tmp, runs=runs)
    return [[r[i] for r in ranks] for i in range(len(runs))]


@pytest.mark.parametrize("case", range(len(GATHERED)), ids=IDS)
def test_gathered_layers_under_model_2(reference, unsharded, four_ranks, case):
    ranks = four_ranks[case]
    D.same_on_every_rank(ranks)
    ref_logits, ref_tokens, _ = reference[case]
    port_logits, port_flips = unsharded[case]
    for i, (got, want, port) in enumerate(zip(ranks[0]["logits"], ref_logits, port_logits)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL, err_msg=f"step {i}")
        np.testing.assert_allclose(got.numpy(), port.numpy(), rtol=0, atol=ATOL, err_msg=f"step {i}, unsharded port")
    np.testing.assert_array_equal(torch.cat(ranks[0]["tokens"], dim=1).numpy(), ref_tokens)
    for flips in [port_flips] + [r["flips"] for r in ranks]:
        assert len(flips) == D.SERVE_STEPS + 1 and max(flips) <= FLIPS, flips
    for r in ranks:
        assert r["calls"]["model"]["all-gather"] > 0

"""The sharded prefill and decode steps on four gloo ranks
(tests/_dist_ranks.py) against the reference's ``make_prefill_step`` /
``make_serve_step`` on the same weights (``params_to_jax``): reduced
qwen1.5-0.5b in f32 on ``(data, model)`` = (1, 4), (2, 2) and (4, 1), a
prompt of ``D.SERVE_P`` tokens into a cache of ``D.SERVE_S`` rows at batch
``D.SERVE_B``, then ``D.SERVE_STEPS`` decode steps fed the reference's
greedy tokens (teacher forcing), the key of step ``i`` ``fold_in(key, i)``,
with the cfg's serving link (8-bit codes, i.i.d. packet loss at 0.1).

* Every step's logits, put together from the ranks' rows and vocabulary
  slices, within ``ATOL`` of the reference's, and each step's greedy
  tokens (``steps.greedy_tokens``: the argmax over the sharded vocabulary)
  equal to the reference's.  The sums over ``model`` add the ranks'
  partial products in another order than one device does: the logits
  (|x| < 1.21) differ from the reference's by at most 8.9e-7 measured, a
  few f32 ulps (the unsharded port, at (4, 1), by 8.3e-7).  No link
  code flipped at these seeds (a flip moves a logit by far more).
* ``launch.serve.generate_sharded`` (the CLI's ``--tensor-parallel``) on
  ``make_production_mesh`` over the 4 ranks, (1, 4): the tokens of
  ``generate_reference``.
* The ranks' real collectives, tallied by axis (``comm.tally``): no
  gather along ``model`` (the attention, MLP and vocabulary compute on the
  rank's slices) and, where ``model`` is wider than one, ``2 L + 1`` sums
  over ``model`` a step of (B_rank, S, d) f32 each: two a layer (attention
  and MLP) and the embedding's.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _dist_ranks as D  # noqa: E402
from repro_torch.models import lm  # noqa: E402

ATOL = 2e-6
MESHES = [(1, 4), (2, 2), (4, 1)]
IDS = [f"data{d}-model{m}" for d, m in MESHES]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    """The reference's prefill and greedy decode on the port's weights."""
    logits, tokens, _ = D.reference_serve("qwen1.5-0.5b")
    return logits, tokens


@pytest.fixture(scope="module")
def four_ranks(reference, tmp_path_factory):
    """Every MESHES case, one after another in one world of 4, then
    ``generate_sharded`` on the production mesh over the 4 ranks."""
    forced = reference[1][:, :D.SERVE_STEPS].tolist()
    runs = [dict(model_axis=m, forced=forced) for _, m in MESHES] + [dict(generate=True)]
    ranks = D.run_ranks("serve", 4, tmp_path_factory.mktemp("ranks"), runs=runs)
    return [[r[i] for r in ranks] for i in range(len(runs))]


@pytest.mark.parametrize("case", range(len(MESHES)), ids=IDS)
def test_four_ranks_match_the_reference(reference, four_ranks, case):
    ranks = four_ranks[case]
    D.same_on_every_rank(ranks)
    ref_logits, ref_tokens = reference
    for i, (got, want) in enumerate(zip(ranks[0]["logits"], ref_logits)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL, err_msg=f"step {i}")
    np.testing.assert_array_equal(torch.cat(ranks[0]["tokens"], dim=1).numpy(), ref_tokens)


@pytest.mark.parametrize("case", range(len(MESHES)), ids=IDS)
def test_model_axis_computes_the_ranks_slices(four_ranks, case):
    cfg = D._cfg("qwen1.5-0.5b")
    d_rows, m = MESHES[case]
    per_step = 2 * len(cfg.all_layers()) + 1
    rows = D.SERVE_B // d_rows
    for r in four_ranks[case]:
        model = r["calls"].get("model", {})
        assert "all-gather" not in model, model
        if m == 1:
            assert not model, model
            continue
        assert model == {"all-reduce": per_step * (D.SERVE_STEPS + 1)}, model
        f32 = 4
        assert r["tally"]["model"]["all-reduce"] == per_step * rows * cfg.d_model * f32 * (D.SERVE_P + D.SERVE_STEPS)


def test_generate_sharded_is_generate_reference(four_ranks):
    """The CLI's ``--tensor-parallel`` path on ``make_production_mesh`` over
    the world of 4 ((1, 4): ``model`` gcd(4, 16) wide): every rank's global
    tokens equal ``generate_reference``'s (the same key chain)."""
    from repro_torch.launch.serve import generate_reference

    cfg = D._cfg("qwen1.5-0.5b")
    prompts, key = D.serve_inputs(cfg)
    want, _ = generate_reference(lm.init_lm(cfg, seed=0, device="cpu"), cfg, torch.from_numpy(prompts), 4, key=key)
    for r in four_ranks[len(MESHES)]:
        assert r["mesh"] == {"data": 1, "model": 4}
        assert torch.equal(r["tokens"], want)

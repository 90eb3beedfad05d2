"""Context-parallel decode on four gloo ranks (tests/_context_parallel.py)
over an int8 KV cache: reduced qwen1.5-0.5b (f32 weights,
``kv_cache_dtype="int8"``, global batch 1) on ``(data, model)`` = (4, 1),
the codes and their bf16 scales split over ``data`` with the rows, the
same prompt and steps as tests/test_torch_context_parallel_ranks.py.

An int8 cache adds a second step function besides the 8-bit link: a K or
V element on a code's rounding edge.  The unsharded port writes one code
of decode step 13 one step from the reference's (an attention layer
before the split, so that step's link input is 1.7e-4 off).  So both the
reference's link outputs (``D.pinned_link``) and its cache codes
(``D.pinned_cache``: each write's codes checked, at most one code apart at
at most ``D.CACHE_FLIPS`` elements, then the reference's stored) are
carried, on the ranks and in the unsharded port alike.

* Every step's logits within ``ATOL`` (2e-6) of the reference's and of
  the unsharded port's on the same tokens (``D.serve_run``); the greedy
  tokens equal the reference's.
* The tally: one all-gather of the partials' buffer over ``data`` a layer
  a decode step, and no cache leaf (codes or scales) gathered over
  ``data``.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _context_parallel as CP  # noqa: E402
import _dist_ranks as D  # noqa: E402

SIZES = (1, 16, 3, 15)
INT8 = {"kv_cache_dtype": "int8"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return CP.run("qwen1.5-0.5b", [(4, 1)], SIZES, tmp_path_factory, cfg_over=INT8, pinned_caches=True)


@pytest.fixture(scope="module")
def unsharded(runs):
    """The port's unsharded steps on the reference's tokens, link and
    cache codes: (each step's logits, the differing codes a write)."""
    _, ref_tokens, links, caches = runs[0]
    with D.pinned_link(links), D.pinned_cache(caches, SIZES[2]) as cache_flips:
        logits = D.serve_run(D._cfg("qwen1.5-0.5b", **INT8), forced=ref_tokens[:, :SIZES[3]].tolist(),
                             sizes=SIZES)[0]
    return logits, cache_flips


def test_int8_context_parallel_matches_the_unsharded_port(runs, unsharded):
    ranks = runs[1][0]
    D.same_on_every_rank(ranks)
    assert set(ranks[0]["cache_shapes"][0]) == {"k", "v", "k_scale", "v_scale"}
    for i, (got, want) in enumerate(zip(ranks[0]["logits"], unsharded[0])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=CP.ATOL, err_msg=f"step {i}")


def test_int8_context_parallel_matches_the_reference(runs, unsharded):
    reference, ranks = runs[0], runs[1][0]
    CP.check_against_reference(reference, ranks)
    # Every attention layer's write of every step went through the carrier,
    # on each rank and in the unsharded port.
    writes = len(reference[3]) * sum(layer is not None for layer in reference[3][0])
    assert len(unsharded[1]) == writes and all(len(r["cache_flips"]) == writes for r in ranks)
    for i, (port, want) in enumerate(zip(unsharded[0], reference[0])):
        np.testing.assert_allclose(port.numpy(), want, rtol=0, atol=CP.ATOL, err_msg=f"unsharded step {i}")


def test_int8_context_parallel_gathers_the_partials_only(runs):
    CP.check_collectives(runs[1][0], D._cfg("qwen1.5-0.5b", **INT8), 4, 1)

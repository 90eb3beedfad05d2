"""The recurrent families (ROADMAP A12b) against the reference: reduced jamba
through the contiguous slot pool under the i.i.d. link, three one-token
prompts (each prefill through the recurrent layers' step; one bucket);
greedy tokens equal the reference pool's request for request, and so does
num_buckets (set-up and bar in tests/_recurrent_parity.py)."""

import pytest

pytest.importorskip("torch")

from _recurrent_parity import check_pool, one_torch_thread  # noqa: E402,F401


@pytest.mark.parametrize("arch,channel,spec", [('jamba-v0.1-52b', 'iid', [(1, 3), (1, 4), (1, 2)])])
def test_contiguous_pool_matches_the_reference_pool(arch, channel, spec):
    check_pool(arch, channel, spec)

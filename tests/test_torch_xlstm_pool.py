"""The recurrent families (ROADMAP A12b) against the reference: reduced xlstm
through the contiguous slot pool under the i.i.d. link, prompts of 1 and 6
tokens (two buckets; the long one in two chunks); greedy tokens equal the
reference pool's request for request, and so does num_buckets (set-up and
bar in tests/_recurrent_parity.py)."""

import pytest

pytest.importorskip("torch")

from _recurrent_parity import check_pool, one_torch_thread  # noqa: E402,F401


@pytest.mark.parametrize("arch,channel,spec", [('xlstm-350m', 'iid', [(1, 3), (6, 4), (6, 2)])])
def test_contiguous_pool_matches_the_reference_pool(arch, channel, spec):
    check_pool(arch, channel, spec)

"""The recurrent families (ROADMAP A12b) against the reference: reduced jamba
through the contiguous slot pool under the Gilbert–Elliott link, three two-
token prompts (each shorter than Mamba's conv tail; one bucket); greedy
tokens equal the reference pool's request for request, and so does
num_buckets (set-up and bar in tests/_recurrent_parity.py)."""

import pytest

pytest.importorskip("torch")

from _recurrent_parity import check_pool, one_torch_thread  # noqa: E402,F401


@pytest.mark.parametrize("arch,channel,spec", [('jamba-v0.1-52b', 'ge', [(2, 3), (2, 4), (2, 2)])])
def test_contiguous_pool_matches_the_reference_pool(arch, channel, spec):
    check_pool(arch, channel, spec)

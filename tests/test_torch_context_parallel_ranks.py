"""Context-parallel decode on four gloo ranks (tests/_context_parallel.py):
reduced qwen1.5-0.5b in f32 at global batch 1 on ``(data, model)`` =
(2, 2) and (4, 1), each attention layer's 16 cache rows split over
``data`` (8 or 4 a rank).  A 3-token prompt, then 15 decode steps at
positions 3-17: the first steps leave the ranks past row 3 with no valid
row (their partials are the empty m = -1e30, l = 0), the steps cross
every rank boundary (4, 8, 12) and, at 16 and 17, the rotation back to
rank 0's first rows.

* Every step's logits within ``ATOL`` (2e-6) of the reference's and the
  greedy tokens equal.
* The tally: one all-gather of the partials' buffer over ``data`` a layer
  a decode step, and no cache leaf gathered over ``data``.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import _context_parallel as CP  # noqa: E402
import _dist_ranks as D  # noqa: E402

MESHES = [(2, 2), (4, 1)]
IDS = [f"data{d}-model{m}" for d, m in MESHES]
SIZES = (1, 16, 3, 15)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return CP.run("qwen1.5-0.5b", MESHES, SIZES, tmp_path_factory)


@pytest.mark.parametrize("case", range(len(MESHES)), ids=IDS)
def test_context_parallel_matches_the_reference(runs, case):
    reference, ranks = runs
    CP.check_against_reference(reference, ranks[case])


@pytest.mark.parametrize("case", range(len(MESHES)), ids=IDS)
def test_context_parallel_gathers_the_partials_only(runs, case):
    data, model = MESHES[case]
    CP.check_collectives(runs[1][case], D._cfg("qwen1.5-0.5b"), data, model)

"""Context-parallel decode on four gloo ranks (tests/_context_parallel.py)
of reduced gemma3-12b (f32, global batch 1, ``(data, model)`` = (4, 1)):
its local layers keep a rotating window of 32 rows (8 a rank), its
global layers the cache's 64 (16 a rank).  A 40-token prompt already
rotates past the window (the prefill stores each rank's slots of the
last 32 positions); 10 decode steps at positions 40-49 keep rotating the
local layers and cross the global layers' rank boundary at 48, the last
rank holding no valid global row until then.

* Every step's logits within ``ATOL`` (2e-6) of the reference's and the
  greedy tokens equal.
* The tally: one all-gather of the partials' buffer over ``data`` a layer
  a decode step (local and global), no cache leaf gathered over ``data``.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import _context_parallel as CP  # noqa: E402
import _dist_ranks as D  # noqa: E402

SIZES = (1, 64, 40, 10)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return CP.run("gemma3-12b", [(4, 1)], SIZES, tmp_path_factory)


def test_windowed_context_parallel_matches_the_reference(runs):
    cfg = D._cfg("gemma3-12b")
    windows = {spec.window for spec in cfg.all_layers() if spec.kind == "attn"}
    assert 32 in windows and 0 in windows, windows
    reference, ranks = runs
    CP.check_against_reference(reference, ranks[0])


def test_windowed_context_parallel_gathers_the_partials_only(runs):
    CP.check_collectives(runs[1][0], D._cfg("gemma3-12b"), 4, 1)

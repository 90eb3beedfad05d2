"""The paged slot pool of the attention-family configs without a modality
frontend (kimi-k2, arctic, codeqwen, gemma-7b), reduced, against the
reference's paged pool: tokens equal request for request under the i.i.d.
and Gilbert–Elliott links, f32 and int8 KV (the check of
tests/test_torch_archs_pools.py, which holds the contiguous pool).  Both
paged steps route every slot of the pool jointly through an MoE layer."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_archs_pools import ARCHS, PAGED_RUNS, check_pool  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("channel,kv", PAGED_RUNS)
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_pool_matches_the_reference_pool(arch, channel, kv):
    check_pool(arch, "paged", channel, kv)

"""The reference loop of the attention-family configs without MoE
(qwen2-vl, musicgen, codeqwen, gemma-7b), reduced, against the
reference's: greedy tokens equal under the i.i.d. and Gilbert–Elliott links
(loss 0.3), f32 and int8 KV caches (the check of
tests/test_torch_archs_loop.py, which holds the MoE configs)."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_archs_loop import check_loop  # noqa: E402

ARCHS = ["qwen2-vl-72b", "musicgen-medium", "codeqwen1.5-7b", "gemma-7b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kv", ["", "int8"], ids=["f32kv", "int8kv"])
@pytest.mark.parametrize("channel", ["iid", "ge"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_reference_matches(arch, channel, kv):
    check_loop(arch, {}, channel, kv)

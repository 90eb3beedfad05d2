"""The recurrent families (ROADMAP A12b) against the reference: reduced xlstm
through the reference loop (``launch.serve.generate_reference``) under the
i.i.d. link; greedy tokens equal the reference's same entry point (set-up
and bar in tests/_recurrent_parity.py)."""

import pytest

pytest.importorskip("torch")

from _recurrent_parity import check_loop, one_torch_thread  # noqa: E402,F401


@pytest.mark.parametrize("arch,channel", [('xlstm-350m', 'iid')])
def test_generate_reference_matches(arch, channel):
    check_loop(arch, channel)

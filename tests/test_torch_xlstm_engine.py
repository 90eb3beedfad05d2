"""The recurrent families (ROADMAP A12b) against the reference: reduced xlstm's
whole-generation ``DecodeEngine`` under the i.i.d. link, called twice in a
row; greedy tokens equal the reference's same entry point (set-up and bar in
tests/_recurrent_parity.py)."""

import pytest

pytest.importorskip("torch")

from _recurrent_parity import check_engine, one_torch_thread  # noqa: E402,F401


@pytest.mark.parametrize("arch,channel", [('xlstm-350m', 'iid')])
def test_decode_engine_matches_the_reference_engine(arch, channel):
    check_engine(arch, channel)

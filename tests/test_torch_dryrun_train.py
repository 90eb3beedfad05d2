"""The dry run's train kind (``launch.dryrun.run_one``): qwen1.5-0.5b x
``train_4k`` traced on the placeholder production mesh, forward, backward
and Adam on the rank's shards; and the multi-pod mesh's decode.  The
train step computes over ``model`` on gathered parameters (ROADMAP A13d):
its tally gathers along ``model`` and reduce-scatters its gradients over
``data``.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from test_torch_dryrun import check_report  # noqa: E402

from repro_torch.launch import dryrun  # noqa: E402


def test_train_4k_report():
    d = dryrun.run_one("qwen1.5-0.5b", "train_4k")
    check_report(d, "qwen1.5-0.5b", "train_4k")
    assert d["collective_by_axis"]["model"]["all-gather"] > 0
    assert d["collective_by_axis"]["data"]["reduce-scatter"] > 0


def test_multi_pod_decode():
    d = dryrun.run_one("qwen1.5-0.5b", "decode_32k", multi_pod=True)
    assert (d["mesh"], d["chips"]) == ("2x16x16", 512)
    # The batch of 128 splits over pod x data (32 ranks): 4 rows a rank.
    by_axis = d["collective_by_axis"]
    assert by_axis["model"] == {"all-reduce": (2 * 24 + 1) * 4 * 1024 * 2}
    assert "pod+data" in by_axis

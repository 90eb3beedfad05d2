"""The dry run (``launch.dryrun``): one rank's step of an (architecture x
shape) pair traced on the placeholder production mesh (256 ``meta``
devices, no data moved), and its report.

* qwen1.5-0.5b x ``prefill_32k`` and ``decode_32k`` and jamba-v0.1 x
  ``decode_32k``: the reference's fields (``dryrun.py:88-123``); the
  analytic terms with the H100 constants; the tally's sums over ``model``
  (qwen: ``2 L + 1`` of the rank's rows a step, no gather along ``model``;
  jamba's gathered layers gather along ``model``).
* ``long_500k`` of qwen1.5-0.5b (+swa) and gemma3-12b lowers through
  context-parallel decode (the CLI exits 0): the tally shows one
  all-gather of the partials over ``data`` an attention layer and no
  cache leaf gathered over ``data``; xlstm-350m's, with no attention
  layer, lowers.
* kimi-k2 x ``decode_32k``: the dense MoE runs on the experts stored
  along ``model``, so no expert tensor is all-gathered along ``model``.
* A ``(1, m)`` placeholder mesh's decode step (reduced qwen, f32): the
  sums over ``model`` are two a layer of ``B x d`` elements, plus the
  embedding's, counted by hand.
The train kind's trace is tests/test_torch_dryrun_train.py.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHITECTURES, INPUT_SHAPES  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.roofline import analysis, analytic  # noqa: E402
from repro_torch.sharding import comm  # noqa: E402

FIELDS = {"arch", "shape", "mesh", "chips", "flops", "hbm_bytes", "collective_bytes", "collective_breakdown",
          "model_flops", "raw_cost_flops", "raw_cost_bytes", "compute_s", "memory_s", "collective_s", "bottleneck",
          "useful_flops_frac", "bytes_per_device", "variant", "n_params", "n_active_params"}
PAIRS = [("qwen1.5-0.5b", "prefill_32k"), ("qwen1.5-0.5b", "decode_32k"), ("jamba-v0.1-52b", "decode_32k")]


@pytest.fixture(scope="module")
def reports():
    return {pair: dryrun.run_one(*pair) for pair in PAIRS}


def check_report(d, arch, shape):
    """The report's fields and how they hang together (the train file uses
    it too)."""
    cfg, shape_cfg = ARCHITECTURES[arch], INPUT_SHAPES[shape]
    assert FIELDS <= set(d)
    assert (d["mesh"], d["chips"], d["variant"]) == ("16x16", 256, "original")
    ana = analytic.analytic_cost(cfg, shape_cfg, d["n_params"], d["n_active_params"])
    assert (d["flops"], d["hbm_bytes"]) == (ana["flops"], ana["hbm_bytes"])
    assert d["compute_s"] == d["flops"] / (256 * 989e12)
    assert d["memory_s"] == d["hbm_bytes"] / (256 * 3.35e12)
    assert d["collective_s"] == d["collective_bytes"] / 450e9
    terms = {k: d[f"{k}_s"] for k in ("compute", "memory", "collective")}
    assert d["bottleneck"] == max(terms, key=terms.get)
    assert d["collective_bytes"] == sum(d["collective_breakdown"].values()) > 0
    assert d["collective_bytes"] == sum(sum(k.values()) for k in d["collective_by_axis"].values())
    assert d["raw_cost_flops"] > 0 and d["raw_cost_bytes"] > 0
    assert d["bytes_per_device"] >= d["arg_bytes"] + d["peak_temp_bytes"] > 0
    tokens = shape_cfg.global_batch * (1 if shape_cfg.is_decode else shape_cfg.seq_len)
    assert d["useful_flops_frac"] == pytest.approx(
        analysis.model_flops(cfg, steps.abstract_params(cfg), tokens, shape_cfg.is_decode, shape_cfg.kind) / d["flops"])


@pytest.mark.parametrize("pair", PAIRS, ids=[f"{a}-{s}" for a, s in PAIRS])
def test_report(reports, pair):
    check_report(reports[pair], *pair)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_qwen_computes_its_model_slices(reports, shape):
    cfg, shape_cfg = ARCHITECTURES["qwen1.5-0.5b"], INPUT_SHAPES[shape]
    model = reports[("qwen1.5-0.5b", shape)]["collective_by_axis"]["model"]
    rows = shape_cfg.global_batch // 16
    positions = 1 if shape_cfg.is_decode else shape_cfg.seq_len
    bf16 = 2
    assert model == {"all-reduce": (2 * cfg.num_layers + 1) * rows * positions * cfg.d_model * bf16}


def test_jamba_gathers_what_runs_whole(reports):
    by_axis = reports[("jamba-v0.1-52b", "decode_32k")]["collective_by_axis"]
    assert by_axis["model"]["all-gather"] > 0 and by_axis["model"]["all-reduce"] > 0


def _traced_tally(arch, shape):
    """The rank-0 step of the pair on the placeholder production mesh, its
    tally and the (rank's) cache it ran on."""
    cfg, _ = dryrun.resolve_config(arch, shape)
    mesh = dryrun.make_production_mesh()
    with comm.placeholder_world(0):
        fn, args = steps.build_sharded_step(cfg, INPUT_SHAPES[shape], mesh)
        with torch.no_grad(), comm.tally() as tally:
            fn(*args)
    return cfg, tally, args[2]


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "gemma3-12b"])
def test_long_500k_context_parallel_lowers(tmp_path, arch):
    """Batch 1 cannot be split over ``data`` (16), so every attention layer
    whose cache length 16 divides holds 1/16 of its KV rows and merges
    flash decode's partials over ``data``: one all-gather a layer of the
    16 ranks' partial buffers, (16, n); no cache leaf is gathered over
    ``data``.  The CLI exits 0 and writes the report."""
    cfg, tally, cache = _traced_tally(arch, "long_500k")
    split = [i for i, (spec, layer) in enumerate(zip(cfg.all_layers(), cache))
             if spec.kind == "attn" and layer["k"].shape[1] * 16 == min(spec.window or 524288, 524288)]
    assert len(split) == sum(s.kind == "attn" for s in cfg.all_layers()) > 0
    on_data = [shape for kind, axes, shape in tally.shapes if axes == "data" and kind == "all-gather"]
    hd = cfg.resolved_head_dim
    # The partial buffer of a rank: (B, KV heads on the rank's step, G, splits) x (hd + 2).
    partials = [shape for shape in on_data if len(shape) == 2 and shape[0] == 16 and shape[1] % (hd + 2) == 0]
    assert len(partials) == len(split)
    cache_shapes = {tuple(t.shape) for layer in cache for t in layer.values()}
    assert not [shape for shape in on_data if shape in cache_shapes or (len(shape) == 4 and shape[1] > 1)]
    out = tmp_path / "r.jsonl"
    with pytest.raises(SystemExit) as exit_:
        dryrun.main(["--arch", arch, "--shape", "long_500k", "--out", str(out)])
    assert exit_.value.code == 0
    assert "error" not in out.read_text()


def test_kimi_decode_gathers_no_expert_along_model():
    """kimi-k2 x decode_32k: 384 experts over ``model`` 16, each rank's 24
    computed where stored; the experts are gathered over ``data`` only."""
    cfg, tally, _ = _traced_tally("kimi-k2-1t-a32b", "decode_32k")
    e = cfg.num_experts
    experts = [(kind, axes) for kind, axes, shape in tally.shapes if len(shape) == 3 and shape[0] in (e, e // 16)]
    assert experts and all(axes == "data" for _, axes in experts), experts
    assert not [shape for kind, axes, shape in tally.shapes if axes == "model" and kind == "all-gather"
                and len(shape) == 3 and shape[0] == e]


def test_xlstm_long_500k_lowers():
    d = dryrun.run_one("xlstm-350m", "long_500k")
    assert d["n_params"] == analysis.count_params(steps.abstract_params(ARCHITECTURES["xlstm-350m"]))
    assert d["bytes_per_device"] > 0


def test_sums_over_model_by_hand():
    """Reduced qwen (f32) decode on a (1, 4) placeholder mesh, B rows."""
    cfg = ARCHITECTURES["qwen1.5-0.5b"].reduced()
    b = 4
    grid = np.empty(4, dtype=object)
    grid[:] = [torch.device("meta")] * 4
    mesh = Mesh(grid.reshape(1, 4))
    with comm.placeholder_world(1):
        fn, args = steps.build_sharded_step(cfg, ShapeConfig("d", 16, b, "decode"), mesh)
        with torch.no_grad(), comm.tally() as tally:
            logits, _ = fn(*args)
    assert logits.shape == (b, cfg.vocab_size // 4)
    per_step = 2 * len(cfg.all_layers()) + 1
    assert dict(tally.calls["model"]) == {"all-reduce": per_step}
    assert dict(tally.by_axis["model"]) == {"all-reduce": per_step * b * cfg.d_model * 4}


def _flops(fn, *args, **kw):
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kw)
    return out, counter.get_total_flops()


def _meta(*tensors):
    return [t.to("meta") for t in tensors]


@pytest.mark.parametrize("path", ["flash_attention", "decode_attention", "slstm"])
def test_meta_paths_count_the_plain_versions_products(path):
    """On ``meta`` the dry run's shortcuts (one shape-only attention
    operator, the decode walk as one block, the sLSTM steps batched over
    time) count the products the CPU's plain versions perform, and give
    their shapes."""
    gen = torch.Generator().manual_seed(0)
    if path == "flash_attention":
        from repro_torch.kernels.flash_attention import grouped_flash_attention

        q = torch.randn(2, 40, 2, 2, 16, generator=gen).requires_grad_(True)
        k, v = (torch.randn(2, 40, 2, 16, generator=gen).requires_grad_(True) for _ in range(2))

        def run(q, k, v):
            out = grouped_flash_attention(q, k, v, causal=True, window=0, q_offset=0, softcap=0.0)
            out.sum().backward()
            return out
        args = (q, k, v)
        meta = [t.detach().to("meta").requires_grad_(True) for t in args]
    elif path == "decode_attention":
        from repro_torch.kernels.decode_attention import decode_attention

        q = torch.randn(2, 1, 2, 2, 16, generator=gen)
        cache = {"k": torch.randn(2, 128, 2, 16, generator=gen), "v": torch.randn(2, 128, 2, 16, generator=gen)}

        def run(q, cache):
            return decode_attention(q, cache, 128, block_kv=32)
        args = (q, cache)
        meta = (q.to("meta"), {n: t.to("meta") for n, t in cache.items()})
    else:
        from repro_torch.models import xlstm

        cfg = ARCHITECTURES["xlstm-350m"].reduced()
        layer = xlstm.SLSTM(cfg, torch.float32, "cpu")
        layer.reset_parameters(gen)
        x = torch.randn(2, 12, cfg.d_model, generator=gen)
        state = xlstm.init_slstm_cache(2, cfg, "cpu")

        def run(x, state):
            return xlstm.slstm_forward(layer, x, cfg, state)
        args = (x, state)
        layer_meta = xlstm.SLSTM(cfg, torch.float32, "meta")
        meta = (x.to("meta"), {n: t.to("meta") for n, t in state.items()})

        def run_meta(x, state):
            return xlstm.slstm_forward(layer_meta, x, cfg, state)
    want, want_flops = _flops(run, *args)
    got, got_flops = _flops(run_meta if path == "slstm" else run, *meta)
    assert got_flops == want_flops > 0
    shapes = lambda t: [tuple(x.shape) for x in torch.utils._pytree.tree_flatten(t)[0] if torch.is_tensor(x)]
    assert shapes(got) == shapes(want)

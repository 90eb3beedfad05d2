"""The sharded prefill and decode steps (``launch.steps.build_sharded_step``
on the state its ``place`` makes) in a world of one (gloo,
in this process), against the port's unsharded ``make_prefill_step`` /
``make_serve_step``: a prompt of ``D.SERVE_P`` tokens into a cache of
``D.SERVE_S`` rows at batch ``D.SERVE_B``, then ``D.SERVE_STEPS`` greedy
decode steps, the key of step ``i`` ``fold_in(key, i)``, with the cfg's
serving link (8-bit codes, i.i.d. packet loss at 0.1).  Every collective
returns its input, so every step's logits, the greedy tokens
(``steps.greedy_tokens``) and the cache equal the unsharded steps' bit for
bit: reduced qwen1.5-0.5b (also with the expert-parallel form asked for),
jamba-v0.1 (Mamba, MoE; its prefill expert-parallel) and kimi-k2 (a dense
prologue, MoE).  A mesh axis of one rank splits nothing, so the steps
gather nothing: no parameters, no cache leaves (jamba's Mamba states are
placed on ``model``), no batch rows.  The multi-rank runs are
``tests/test_torch_sharded_steps_{ranks,gathered}.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _dist_ranks as D  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import AdamConfig, init_adam  # noqa: E402
from repro_torch.sharding import comm  # noqa: E402

PREFILL = ShapeConfig("p", D.SERVE_S, D.SERVE_B, "prefill")
DECODE = ShapeConfig("d", D.SERVE_S, D.SERVE_B, "decode")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world_of_one():
    _, started = t_mesh.init_world("cpu")
    yield
    if started:
        t_mesh.close_world()


@pytest.mark.parametrize("arch,moe_shard_map", [("qwen1.5-0.5b", False), ("qwen1.5-0.5b", True),
                                                ("jamba-v0.1-52b", True), ("kimi-k2-1t-a32b", False)])
def test_world_of_one_is_the_unsharded_steps_bit_for_bit(world_of_one, arch, moe_shard_map):
    cfg = D._cfg(arch)
    ref_logits, ref_tokens, ref_cache = D.serve_run(cfg)
    mesh = t_mesh.make_host_mesh()
    fns = tuple(steps.build_sharded_step(cfg, shape, mesh, moe_shard_map=moe_shard_map)[0]
                for shape in (PREFILL, DECODE))
    state = fns[0].place(lm.init_lm(cfg, seed=0, device="cpu"))
    with comm.tally() as tally:
        got_logits, _, got_cache = D.serve_run(cfg, state=state, fns=fns)
    assert not any("all-gather" in kinds for kinds in tally.calls.values()), dict(tally.calls)
    for i, (a, b) in enumerate(zip(got_logits, ref_logits)):
        assert torch.equal(a, b), i
        assert torch.equal(steps.greedy_tokens(a, cfg, mesh), ref_tokens[i]), i
    for a, b in zip(got_cache, ref_cache):
        for name in b:
            assert torch.equal(a[name], b[name]), name


def test_the_builder_refuses_a_state_it_did_not_place(world_of_one):
    """The builder's function takes the state its ``place`` makes (the
    builder's fsdp, MoE form and tensor-parallel slices), not the model
    itself."""
    cfg = D._cfg("qwen1.5-0.5b")
    mesh = t_mesh.make_host_mesh()
    fn, (abstract, *_) = steps.build_sharded_step(cfg, PREFILL, mesh, fsdp="on")
    model = lm.init_lm(cfg, seed=0, device="cpu")
    cache = steps.init_cache_shards(cfg, PREFILL, mesh, device="cpu")
    prompts, key = D.serve_inputs(cfg)
    with pytest.raises(TypeError, match="takes a ShardedModel"):
        fn(model, {"tokens": torch.from_numpy(prompts)}, cache, key)
    state = fn.place(model)
    assert state.specs == abstract.specs and state.local == abstract.local
    assert state.local["stack.layers.0.mix.wq"] == [("model", 1)]


def test_the_train_step_refuses_tensor_parallel_slices(world_of_one):
    """Training computes over ``model`` on gathered parameters (ROADMAP
    A13d): a tensor-parallel state on a model axis wider than one is
    refused, one of width one trains as ever."""
    cfg = D._cfg("qwen1.5-0.5b")
    model = lm.init_lm(cfg, seed=0, device="cpu").requires_grad_(True)
    state = steps.shard_model(model, cfg, t_mesh.make_host_mesh(), "off", tensor_parallel=True)
    adam = AdamConfig()
    step = steps.make_train_step(cfg, adam)
    tokens = torch.from_numpy(D.serve_inputs(cfg)[0])
    _, _, metrics = step(state, init_adam(state.shards, adam), {"tokens": tokens}, D.serve_inputs(cfg)[1])
    assert torch.isfinite(metrics["loss"])
    grid = np.empty(2, dtype=object)
    grid[:] = [torch.device("meta")] * 2
    with comm.placeholder_world(0):
        meta = steps.shard_model(lm.LM(cfg, device="meta").requires_grad_(True), cfg, t_mesh.Mesh(grid.reshape(1, 2)),
                                 "off", tensor_parallel=True)
        with pytest.raises(NotImplementedError, match="A13d"):
            step(meta, init_adam(meta.shards, adam), {"tokens": tokens.to("meta")}, D.serve_inputs(cfg)[1])


def test_generate_sharded_in_a_world_of_one_is_generate_reference(world_of_one):
    from repro_torch.launch.serve import generate_reference, generate_sharded

    cfg = D._cfg("kimi-k2-1t-a32b")
    prompts, key = D.serve_inputs(cfg)
    prompts = torch.from_numpy(prompts)
    want, _ = generate_reference(lm.init_lm(cfg, seed=0, device="cpu"), cfg, prompts, 4, key=key)
    got, _ = generate_sharded(cfg, prompts, 4, t_mesh.make_host_mesh(), key=key, moe_shard_map=True)
    assert torch.equal(got, want)


def test_the_cli_serves_tensor_parallel(world_of_one, caplog):
    from repro_torch.launch import serve

    with caplog.at_level("INFO", logger="repro_torch.launch.serve"):
        serve.main(["--arch", "qwen1.5-0.5b", "--tensor-parallel", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "8", "--tokens", "3"])
    assert "generated:" in caplog.text and "{'data': 1, 'model': 1}" in caplog.text

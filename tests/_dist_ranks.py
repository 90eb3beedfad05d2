"""Multi-rank runs of the port's sharded trainer on the CPU, for the tests.

``run_ranks(case, world, tmp_path, **kw)`` starts ``world`` processes of
this file, each a gloo rank of one world (a ``file://`` store under
``tmp_path``, one torch thread, no jax), runs ``CASES[case](**kw)`` on
every rank and returns the ranks' results (``torch.save``d dicts), in rank
order.  A rank that fails, or a world that outlives ``timeout`` seconds,
fails the calling test (every rank is killed), so a dead rank never hangs
the suite.  The process group itself times out after 60 s
(``launch.mesh.WORLD_TIMEOUT``).
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

# The reference test's configuration (tests/test_channel_training.py:538-545):
# reduced arctic-480b at d 32, 4 experts, capacity factor 16, K 4 x B 4 x S 16.
ARCTIC = dict(d_model=32, num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64, capacity_factor=16.0)
K, B, S = 4, 4, 16


def run_ranks(case: str, world: int, tmp_path, timeout: float = 150.0, **kw) -> list:
    tmp = pathlib.Path(tmp_path) / f"{case}_{time.monotonic_ns()}"
    tmp.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    args = json.dumps(kw)
    procs = [subprocess.Popen([sys.executable, __file__, case, str(r), str(world), str(tmp), args], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"{case}: the world of {world} outlived {timeout} s")
    bad = [(r, p.returncode, logs[r][-3000:]) for r, p in enumerate(procs) if p.returncode]
    assert not bad, bad
    import torch

    return [torch.load(tmp / f"out_{r}.pt") for r in range(world)]


# ---------------------------------------------------------------------------
# The ranks' cases (run in the rank processes)
# ---------------------------------------------------------------------------

def _cfg(arch, registry=None, **overrides):
    """The reduced config of the port's registry (or ``registry``'s)."""
    if registry is None:
        from repro_torch.configs import ARCHITECTURES as registry

    over = dict(ARCTIC) if arch == "arctic-480b" else {}
    over.update(overrides)
    return registry[arch].reduced(**over)


def _tokens(cfg):
    import numpy as np
    import torch

    rng = np.random.default_rng(7)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (K, B, S)).astype(np.int32))


def _epoch(arch="arctic-480b", model_axis=1, fsdp="off", moe_shard_map=False, spec=None, cfg_over=None):
    """The sharded epoch on every rank (Adam at lr 3e-4, the clip at 1.0):
    (losses, grad norms, link counters) and, on rank 0, the final
    parameters as whole tensors.  ``spec``: ``build_train_link_spec``'s
    overrides."""
    import torch

    from repro_torch import prng
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps
    from repro_torch.launch.train import build_train_link_spec
    from repro_torch.models import lm
    from repro_torch.optim import AdamConfig, init_adam

    cfg = _cfg(arch, **(cfg_over or {}))
    adam = AdamConfig(lr=3e-4, grad_clip_norm=1.0)
    mesh = M.make_host_mesh(model_axis)
    model = lm.init_lm(cfg, seed=0, device="cpu")
    model.requires_grad_(True)
    sharded = steps.shard_model(model, cfg, mesh, fsdp, moe_shard_map)
    opt = init_adam(sharded.shards, adam)
    link_spec = build_train_link_spec(cfg, **spec) if spec else None
    fn = steps.make_train_epoch(cfg, adam, link_spec=link_spec)
    sharded, opt, _, metrics = fn(sharded, opt, {"tokens": _tokens(cfg)}, prng.PRNGKey(42))
    out = {k: v.detach() for k, v in metrics.items()}
    full = {n: t.detach().clone() for n, t in sharded.materialize().named_parameters()}
    if torch.distributed.get_rank() == 0:
        out["params"] = full
    return out


def case_moe(model_axis=4, top_k=2, seed=0):
    """The expert-parallel MoE's forward and gradients on this rank (x and
    the router whole, the experts this rank's)."""
    import torch

    from repro_torch.launch import mesh as M
    from repro_torch.models.moe import MoE
    from repro_torch.sharding import ctx

    cfg = _cfg("arctic-480b", top_k=top_k)
    torch.manual_seed(seed)
    moe = MoE(cfg, torch.float32, "cpu")
    moe.reset_parameters(torch.Generator().manual_seed(seed))
    mesh = M.make_host_mesh(model_axis)
    x = (torch.randn(4, 8, cfg.d_model, generator=torch.Generator().manual_seed(seed + 1)) * 0.5).requires_grad_(True)
    moe.requires_grad_(True)
    with ctx.use_shard_map_mesh(mesh):
        out, aux = moe(x, cfg)
    dy = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed + 2))
    params = [moe.router, moe.w_up, moe.w_gate, moe.w_down]
    grads = torch.autograd.grad((out * dy).sum() + 0.5 * aux, [x] + params)
    return {"out": out.detach(), "aux": aux.detach(), "grads": [g.detach() for g in grads],
            "first": mesh.coordinate()["model"] * (cfg.num_experts // model_axis)}


def case_epochs(runs):
    """Sharded epochs (``_epoch``'s keywords, one dict a run) one after
    another in one world: one process start a rank."""
    return [_epoch(**kw) for kw in runs]


# The sharded serving steps' test size: prompt P, cache S, batch B.
SERVE_B, SERVE_S, SERVE_P, SERVE_STEPS = 4, 16, 6, 8
# (batch, cache rows, prompt, decode steps): the serving runs' ``sizes``.
SERVE = (SERVE_B, SERVE_S, SERVE_P, SERVE_STEPS)


def serve_inputs(cfg, sizes=SERVE):
    """(prompts (B, P), the key) of the serving runs."""
    import numpy as np

    from repro_torch import prng

    b, _, p, _ = sizes
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, cfg.vocab_size, (b, p)).astype(np.int32)
    return prompts, prng.PRNGKey(5)


def serve_run(cfg, state=None, fns=None, forced=None, sizes=SERVE):
    """The prefill and ``steps`` decode steps in this process (``sizes`` =
    (B, S, P, steps)): the unsharded steps on the model, or with ``state``
    and ``fns`` = (prefill, decode) the sharded ones on a world of one;
    each step's logits and greedy tokens, and the cache.  ``forced`` (B,
    steps) feeds the decode steps instead of the greedy tokens."""
    import torch

    from repro_torch import prng
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps
    from repro_torch.models import cache as cache_lib
    from repro_torch.models import lm

    b, seq, p, n_steps = sizes
    if state is None:
        model, cache = lm.init_lm(cfg, seed=0, device="cpu"), cache_lib.init_cache(cfg, b, seq, device="cpu")
        fns = steps.make_prefill_step(cfg), steps.make_serve_step(cfg)
    else:
        model = state
        cache = steps.init_cache_shards(cfg, ShapeConfig("d", seq, b, "decode"), M.make_host_mesh(), device="cpu")
    prefill, decode = fns
    prompts, key = serve_inputs(cfg, sizes)
    logits_all, tokens = [], []
    with torch.no_grad():
        logits, cache = prefill(model, {"tokens": torch.from_numpy(prompts)}, cache, key)
        for i in range(n_steps + 1):
            logits_all.append(logits)
            tokens.append(torch.argmax(logits, dim=-1)[:, None].to(torch.int32))
            if i == n_steps:
                break
            feed = tokens[-1] if forced is None else torch.tensor(forced)[:, i:i + 1]
            logits, cache = decode(model, feed, cache, p + i, prng.fold_in(key, i))
    return logits_all, tokens, cache


def reference_serve(arch, sizes=SERVE, caches=None, **overrides):
    """The reference's ``make_prefill_step`` and ``steps`` greedy
    ``make_serve_step`` (jitted) on the port's seed-0 weights
    (``params_to_jax``), on ``serve_inputs`` with the key of step ``i``
    ``fold_in(key, i)`` (``sizes`` = (B, S, P, steps)): each step's logits
    (numpy), the greedy tokens (B, steps + 1) and each step's split link as
    (its input, its output) tensors, read out of the compiled steps by a
    debug callback.  ``caches``: a list that receives the cache after the
    prefill and after each decode step, as the port's list of layers (an
    attention layer's leaves as tensors, any other layer None), for
    :func:`pinned_cache`.  Runs in the test process (it imports jax)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import ARCHITECTURES as J_ARCHS
    from repro.launch import steps as j_steps
    from repro.models import cache as j_cache
    from repro.models import lm as j_lm
    from repro_torch.models import lm
    from repro_torch.params import params_to_jax, to_tensor

    cfg, jcfg = _cfg(arch, **overrides), _cfg(arch, J_ARCHS, **overrides)
    params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(lm.init_lm(cfg, seed=0, device="cpu").state_dict(),
                                                               cfg))
    prompts, _ = serve_inputs(cfg, sizes)
    b, seq, p, n_steps = sizes
    key = jax.random.PRNGKey(5)
    links, make_link_fn = [], j_lm.make_link_fn

    def recording(*args, **kw):
        fn = make_link_fn(*args, **kw)

        def record(x):
            y = fn(x)
            jax.debug.callback(lambda x, y: links.append((to_tensor(x), to_tensor(y))), x, y)
            return y

        return record

    def layers(cache):
        # The prologue's layers, then unit by unit the pattern's (each
        # stacked over the units): the port's order.
        units = [{k: v[u] for k, v in layer.items()} for u in range(jcfg.resolved_num_units)
                 for layer in cache["units"]]
        return [{k: to_tensor(v) for k, v in layer.items()} if "k" in layer else None
                for layer in list(cache["prologue"]) + units]

    out, tokens = [], []
    j_lm.make_link_fn = recording
    try:
        prefill, decode = jax.jit(j_steps.make_prefill_step(jcfg)), jax.jit(j_steps.make_serve_step(jcfg))
        logits, cache = prefill(params, {"tokens": jnp.asarray(prompts)}, j_cache.init_cache(jcfg, b, seq), key)
        for i in range(n_steps + 1):
            if caches is not None:
                caches.append(layers(cache))
            out.append(np.asarray(logits))
            tokens.append(np.asarray(jnp.argmax(logits, axis=-1))[:, None].astype(np.int32))
            if i == n_steps:
                break
            logits, cache = decode(params, jnp.asarray(tokens[-1]), cache, p + i, jax.random.fold_in(key, i))
        jax.effects_barrier()
    finally:
        j_lm.make_link_fn = make_link_fn
    assert len(links) == n_steps + 1, len(links)
    return out, np.concatenate(tokens, axis=1), links


# The split activation (|x| < 6.1) against the reference's: torch's CPU sums
# run in another order than XLA's, over up to 16 layers before the split
# (the unsharded port measured 1.17e-5 from the reference on reduced jamba,
# 4.8e-6 on kimi-k2, 3.3e-6 on qwen1.5-0.5b).
LINK_INPUT_TOL = dict(rtol=0, atol=2e-5)
# The link's dequantized output against the jitted reference's on the same
# input: XLA fuses the dequantization (1.9e-6 apart at most measured on the
# reduced configs), while one code step is ~0.05 there.  An output further
# from the reference's than this is a flipped code.
LINK_OUTPUT_ATOL = 1e-5


@contextlib.contextmanager
def pinned_link(links):
    """Carry the reference's link outputs (``reference_serve``'s ``links``,
    a step each) into the port's steps run inside: 8-bit link codes are a
    step function, and f32 noise between two correct programs flips one now
    and then.  Each call of the split link checks the port's input against
    the reference's within ``LINK_INPUT_TOL`` and the port's link on the
    reference's input against the reference's output within
    ``LINK_OUTPUT_ATOL``, counts the outputs of the port's link on its own
    input that miss the reference's by more (the flipped codes), and
    returns the reference's output.  Yields the list of those counts, a
    call each."""
    import numpy as np

    from repro_torch.models import lm

    make_link_fn, calls, flips = lm.make_link_fn, iter(links), []

    def pinned(*args, **kw):
        fn = make_link_fn(*args, **kw)

        def carry(x):
            x_ref, y_ref = next(calls)
            np.testing.assert_allclose(x.numpy(), x_ref.numpy(), **LINK_INPUT_TOL)
            np.testing.assert_allclose(fn(x_ref).numpy(), y_ref.numpy(), rtol=0, atol=LINK_OUTPUT_ATOL)
            flips.append(int(((fn(x) - y_ref).abs() > LINK_OUTPUT_ATOL).sum()))
            return y_ref.clone()

        return carry

    lm.make_link_fn = pinned
    try:
        yield flips
    finally:
        lm.make_link_fn = make_link_fn


# An int8 KV cache code is a step function too: a K or V element on a
# code's rounding edge lands one code apart between two correct programs
# (measured: one element of reduced qwen1.5-0.5b's int8 cache, written in
# decode step 13, by the unsharded port as by the sharded one).  At most
# this many codes a write, each at most one code from the reference's.
CACHE_FLIPS = 4


@contextlib.contextmanager
def pinned_cache(caches, prompt_len):
    """Carry the reference's int8 cache codes and scales
    (``reference_serve``'s ``caches``) into the port's cache writes run
    inside, as :func:`pinned_link` carries the link, so that a code on its
    rounding edge is not told apart from a fault.  Each attention layer's
    prefill or decode write (at an int index; the n-th write of a step is
    the step's n-th attention layer) checks the rows the rank stored
    against the reference's rows there: the scales within one bf16 step,
    the codes at most one apart at at most ``CACHE_FLIPS`` elements; then
    stores the reference's.  Yields the list of codes that differed, a
    write each."""
    import numpy as np
    import torch

    from repro_torch.models import attention as A

    write_prefill, write_decode = A._write_prefill, A._write_decode
    flips, writes = [], {}

    def carry(cache, step, first, lo, hi):
        n = writes.get(step, 0)
        writes[step] = n + 1
        ref = [layer for layer in caches[step] if layer is not None][n]
        diff = 0
        for name in ("k", "v", "k_scale", "v_scale"):
            got, want = cache[name][:, lo:hi], ref[name][:, first + lo:first + hi]
            assert got.shape == want.shape, (name, got.shape, want.shape)
            if name.endswith("scale"):
                np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=2.0 ** -7, atol=0)
            else:
                d = (got.to(torch.int32) - want.to(torch.int32)).abs()
                assert d.numel() == 0 or int(d.max()) <= 1, f"{name}: a code {int(d.max())} steps apart"
                diff += int((d > 0).sum())
            cache[name][:, lo:hi] = want
        assert diff <= CACHE_FLIPS, f"step {step}, attention layer {n}: {diff} codes differ"
        flips.append(diff)

    def span(cache, shard):
        c = cache["k"].shape[1]
        return c, (0, c) if shard is None else (shard.first, shard.length)

    def prefill(cache, k, v, shard=None):
        out = write_prefill(cache, k, v, shard)
        c, (first, length) = span(cache, shard)
        carry(cache, 0, first, 0, c if k.shape[1] > length else max(0, min(k.shape[1] - first, c)))
        return out

    def decode(cache, k, v, index, shard=None):
        out = write_decode(cache, k, v, index, shard)
        c, (first, length) = span(cache, shard)
        row = int(index) % length - first
        lo, hi = (row, row + 1) if 0 <= row < c else (0, 0)
        carry(cache, int(index) - prompt_len + 1, first, lo, hi)
        return out

    A._write_prefill, A._write_decode = prefill, decode
    try:
        yield flips
    finally:
        A._write_prefill, A._write_decode = write_prefill, write_decode


def _full(t, mesh, vocab_dim: bool, batch: int = SERVE_B):
    """Every rank's (rows, vocabulary slice) put together: over ``model``
    along the last dim when ``vocab_dim``, then over the data rows."""
    from repro_torch.sharding import comm, rules

    if vocab_dim and mesh.shape["model"] > 1:
        t = comm.all_gather_along(t, mesh.group("model"), t.dim() - 1)
    axes = rules.batch_spec(mesh, batch)
    if axes is not None:
        t = comm.all_gather_along(t, mesh.group(axes), 0)
    return t


def _serve(forced, arch="qwen1.5-0.5b", model_axis=1, fsdp="on", moe_shard_map=False, cfg_over=None,
           pinned=None, pinned_caches=None, sizes=SERVE):
    """The sharded prefill, then ``steps`` decode steps (the step's key
    ``fold_in(key, i)``) fed ``forced[:, i]`` (teacher forcing), at
    ``sizes`` = (B, S, P, steps): the whole logits of each step, each
    step's greedy tokens (``steps.greedy_tokens``), the tally of the real
    collectives, by axis, and each decode step's collectives as (kind,
    axes, output shape) (``step_shapes``).  ``pinned``: the path of
    ``reference_serve``'s ``links``, carried by :func:`pinned_link`; the
    flipped codes a step are then ``flips``.  ``pinned_caches``: the path
    of ``reference_serve``'s ``caches``, carried by :func:`pinned_cache`;
    the differing cache codes a write are then ``cache_flips``."""
    import torch

    from repro_torch import prng
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.sharding import comm

    b, seq, p, n_steps = sizes
    cfg = _cfg(arch, **(cfg_over or {}))
    mesh = M.make_host_mesh(model_axis)
    kw = dict(fsdp=fsdp, moe_shard_map=moe_shard_map)
    prefill, _ = steps.build_sharded_step(cfg, ShapeConfig("p", seq, b, "prefill"), mesh, **kw)
    decode, _ = steps.build_sharded_step(cfg, ShapeConfig("d", seq, b, "decode"), mesh, **kw)
    state = prefill.place(lm.init_lm(cfg, seed=0, device="cpu"))
    cache = steps.init_cache_shards(cfg, ShapeConfig("d", seq, b, "decode"), mesh, device="cpu")
    prompts, key = serve_inputs(cfg, sizes)
    out = {"logits": [], "tokens": [], "tally": {}, "calls": {}, "flips": [], "cache_flips": [], "step_shapes": [],
           "cache_shapes": [{n: tuple(t.shape) for n, t in layer.items()} for layer in cache]}

    def counted(fn, *args):
        # Only the steps' own collectives are tallied.
        with comm.tally() as tally:
            res = fn(*args)
        for field, by_axis in (("tally", tally.by_axis), ("calls", tally.calls)):
            for axes, kinds in by_axis.items():
                for kind, n in kinds.items():
                    out[field].setdefault(axes, {}).setdefault(kind, 0)
                    out[field][axes][kind] += n
        out["step_shapes"].append(tally.shapes)
        return res

    links = contextlib.nullcontext([]) if pinned is None else pinned_link(torch.load(pinned))
    codes = contextlib.nullcontext([]) if pinned_caches is None else pinned_cache(torch.load(pinned_caches), p)
    with torch.no_grad(), links as out["flips"], codes as out["cache_flips"]:
        logits, cache = counted(prefill, state, {"tokens": torch.from_numpy(prompts)}, cache, key)
        for i in range(n_steps + 1):
            out["logits"].append(_full(logits, mesh, True, b))
            out["tokens"].append(_full(steps.greedy_tokens(logits, cfg, mesh), mesh, False, b))
            if i == n_steps:
                break
            feed = torch.tensor(forced)[:, i:i + 1]
            logits, cache = counted(decode, state, feed, cache, p + i, prng.fold_in(key, i))
    return out


def same_on_every_rank(ranks) -> None:
    """Every rank put together the same logits and tokens."""
    import torch

    for r in ranks[1:]:
        for a, b in zip(r["logits"] + r["tokens"], ranks[0]["logits"] + ranks[0]["tokens"]):
            assert torch.equal(a, b)


def _generate(tokens=4):
    """``launch.serve.generate_sharded`` (the CLI's ``--tensor-parallel``)
    on reduced qwen1.5-0.5b over ``make_production_mesh`` (the world's
    ranks): the mesh's shape and the global tokens."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch.serve import generate_sharded

    import torch

    cfg = _cfg("qwen1.5-0.5b")
    prompts, key = serve_inputs(cfg)
    mesh = M.make_production_mesh()
    toks, _ = generate_sharded(cfg, torch.from_numpy(prompts), tokens, mesh, key=key)
    return {"tokens": toks, "mesh": dict(mesh.shape)}


def case_serve(runs):
    """Sharded serving runs in one world, one dict a run: ``_serve``'s
    keywords, or with ``generate=True`` ``_generate``'s."""
    return [_generate(**{k: v for k, v in kw.items() if k != "generate"}) if kw.get("generate") else _serve(**kw)
            for kw in runs]


CASES = {"epochs": case_epochs, "moe": case_moe, "serve": case_serve}


def _main(case, rank, world, tmp, args):
    import torch

    torch.set_num_threads(1)
    from repro_torch.launch import mesh as M

    M.init_world("cpu", rank=int(rank), world_size=int(world), init_method=f"file://{tmp}/store")
    try:
        out = CASES[case](**json.loads(args))
        torch.save(out, pathlib.Path(tmp) / f"out_{rank}.pt")
    finally:
        M.close_world()


if __name__ == "__main__":
    _main(*sys.argv[1:])

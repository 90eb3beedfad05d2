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

def _cfg(arch, **overrides):
    from repro_torch.configs import ARCHITECTURES

    over = dict(ARCTIC) if arch == "arctic-480b" else {}
    over.update(overrides)
    return ARCHITECTURES[arch].reduced(**over)


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


CASES = {"epochs": case_epochs, "moe": case_moe}


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

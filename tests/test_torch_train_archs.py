"""The trainer (``repro_torch.launch.train``) on every LM config (ROADMAP
A12c): each of the ten reduced configs trains two steps on the CPU, the
CLI takes them all, a resumed run equals an uninterrupted one bit for bit
(jamba: Mamba, MoE, attention; musicgen: the frontend zeros), a port
checkpoint of jamba loads in the reference's ``restore_checkpoint`` with
the port's values, and Adam taken a slice of a leaf at a time equals the
whole-leaf update bit for bit."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import restore_checkpoint as j_restore  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.optim import AdamConfig as JAdamConfig  # noqa: E402
from repro.optim import init_adam as j_init_adam  # noqa: E402
from repro_torch.configs import ARCHITECTURES  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.optim import AdamConfig, adam, adam_update, init_adam  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402

LM_CONFIGS = sorted(ARCHITECTURES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_registry_holds_the_ten_lm_configs():
    assert len(LM_CONFIGS) == 10


@pytest.mark.parametrize("arch", LM_CONFIGS)
def test_train_runs_every_lm_config(arch):
    _, losses, cfg = t_train.train(arch, steps=2, batch=2, seq=16, log_every=1000, device="cpu")
    assert cfg.name == ARCHITECTURES[arch].reduced().name
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_cli_takes_the_recurrent_and_frontend_configs(caplog):
    caplog.set_level("INFO", logger="repro_torch.launch.train")
    for arch in ("xlstm-350m", "qwen2-vl-72b"):
        caplog.clear()
        t_train.main(["--arch", arch, "--steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu"])
        assert "final loss" in caplog.text, arch
    # The sharded trainer (A13a) takes them too: a world of one on the CPU.
    caplog.clear()
    t_train.main(["--arch", "jamba-v0.1-52b", "--steps", "1", "--batch", "2", "--seq", "16", "--device", "cpu",
                  "--sharded", "--fsdp", "expert"])
    assert "final loss" in caplog.text


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "musicgen-medium"])
def test_resume_reproduces_the_uninterrupted_run(tmp_path, arch):
    """Checkpoints every 2 of 4 steps; the last one removed, a resumed run
    gives the uninterrupted run's losses of steps 3-4 and its final
    weights, bit for bit."""
    d = str(tmp_path)
    kw = dict(steps=4, batch=2, seq=16, log_every=1000, steps_per_epoch=2, ckpt_dir=d, ckpt_every=2, device="cpu")
    full_model, full, _ = t_train.train(arch, **kw)
    os.remove(os.path.join(d, "train_00000004.npz"))
    model, tail, _ = t_train.train(arch, resume=True, **kw)
    np.testing.assert_array_equal(np.asarray(full[2:]), np.asarray(tail))
    for (name, a), b in zip(full_model.state_dict().items(), model.state_dict().values()):
        assert torch.equal(a, b), name


def test_jamba_checkpoint_loads_in_reference_restore(tmp_path):
    """The port's checkpoint of reduced jamba, in the reference's layout:
    ``repro.checkpoint.restore_checkpoint`` fills the reference's own
    params / Adam state / key template with it, and its values are the
    port's (the stacked Mamba, MoE and attention leaves, the f32
    ``A_log``, the moments)."""
    d = str(tmp_path)
    model, _, tcfg = t_train.train("jamba-v0.1-52b", steps=2, batch=2, seq=16, log_every=1000, ckpt_dir=d,
                                   device="cpu")
    jcfg = j_get_config("jamba-v0.1-52b").reduced()

    def template():
        params = j_lm.init_lm(jax.random.PRNGKey(0), jcfg)
        return {"params": params, "opt_state": j_init_adam(params, JAdamConfig()), "key": jax.random.PRNGKey(0)}

    restored, step = j_restore(d, jax.eval_shape(template), name="train")
    assert step == 2 and int(restored["opt_state"].step) == 2
    got = params_from_jax(jax.tree_util.tree_map(np.asarray, restored["params"]), tcfg)
    assert any(".mix.A_log" in n for n in got) and any(".ffn.w_up" in n for n in got)
    for name, t in model.state_dict().items():
        assert torch.equal(got[name], t), name
    mu = params_from_jax(jax.tree_util.tree_map(np.asarray, restored["opt_state"].mu), tcfg)
    assert all(float(m.abs().max()) > 0 for n, m in mu.items() if not n.startswith("link."))


def test_adam_in_slices_equals_the_whole_leaf(monkeypatch):
    """``adam_update`` takes a leaf ``SLICE_ELEMS`` at a time (rows of the
    first axis), the clip's scale inside the slice: with slices of at most
    7 elements (a (3, 7) leaf a row at a time, a (4, 3, 5) leaf one
    15-element row at a time, a (9,) leaf as 7 + 2, a 0-d leaf whole)
    every parameter and moment equals the one-slice update's bit for bit,
    over three steps with the clip and weight decay active."""
    shapes = {"w": (3, 7), "e": (4, 3, 5), "b": (9,), "s": ()}

    def run(slice_elems):
        monkeypatch.setattr(adam, "SLICE_ELEMS", slice_elems)
        g2 = torch.Generator().manual_seed(1)
        params = {n: torch.randn(s, generator=g2) for n, s in shapes.items()}
        cfg = AdamConfig(lr=1e-2, grad_clip_norm=0.5, weight_decay=0.01)
        state = init_adam(params, cfg)
        for _ in range(3):
            grads = {n: torch.randn(s, generator=g2) * 3 for n, s in shapes.items()}
            _, state, _ = adam_update(grads, params, state, cfg)
        return params, state

    assert len(adam._row_slices(torch.zeros((4, 3, 5)))) == 1
    monkeypatch.setattr(adam, "SLICE_ELEMS", 7)
    assert len(adam._row_slices(torch.zeros((4, 3, 5)))) == 4
    p1, s1 = run(1 << 24)
    p2, s2 = run(7)
    for n in shapes:
        assert torch.equal(p1[n], p2[n]) and torch.equal(s1.mu[n], s2.mu[n]) and torch.equal(s1.nu[n], s2.nu[n]), n

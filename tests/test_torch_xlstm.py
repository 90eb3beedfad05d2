"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against the
reference's (``src/repro/models/xlstm.py``), on the reference's weights
(``init_mlstm`` / ``init_slstm`` through ``to_tensor``), in f32 at reduced
xlstm-350m's widths (d_model 256, 4 heads of 64) with ``scan_chunk`` 8, so
that 13 and 21 positions span two and three chunks, the last one padded.
Inputs are drawn from a seed with numpy.

mLSTM: the parallel form, the chunked form without and from a carried
state (its padded rows masked), the closed-form final state, the recurrent
step; the module's dispatch (a cache and one position take the step, else
the chunked form, whose state lands in the cache).  sLSTM: the loop over
time with and without a carried state, and one-position steps.  Every
state starts at ``m = NEG_INF``.

Bar: ``rtol = atol = 1e-5`` (tests/test_torch_moe.py's): torch's CPU
einsums and cumsums sum in other orders than XLA's.  The largest distance
measured over these cases was 4.3e-6 (outputs) and 3.8e-6 (states).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHITECTURES as J_ARCHS  # noqa: E402
from repro.models import xlstm as j_xlstm  # noqa: E402
from repro_torch.configs import ARCHITECTURES as T_ARCHS  # noqa: E402
from repro_torch.models import xlstm as t_xlstm  # noqa: E402
from repro_torch.params import to_tensor  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
B = 2
J = {name: jax.jit(getattr(j_xlstm, name), static_argnums=2)
     for name in ("mlstm_parallel", "mlstm_chunked", "mlstm_final_state", "mlstm_step", "slstm_forward")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TCFG = T_ARCHS["xlstm-350m"].reduced(scan_chunk=8)


@pytest.fixture(scope="module")
def cfg():
    """The reference's config; the port's twin is ``TCFG``."""
    return J_ARCHS["xlstm-350m"].reduced(scan_chunk=8)


def _pair(cfg, kind, seed):
    """(reference params, the port's block holding them)."""
    init = j_xlstm.init_mlstm if kind == "mlstm" else j_xlstm.init_slstm
    jp = init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    mod = (t_xlstm.MLSTM if kind == "mlstm" else t_xlstm.SLSTM)(TCFG, torch.float32, "cpu")
    mod.load_state_dict({k: to_tensor(np.asarray(v)) for k, v in jp.items()})
    return jp, mod


@pytest.fixture(scope="module")
def mlstm(cfg):
    return _pair(cfg, "mlstm", 5)


@pytest.fixture(scope="module")
def slstm(cfg):
    return _pair(cfg, "slstm", 6)


def _x(cfg, s, seed):
    return np.random.default_rng(seed).standard_normal((B, s, cfg.d_model)).astype(np.float32)


def _t(state):
    return {k: torch.tensor(np.asarray(v)) for k, v in state.items()}


def _close_states(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)


def _carried_mlstm_state(cfg, seed):
    """A state as the reference's chunked form leaves it, from 13 tokens."""
    jp, _ = _pair(cfg, "mlstm", seed)
    _, st = J["mlstm_chunked"](jp, jnp.asarray(_x(cfg, 13, seed)), cfg)
    return st


def test_mlstm_parallel(cfg, mlstm):
    jp, mod = mlstm
    x = _x(cfg, 13, 1)
    got = t_xlstm.mlstm_parallel(mod, torch.tensor(x), TCFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(J["mlstm_parallel"](jp, jnp.asarray(x), cfg)), **TOL)


@pytest.mark.parametrize("s", [13, 21])
def test_mlstm_chunked(cfg, mlstm, s):
    jp, mod = mlstm
    x = _x(cfg, s, s)
    got, st = t_xlstm.mlstm_chunked(mod, torch.tensor(x), TCFG)
    want, wst = J["mlstm_chunked"](jp, jnp.asarray(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _close_states(st, wst)


def test_mlstm_chunked_from_a_carried_state(cfg, mlstm):
    """21 positions from a state of 13 earlier ones: the carried state's
    decay enters every chunk, and the padded tail leaves it alone."""
    jp, mod = mlstm
    state = _carried_mlstm_state(cfg, 9)
    x = _x(cfg, 21, 2)
    got, st = t_xlstm.mlstm_chunked(mod, torch.tensor(x), TCFG, _t(state))
    want, wst = J["mlstm_chunked"](jp, jnp.asarray(x), cfg, state)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _close_states(st, wst)


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_mlstm_final_state(cfg, mlstm, carried):
    jp, mod = mlstm
    state = _carried_mlstm_state(cfg, 10) if carried else j_xlstm.init_mlstm_cache(B, cfg)
    x = _x(cfg, 13, 3)
    got = t_xlstm.mlstm_final_state(mod, torch.tensor(x), TCFG, _t(state))
    _close_states(got, J["mlstm_final_state"](jp, jnp.asarray(x), cfg, state))


def test_mlstm_steps(cfg, mlstm):
    """Four recurrent steps from a carried state, each from the port's own."""
    jp, mod = mlstm
    wst = _carried_mlstm_state(cfg, 11)
    st = _t(wst)
    for i in range(4):
        x = _x(cfg, 1, 200 + i)
        got, st = t_xlstm.mlstm_step(mod, torch.tensor(x), TCFG, st)
        want, wst = J["mlstm_step"](jp, jnp.asarray(x), cfg, wst)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _close_states(st, wst)


def test_mlstm_module_dispatch(cfg, mlstm):
    """``MLSTM.forward``: with a cache, 13 positions run the chunked form and
    leave its state in the cache; one position then takes the step; with
    no cache, the chunked form's output and no state."""
    jp, mod = mlstm
    cache = t_xlstm.init_mlstm_cache(B, TCFG, "cpu")
    x1, x2 = _x(cfg, 13, 4), _x(cfg, 1, 5)
    with torch.inference_mode():
        y1 = mod(torch.tensor(x1), TCFG, cache)
        want1, wst = J["mlstm_chunked"](jp, jnp.asarray(x1), cfg, j_xlstm.init_mlstm_cache(B, cfg))
        np.testing.assert_allclose(y1.numpy(), np.asarray(want1), **TOL)
        _close_states(cache, wst)
        y2 = mod(torch.tensor(x2), TCFG, cache)
        want2, wst = J["mlstm_step"](jp, jnp.asarray(x2), cfg, wst)
        np.testing.assert_allclose(y2.numpy(), np.asarray(want2), **TOL)
        _close_states(cache, wst)
        np.testing.assert_allclose(mod(torch.tensor(x1), TCFG).numpy(), np.asarray(want1), **TOL)


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_slstm_over_time(cfg, slstm, carried):
    """13 positions through the loop over time; with a cache, the final
    state too (a state from 5 earlier positions when carried)."""
    jp, mod = slstm
    x = _x(cfg, 13, 6)
    if not carried:
        got, st = t_xlstm.slstm_forward(mod, torch.tensor(x), TCFG)
        want, wst = J["slstm_forward"](jp, jnp.asarray(x), cfg)
        assert st is None and wst is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        return
    _, state = J["slstm_forward"](jp, jnp.asarray(_x(cfg, 5, 7)), cfg, j_xlstm.init_slstm_cache(B, cfg))
    cache = _t(state)
    with torch.inference_mode():
        got = mod(torch.tensor(x), TCFG, cache)
    want, wst = J["slstm_forward"](jp, jnp.asarray(x), cfg, state)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _close_states(cache, wst)


def test_slstm_steps(cfg, slstm):
    """Four one-position steps from a fresh state."""
    jp, mod = slstm
    cache = t_xlstm.init_slstm_cache(B, TCFG, "cpu")
    wst = j_xlstm.init_slstm_cache(B, cfg)
    for i in range(4):
        x = _x(cfg, 1, 300 + i)
        with torch.inference_mode():
            got = mod(torch.tensor(x), TCFG, cache)
        want, wst = J["slstm_forward"](jp, jnp.asarray(x), cfg, wst)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _close_states(cache, wst)


def test_initial_states(cfg):
    """The decode states start as the reference's: zeros, and the
    stabilisers ``m`` at ``NEG_INF``."""
    for t_init, j_init in ((t_xlstm.init_mlstm_cache, j_xlstm.init_mlstm_cache),
                           (t_xlstm.init_slstm_cache, j_xlstm.init_slstm_cache)):
        got, want = t_init(3, TCFG, "cpu"), j_init(3, cfg)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert bool((got["m"] == torch.tensor(t_xlstm.NEG_INF)).all())

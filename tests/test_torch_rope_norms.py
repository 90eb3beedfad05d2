"""The port's M-RoPE, LayerNorm and modality frontend fusion against the
reference's (``repro.models.rope``, ``repro.models.common.layernorm``,
``repro.models.frontends.fuse_frontend``), on inputs made from a seed with
numpy.

M-RoPE degenerates to RoPE when the three position streams are equal, as
they are on every serving path, so it is also checked here with three
distinct streams.  Tolerances: the rotations and norms are elementwise
f32 arithmetic (sin / cos of the same f32 angles, one f32 reduction a
row), held to rtol = atol = 2e-6; the adapter's matmul to 1e-5 (torch's
CPU matmuls sum in another order than XLA's).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHITECTURES as J_ARCHS  # noqa: E402
from repro.models import common as j_common, frontends as j_frontends, lm as j_lm, rope as j_rope  # noqa: E402
from repro_torch.configs import ARCHITECTURES as T_ARCHS  # noqa: E402
from repro_torch.models import common as t_common, frontends as t_frontends, lm as t_lm  # noqa: E402
from repro_torch.models import rope as t_rope  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402

TOL = dict(rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("hd,sections,theta", [
    (128, (16, 24, 24), 1_000_000.0),     # qwen2-vl-72b
    (64, (8, 12, 12), 1_000_000.0),       # its reduced config (_reduced_mrope(64))
    (16, (2, 3, 3), 10_000.0),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mrope_with_distinct_streams(hd, sections, theta, dtype):
    """Temporal, height and width streams drawn apart (image-patch-like
    grids), so every section rotates by its own stream."""
    rng = np.random.default_rng(hd)
    b, s, n = 2, 9, 3
    x = rng.standard_normal((b, s, n, hd)).astype(np.float32)
    pos = np.stack([rng.integers(0, 4000, (b, s)), rng.integers(0, 64, (b, s)), rng.integers(0, 64, (b, s))],
                   axis=1).astype(np.int32)
    assert (pos[:, 0] != pos[:, 1]).any() and (pos[:, 1] != pos[:, 2]).any()
    jdt = getattr(jnp, dtype)
    want = np.asarray(j_rope.apply_rope(jnp.asarray(x, jdt), jnp.asarray(pos), theta, sections).astype(jnp.float32))
    xt = torch.tensor(np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))).to(getattr(torch, dtype))
    got = t_rope.apply_rope(xt, torch.tensor(pos), theta, sections).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=2.0 ** -7)


def test_mrope_equal_streams_is_rope():
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((2, 5, 2, 64)).astype(np.float32))
    pos = t_rope.default_positions(2, 5, offset=7, device="cpu")
    mpos = t_rope.default_positions(2, 5, offset=7, mrope=True, device="cpu")
    assert tuple(mpos.shape) == (2, 3, 5)
    a = t_rope.apply_rope(x, pos, 1e6)
    b = t_rope.apply_rope(x, mpos, 1e6, (8, 12, 12))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("mrope", [False, True])
@pytest.mark.parametrize("offset", [0, 5])
def test_default_positions_are_the_reference(mrope, offset):
    want = np.asarray(j_rope.default_positions(3, 4, offset=offset, mrope=mrope))
    got = t_rope.default_positions(3, 4, offset=offset, mrope=mrope, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_row_positions_broadcast_as_the_paged_step():
    """The reference's paged step broadcasts the slots' lengths to (B, 3, 1)
    under M-RoPE (src/repro/serve/continuous.py:568-574)."""
    lengths = torch.tensor([3, 0, 9], dtype=torch.int32)
    assert t_rope.row_positions(lengths).tolist() == [[3], [0], [9]]
    want = np.asarray(jnp.broadcast_to(jnp.asarray(lengths.numpy())[:, None, None], (3, 3, 1)))
    np.testing.assert_array_equal(t_rope.row_positions(lengths, mrope=True).numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_is_the_reference(dtype):
    """Random scale and bias, and rows with a large mean (the variance is
    the mean of squared deviations, not E[x^2] - E[x]^2)."""
    rng = np.random.default_rng(1)
    d = 48
    x = (rng.standard_normal((3, 5, d)) * 3 + rng.standard_normal((3, 5, 1)) * 50).astype(np.float32)
    scale = rng.standard_normal(d).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32)
    jdt = getattr(jnp, dtype)
    want = np.asarray(j_common.layernorm(jnp.asarray(x, jdt), jnp.asarray(scale, jdt), jnp.asarray(bias, jdt))
                      .astype(jnp.float32))
    norm = t_common.make_norm("layernorm", d, getattr(torch, dtype), "cpu")
    assert isinstance(norm, t_common.LayerNorm)
    cast = lambda a: torch.tensor(np.asarray(jnp.asarray(a, jdt).astype(jnp.float32))).to(getattr(torch, dtype))
    with torch.no_grad():
        norm.scale.copy_(cast(scale))
        norm.bias.copy_(cast(bias))
        got = norm(cast(x)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=2.0 ** -7)


def test_norm_init_is_the_reference():
    for kind in ("rmsnorm", "layernorm"):
        want = j_common.init_norm(None, 8, kind, jnp.float32)
        norm = t_common.make_norm(kind, 8, torch.float32, "cpu")
        norm.reset_parameters()
        got = dict(norm.named_parameters())
        assert set(got) == set(want)
        for name, val in want.items():
            np.testing.assert_array_equal(got[name].detach().numpy(), np.asarray(val))
    with pytest.raises(ValueError, match="unknown norm"):
        t_common.make_norm("batchnorm", 8, torch.float32, "cpu")


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "musicgen-medium"])
def test_fuse_frontend_is_the_reference(arch):
    """The adapter on the reference's weights: the first F embeddings are
    replaced by ``frontend_embed @ proj``, the rest kept; no embedding
    leaves ``x`` as it is."""
    jcfg, tcfg = J_ARCHS[arch].reduced(), T_ARCHS[arch].reduced()
    params = j_lm.init_lm(jax.random.PRNGKey(1), jcfg)
    model = t_lm.LM(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    fe = rng.standard_normal((2, jcfg.frontend_len, jcfg.d_model)).astype(np.float32)
    want = np.asarray(j_frontends.fuse_frontend(params["frontend"], jnp.asarray(x), jnp.asarray(fe)))
    with torch.no_grad():
        got = t_frontends.fuse_frontend(model.frontend, torch.tensor(x), torch.tensor(fe)).numpy()
        same = t_frontends.fuse_frontend(model.frontend, torch.tensor(x), None)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[:, jcfg.frontend_len:], x[:, jcfg.frontend_len:])
    np.testing.assert_array_equal(same.numpy(), x)

"""Context-parallel serving on four gloo ranks (tests/_dist_ranks.py), for
the ``test_torch_context_parallel_*`` files: global batch 1, so no data
axis can split the batch and ``rules.cache_pspecs`` puts every attention
layer's KV sequence on ``data`` (where ``data`` divides its length).  The
sharded prefill and decode steps run on the ranks against the reference's
jitted ``make_prefill_step`` / ``make_serve_step`` on the same weights
(``_dist_ranks.reference_serve``), fed the reference's greedy tokens.
"""

from __future__ import annotations

import numpy as np

import _dist_ranks as D

# Every step's logits (|x| < ~1.3) within this of the reference's: the
# ranks' partials are merged in another order than the reference's
# 64-row walk over the whole cache, a few f32 ulps.
ATOL = 2e-6


# At most this many flipped link codes a step (tests/test_torch_sharded_steps_gathered.py).
FLIPS = 4


def run(arch, meshes, sizes, tmp_path_factory, cfg_over=None, pinned_caches=False):
    """(reference (logits, tokens, links, caches), the ranks' results a
    mesh) for ``meshes`` of (data, model) run one after another in one
    world of 4, fed the reference's greedy tokens, the reference's
    split-link outputs carried (``D.pinned_link``: an 8-bit link code is a
    step function, and f32 noise between two correct programs flips one
    now and then).  ``pinned_caches``: the reference's int8 cache codes
    carried too (``D.pinned_cache``)."""
    import torch

    caches = []
    ref_logits, ref_tokens, links = D.reference_serve(arch, sizes=sizes, caches=caches, **(cfg_over or {}))
    tmp = tmp_path_factory.mktemp("ranks")
    torch.save(links, tmp / "links.pt")
    torch.save(caches, tmp / "caches.pt")
    forced = ref_tokens[:, :sizes[3]].tolist()
    runs = [dict(arch=arch, model_axis=m, forced=forced, sizes=list(sizes), cfg_over=cfg_over,
                 pinned=str(tmp / "links.pt"), pinned_caches=str(tmp / "caches.pt") if pinned_caches else None)
            for _, m in meshes]
    ranks = D.run_ranks("serve", 4, tmp, runs=runs)
    return (ref_logits, ref_tokens, links, caches), [[r[i] for r in ranks] for i in range(len(runs))]


def check_against_reference(reference, ranks) -> None:
    """Every rank put the same logits together, each step's within ATOL of
    the reference's, the greedy tokens are the reference's, and the port's
    own link flipped at most FLIPS codes a step."""
    import torch

    D.same_on_every_rank(ranks)
    ref_logits, ref_tokens = reference[:2]
    for r in ranks:
        assert len(r["flips"]) == len(ref_logits) and max(r["flips"]) <= FLIPS, r["flips"]
    for i, (got, want) in enumerate(zip(ranks[0]["logits"], ref_logits)):
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL, err_msg=f"step {i}")
    np.testing.assert_array_equal(torch.cat(ranks[0]["tokens"], dim=1).numpy(), ref_tokens)


def check_collectives(ranks, cfg, data, model) -> None:
    """Each decode step all-gathers over ``data`` one buffer of flash
    decode's partials a context-parallel layer, ``(data, n)`` f32 with
    ``n = B x KV / model x G x S x (hd + 2)`` (S = 1 on the CPU), and no
    cache leaf (nor a slice of one) over ``data``."""
    hd, kv, h = cfg.resolved_head_dim, cfg.num_kv_heads, cfg.num_heads
    n = 1 * (kv // model) * (h // kv) * (hd + 2)
    layers = sum(spec.kind == "attn" for spec in cfg.all_layers())
    for r in ranks:
        leaves = {s for layer in r["cache_shapes"] for s in layer.values()}
        numels = {int(np.prod(s)) for s in leaves} | {int(np.prod(s)) * data for s in leaves}
        for step in r["step_shapes"][1:]:
            on_data = [shape for kind, axes, shape in step if axes == "data" and kind == "all-gather"]
            assert on_data.count((data, n)) == layers, (on_data, n)
            assert not [s for s in on_data if s != (data, n) and int(np.prod(s)) in numels], on_data

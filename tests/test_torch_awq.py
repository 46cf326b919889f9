"""Parity of the port's AWQ search (qdm_tpu_torch.quant.awq) with the JAX
package's, on the same seeded inputs.

Tolerances: the losses of every grid ratio within 1e-5 relative (f32
sums in another order and XLA's f32 pow, which rounds some inputs 1 ulp
away from PyTorch's); the chosen ratio the same wherever the two smallest
losses differ by more than that.  The clip search: the same threshold for
every (channel, group) except where the port's errors of the two
candidate thresholds lie within 1e-5 of each other; batching the search
over output channels changes nothing.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qdm_tpu.config import QuantConfig as JQuantConfig
from qdm_tpu.quant import awq as jawq
from qdm_tpu.quant.smooth import ScalingGroup as JGroup

from qdm_tpu_torch.config import QuantConfig as TQuantConfig
from qdm_tpu_torch.quant import awq as tawq
from qdm_tpu_torch.quant.smooth import ScalingGroup as TGroup


def _inputs(s=128, c=256, n=384, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((s, c)).astype(np.float32)
    x[:, :4] *= 20.0                         # outlier channels: what AWQ protects
    w = (rng.standard_normal((n, c)) / np.sqrt(c)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("zero_point", [True, False])
def test_search_best_scale_matches_jax(zero_point):
    x, w = _inputs()
    js, jl = jawq.search_best_scale(jnp.asarray(x), jnp.asarray(w), n_bits=4,
                                    group_size=128, zero_point=zero_point)
    ts, tl = tawq.search_best_scale(torch.from_numpy(x), torch.from_numpy(w), 4, 128,
                                    zero_point)
    jl, tl = np.asarray(jl, np.float64), tl.numpy().astype(np.float64)
    assert tl.shape == jl.shape == (20,)
    assert np.max(np.abs(tl - jl) / jl) <= 1e-5
    best = int(np.argmin(tl))
    two = np.sort(jl)[:2]
    if (two[1] - two[0]) / two[0] > 1e-5:
        assert best == int(np.argmin(jl))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
    assert jl[0] > jl.min()      # the search moved away from the plain grid point


@pytest.mark.parametrize("zero_point", [True, False])
def test_compute_best_clip_matches_jax(zero_point):
    x, w = _inputs(s=1100, c=256, n=200, seed=1)   # 1100 rows: sampled every 2nd
    want = np.asarray(jawq.compute_best_clip(jnp.asarray(w), jnp.asarray(x), n_bits=4,
                                             group_size=128, zero_point=zero_point))
    got = tawq.compute_best_clip(torch.from_numpy(w), torch.from_numpy(x), 4, 128,
                                 zero_point).numpy()
    assert got.shape == want.shape == (200, 2)
    org_max = np.abs(w.reshape(200, 2, 128)).max(-1)
    steps = np.rint((1 - want / org_max) * 20).astype(int)        # JAX's chosen step
    assert steps.min() >= 0 and steps.max() < 10 and steps.max() > 0
    differ = got != want
    if differ.any():
        errs, _ = tawq.clip_errors(torch.from_numpy(w), torch.from_numpy(x), 4, 128,
                                   zero_point)
        e = errs.numpy().astype(np.float64)
        n_i, g_i = np.nonzero(differ)
        mine = e.min(axis=0)[n_i, g_i]
        theirs = e[steps[n_i, g_i], n_i, g_i]
        assert np.all(np.abs(theirs - mine) <= 1e-5 * np.maximum(mine, 1e-30))
    assert differ.mean() < 0.05
    batched = tawq.compute_best_clip(torch.from_numpy(w), torch.from_numpy(x), 4, 128,
                                     zero_point, oc_batch=64)
    assert torch.equal(batched, torch.from_numpy(got))


def test_apply_clip_to_kernel_matches_jax():
    x, w = _inputs(s=64, c=256, n=96, seed=2)
    mv = (np.abs(w).reshape(96, 2, 128).max(-1) * 0.7).astype(np.float32)
    want = np.asarray(jawq.apply_clip_to_kernel(jnp.asarray(w.T), jnp.asarray(mv)))
    got = tawq.apply_clip_to_kernel(torch.from_numpy(w.T.copy()), torch.from_numpy(mv))
    assert np.array_equal(got.numpy(), want)


def _tree(seed=3):
    """One LayerNorm -> (to_q, to_k, to_v) group and one -> net_0/proj."""
    rng = np.random.default_rng(seed)
    c = 256

    def dense(n):
        return {"kernel": (rng.standard_normal((c, n)) / np.sqrt(c)).astype(np.float32)}

    return {"norm1": {"scale": np.ones(c, np.float32) + 0.1 * rng.standard_normal(c).astype(
                np.float32), "bias": 0.1 * rng.standard_normal(c).astype(np.float32)},
            "norm3": {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)},
            "attn1": {"to_q": dense(c), "to_k": dense(c), "to_v": dense(c)},
            "ff": {"net_0": {"proj": dense(512)}}}


def test_awq_search_and_apply_matches_jax():
    """Scale migration and clipping over two SD-shaped groups.  The norms
    and the unclipped to_q / to_k agree within 1e-5 of their magnitude (the
    scales differ by XLA's pow ulps).  A clipped kernel's (channel, group)
    block moves by a whole shrink step where the clip search meets a near
    tie, which a 1-ulp change of the scaled weight can break either way:
    at most 5% of the blocks may do that (3% here)."""
    tree = _tree()
    groups = [(("norm1",), (("attn1", "to_q"), ("attn1", "to_k"), ("attn1", "to_v"))),
              (("norm3",), (("ff", "net_0", "proj"),))]
    x, _ = _inputs(s=128, c=256, seed=4)
    feats = {"attn1/to_q": x, "ff/net_0/proj": np.abs(x) * 0.5}
    cfg = {"w_bit": 4, "q_group_size": 128, "zero_point": True}
    want = jax.device_get(jawq.awq_search_and_apply(
        jax.tree_util.tree_map(jnp.asarray, tree), [JGroup(p, l) for p, l in groups],
        {k: jnp.asarray(v) for k, v in feats.items()}, JQuantConfig.from_dict(cfg)))
    ttree = jax.tree_util.tree_map(torch.from_numpy, tree)
    got = tawq.awq_search_and_apply(ttree, [TGroup(p, l) for p, l in groups],
                                    {k: torch.from_numpy(v) for k, v in feats.items()},
                                    TQuantConfig.from_dict(cfg))
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        keys = tuple(p.key for p in path)
        node = got
        for k in keys:
            node = node[k]
        leaf = np.asarray(leaf)
        diff = np.abs(node.numpy() - leaf) > 1e-5 * np.max(np.abs(leaf))
        if keys[-2] in ("to_v", "proj"):
            blocks = diff.T.reshape(leaf.shape[1], -1, 128).any(axis=-1)
            assert blocks.mean() <= 0.05, (keys, blocks.mean())
        else:
            assert not diff.any(), keys

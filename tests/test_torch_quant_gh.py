"""Quantized gradients at the source (``gh_precision``, B10's plain version)
against the JAX package's ``quantize_gh`` on the CPU.

The reference quantizes inside its jitted round, where XLA folds the
constant divisor of ``amax / qmax`` into a multiply by ``f32(1 / qmax)``;
the port's ``quantize_gh`` is that program's arithmetic, so it is held
bitwise against ``jax.jit(quantize_gh)`` on the same key (and the eager
reference's true division is shown to differ at a capped qmax). The key
and block rule: each device block of the reference's layout draws with the
tree's key folded with ``SALT_SR`` and the block, over the block's [slots,
2] (padding rows round to 0); the engine's ``_quantize`` is held against
that construction at ``num_actors`` 2 with an odd row count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_ray_tpu_torch as tx
from xgboost_ray_tpu.ops.grow import SALT_SR as JAX_SALT_SR
from xgboost_ray_tpu.ops.objectives import quantize_gh as jax_quantize_gh
from xgboost_ray_tpu_torch.engine import TorchEngine
from xgboost_ray_tpu_torch.ops import objectives as O
from xgboost_ray_tpu_torch.ops.grow import SALT_SR
from xgboost_ray_tpu_torch.ops.random import fold_in, prng_key
from xgboost_ray_tpu_torch.params import parse_params


def _key(k):
    return tuple(int(w) for w in np.asarray(k))


def _jax(gh, mode, key, max_rows=None):
    f = jax.jit(lambda g, k: jax_quantize_gh(g, mode, k, max_rows=max_rows))
    q, s = f(jnp.asarray(gh), key)
    return np.asarray(q), np.asarray(s)


def _port(gh, mode, key, max_rows=None):
    q, s = O.quantize_gh(torch.from_numpy(gh), mode, _key(key),
                         max_rows=max_rows)
    return q.numpy(), s.numpy()


@pytest.mark.parametrize("mode,max_rows", [
    ("int8", None), ("int16", None), ("int16", 10_500_000),
    ("int8", 20_000_000), ("int16", 200_000)])
def test_quantize_gh_bitwise_jax(mode, max_rows):
    """Random gradients with a zero row and a clip-range spread: the
    quantized values and the scales equal the reference's bit for bit."""
    rng = np.random.RandomState(7)
    gh = (rng.randn(4000, 2) * np.array([3.0, 0.5])).astype(np.float32)
    gh[::97] = 0.0
    key = jax.random.PRNGKey(11)
    q, s = _port(gh, mode, key, max_rows)
    jq, js = _jax(gh, mode, key, max_rows)
    assert q.dtype == jq.dtype
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    assert (q[::97] == 0).all()
    qmax = O.gh_qmax(mode, max_rows)
    assert np.abs(q).max() <= qmax


def test_quantize_gh_on_grid_zero_channel_and_clip():
    """On-grid values map to themselves under every key; an all-zero
    channel keeps scale 1 and zeros; large values stay within qmax."""
    ks = np.array([-127, -3, 0, 1, 64, 127], np.float32)
    scale = np.float32(127.0) * np.float32(1.0 / 127.0)
    gh = np.stack([ks * scale, np.zeros_like(ks)], axis=1).astype(np.float32)
    outs = {_port(gh, "int8", jax.random.PRNGKey(s))[0].tobytes()
            for s in range(8)}
    assert len(outs) == 1
    q, s = _port(gh, "int8", jax.random.PRNGKey(0))
    np.testing.assert_array_equal(q[:, 1], 0)
    assert s[1] == 1.0
    jq, js = _jax(gh, "int8", jax.random.PRNGKey(0))
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)


def test_scale_folds_the_constant_divisor():
    """The pinned XLA arithmetic: under jit ``amax / qmax`` is ``amax *
    f32(1 / qmax)`` (at the capped qmax 204 the two differ), and ``g / s``
    is a true division."""
    rng = np.random.RandomState(3)
    gh = np.abs(rng.randn(5000, 2)).astype(np.float32) * 3
    key = jax.random.PRNGKey(5)
    _, js = _jax(gh, "int16", key, 10_500_000)
    amax = np.abs(gh).max(axis=0)
    mul = (amax * (np.float32(1) / np.float32(204))).astype(np.float32)
    div = (amax / np.float32(204)).astype(np.float32)
    np.testing.assert_array_equal(js, mul)
    assert not np.array_equal(mul, div)
    q, s = _port(gh, "int16", key, 10_500_000)
    np.testing.assert_array_equal(s, mul)


def test_qmax_caps_at_the_row_bound():
    """``max_rows`` caps the grid so a root's int32 sum cannot wrap: 204 at
    the HIGGS split's 10.5M rows (int16), int8's 127 shrinking past 16.9M
    rows; a root whose every row sits at +-qmax sums exactly below 2^31."""
    assert O.gh_qmax("int16", 10_500_000) == 204
    assert O.gh_qmax("int8", 10_500_000) == 127
    assert O.gh_qmax("int8", 16_909_321) == 126
    assert O.gh_qmax("int8") == 127 and O.gh_qmax("int16") == 32767
    n = 10_500_000
    assert O.gh_qmax("int16", n) * n < 2 ** 31
    # the root of a logistic objective: every h at absmax rounds to qmax
    gh = torch.full((64, 2), 0.25)
    q, _ = O.quantize_gh(gh, "int16", (0, 3), max_rows=n)
    assert int(q.abs().max()) == 204
    assert int(q[:, 1].to(torch.int64).sum()) * (n // 64) < 2 ** 31
    with pytest.raises(ValueError, match="unknown gh_precision"):
        O.gh_qmax("int4")


def test_engine_blocks_and_keys_match_the_reference_layout():
    """``TorchEngine._quantize`` at ``num_actors`` 2 over 201 rows (blocks
    of 101; the second holds a padding row): each block is the reference's
    ``quantize_gh`` of the block's [101, 2] under the tree's key folded
    with ``SALT_SR`` and the block index, at the merged absmax's scales."""
    assert SALT_SR == JAX_SALT_SR
    rng = np.random.RandomState(2)
    x = rng.randn(201, 4).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    shards = [{"data": x[:101], "label": y[:101]},
              {"data": x[101:], "label": y[101:]}]
    eng = TorchEngine(shards, parse_params({
        "objective": "binary:logistic", "gh_precision": "int8",
        "seed": 9}), device="cpu")
    assert eng.slots == 101 and eng.n_actors == 2
    assert [b[0] for b in eng.blocks] == [0, 1]
    tree_key = fold_in(fold_in(prng_key(9), 0), 0)
    q, s = eng._quantize(tree_key, eng.gh[0], 0)
    gh = eng.gh[0].numpy()
    jkey = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(9), 0), 0)
    srkey = jax.random.fold_in(jkey, JAX_SALT_SR)
    amax = np.abs(gh).max(axis=0)

    def ref_block(d):
        blk = np.zeros((101, 2), np.float32)
        part = gh[d * 101:(d + 1) * 101]
        blk[:part.shape[0]] = part
        f = jax.jit(lambda g, k: jax_quantize_gh(g, "int8", k,
                                                 max_rows=202))
        # the reference merges the absmax over the actors (pmax): feed it
        # the world's by one extra row carrying it, then drop that row
        with_amax = np.concatenate([blk, amax[None]], axis=0)
        qq, ss = f(jnp.asarray(with_amax), jax.random.fold_in(srkey, d))
        return np.asarray(qq)[:part.shape[0]], np.asarray(ss)

    q0, s0 = ref_block(0)
    q1, s1 = ref_block(1)
    np.testing.assert_array_equal(s.numpy(), s0)
    np.testing.assert_array_equal(s0, s1)
    np.testing.assert_array_equal(q.numpy(), np.concatenate([q0, q1]))
    assert eng.gh_plane_bytes_per_shard() == 101 * 2 * 1


@pytest.mark.parametrize("params,exc,match", [
    ({"gh_precision": "int4"}, ValueError, "Unknown gh_precision"),
    ({"hist_quant": "int4"}, ValueError, "Unknown hist_quant"),
    ({"hist_quant": "int8_block", "hist_quant_block": 100}, ValueError,
     "hist_quant_block must be a power of two"),
    ({"hist_quant_block": 32}, ValueError, "hist_quant_block"),
    ({"gh_precision": "int8", "booster": "gblinear"}, NotImplementedError,
     "no gh histogram plane"),
])
def test_refusals_with_the_reference_messages(params, exc, match):
    with pytest.raises(exc, match=match):
        parse_params({"objective": "binary:logistic", **params})


def test_custom_objective_refuses_quantized_gradients():
    x = np.random.default_rng(0).standard_normal((40, 3)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)

    def obj(pred, dtrain):
        return pred - y, np.ones_like(pred)

    with pytest.raises(NotImplementedError, match="custom objective"):
        tx.train({"objective": "reg:squarederror", "gh_precision": "int8"},
                 tx.RayDMatrix(x, y), 1, obj=obj, device="cpu",
                 ray_params=tx.RayParams(num_actors=1))


def test_dequantize_gh_sums_and_itemsize():
    s = torch.tensor([0.5, 0.25])
    out = O.dequantize_gh_sums(torch.tensor([[3, -4]], dtype=torch.int32), s)
    assert out.dtype == torch.float32 and out.tolist() == [[1.5, -1.0]]
    assert [O.gh_plane_itemsize(m) for m in O.GH_PRECISION_MODES] == [4, 2, 1]

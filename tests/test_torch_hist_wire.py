"""The quantized histogram wire (``hist_quant``, B11's plain versions) against
the JAX package's ``quantized_hist_allreduce`` on the CPU.

Every mode at one rank, and at 2 and 3 ranks (one module-scoped gloo world
of each size against the reference's 8-device CPU mesh at the same
``n_actors``): bitwise on every rank, the wire's bytes equal the
reference's counter. The XLA arithmetic the plain versions follow is
pinned here too: ``amax / qmax`` folds to ``amax * f32(1 / qmax)``, a
value's ``x / scale`` is a true division, and a ring hop's dequantize and
add is one fused multiply-add.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from xgboost_ray_tpu.compat import shard_map_compat as shard_map
from xgboost_ray_tpu.ops.histogram import AllreduceBytes as JaxBytes
from xgboost_ray_tpu.ops.histogram import (
    quantized_hist_allreduce as jax_allreduce,
)
from xgboost_ray_tpu_torch import distributed as D
from xgboost_ray_tpu_torch.ops import histogram as H

MODES = ("int8", "int16", "int8_block", "int16_block")


@pytest.fixture(scope="module")
def worlds():
    with D.World(2, "cpu") as w2, D.World(3, "cpu") as w3:
        yield {2: w2, 3: w3}


def _ref(local, mode, block=512, min_bytes=0):
    """The reference on an ``n``-device mesh: (every device's merged
    histogram, the bytes its counter recorded)."""
    n = local.shape[0]
    mesh = Mesh(np.array(jax.devices()[:n]), ("actors",))
    counter = JaxBytes(n)

    def f(h):
        return jax_allreduce(h[0], "actors", mode, n, counter,
                             min_bytes=min_bytes, block=block)[None]

    out = jax.jit(shard_map(f, mesh=mesh, in_specs=P("actors"),
                            out_specs=P("actors")))(jnp.asarray(local))
    return np.asarray(out), counter.total


def _local(n, shape, seed=0):
    """Per-rank histograms with per-(node, feature) magnitudes over four
    orders and exact zeros (empty buckets)."""
    rng = np.random.RandomState(seed)
    mags = 10.0 ** rng.uniform(-2, 2, size=(n,) + shape[:2] + (1, 1))
    h = rng.randn(n, *shape) * mags
    h[rng.rand(n, *shape) < 0.2] = 0.0
    return h.astype(np.float32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape,block", [((3, 5, 17, 2), 64),
                                         ((2, 28, 257, 2), 512),
                                         ((1, 3, 9, 2), 4096)])
def test_one_rank_bitwise(mode, shape, block):
    local = _local(1, shape)
    ref, nbytes = _ref(local, mode, block)
    out = H.quantized_hist_allreduce(torch.from_numpy(local[0]), mode,
                                     D.Collectives(), 0, block)
    np.testing.assert_array_equal(out.numpy(), ref[0])
    assert nbytes == 0


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("mode", MODES)
def test_ranks_bitwise_and_bytes(worlds, n, mode):
    """Padded rows (4 x 3 rows over n ranks), a ragged last block (408 / n
    values a chunk at block 64), the same bits on every rank."""
    for shape, block in (((4, 3, 17, 2), 64), ((2, 5, 33, 2), 512)):
        local = _local(n, shape, seed=n)
        ref, nbytes = _ref(local, mode, block)
        out = worlds[n].run(D._hist_wire_rank,
                            torch.from_numpy(local).share_memory_(), mode, 0,
                            block)
        for r, o in enumerate(out):
            np.testing.assert_array_equal(o["merged"].numpy(), ref[r])
            assert o["bytes"] == nbytes


def test_zero_histogram_and_exact_fallback(worlds):
    """An all-zero histogram survives the scale guard on every wire; a
    payload under ``min_bytes`` (and mode "none") is the exact merge."""
    zero = np.zeros((2, 2, 2, 9, 2), np.float32)
    for mode in MODES:
        out = worlds[2].run(D._hist_wire_rank,
                            torch.from_numpy(zero).share_memory_(), mode, 0,
                            64)
        assert all((o["merged"] == 0).all() for o in out)
    local = _local(2, (2, 3, 9, 2), seed=4)
    ref, nbytes = _ref(local, "int8", min_bytes=1 << 20)
    for mode, min_bytes in (("none", 0), ("int8", 1 << 20)):
        out = worlds[2].run(D._hist_wire_rank,
                            torch.from_numpy(local).share_memory_(), mode,
                            min_bytes, 512)
        np.testing.assert_array_equal(out[0]["merged"].numpy(), ref[0])
        assert out[0]["bytes"] == nbytes
    assert H.wire_quantized("int8", 8192, 32768)
    assert not H.wire_quantized("int8", 8191, 32768)
    assert not H.wire_quantized("none", 1 << 20, 0)


def test_higgs_level_bytes_match_the_ring_formulas(worlds):
    """One deep HIGGS level (16 smaller children x 28 x 257 x 2) at 2
    ranks: the block ring's bytes are 2 (n - 1) (chunk + 4 ceil(chunk /
    512)) at int8, below the row mode's and the f32 merge's."""
    local = np.zeros((2, 16, 28, 257, 2), np.float32)
    seen = {}
    for mode in ("none", "int8", "int8_block"):
        out = worlds[2].run(D._hist_wire_rank,
                            torch.from_numpy(local).share_memory_(), mode, 0,
                            512)
        seen[mode] = out[0]["bytes"]
        assert seen[mode] == _ref(local, mode)[1]
    size = 16 * 28 * 257 * 2
    chunk = size // 2
    assert seen["int8_block"] == 2 * (chunk + 4 * -(-chunk // 512))
    assert seen["int8_block"] < seen["int8"] < seen["none"]


def test_pins_of_the_xla_arithmetic():
    """What the reference's jitted wire computes: the scale ``amax *
    f32(1 / qmax)`` (not ``amax / qmax``), the values' true division, and a
    ring hop's ``fma(q, scale, x)`` (the separate product and add differ)."""
    rng = np.random.RandomState(1)
    x = (rng.randn(64, 514) * 7).astype(np.float32)
    q, scale = H.wire_quantize_plain(torch.from_numpy(x), 514, 127,
                                     torch.int8)
    amax = np.abs(x).max(axis=1)
    np.testing.assert_array_equal(
        scale.numpy(), amax * (np.float32(1) / np.float32(127)))
    assert not np.array_equal(scale.numpy(), amax / np.float32(127))
    np.testing.assert_array_equal(
        q.numpy(), np.clip(np.round(x / scale.numpy()[:, None]), -127, 127))
    # a hop: dequantize and add the local chunk, fused
    payload = H.wire_quantize_plain(torch.from_numpy(x.reshape(1, -1)), 64,
                                    127, torch.int8, inband=True)
    local = torch.from_numpy((rng.randn(x.size) * 3).astype(np.float32))
    acc = H.wire_accumulate_plain(payload.view(-1), local, 64).numpy()
    qv, sv = H._unpack(payload, x.size, 64)
    qf = qv.numpy().astype(np.float32).reshape(-1, 64)
    sf = sv.numpy()[:, None]
    fused = (qf.astype(np.float64) * sf + local.numpy().reshape(-1, 64)
             ).astype(np.float32).reshape(-1)
    separate = ((qf * sf).astype(np.float32)
                + local.numpy().reshape(-1, 64)).reshape(-1)
    np.testing.assert_array_equal(acc, fused)
    assert not np.array_equal(acc, separate)
    # ... and the reference's ring takes the fused form: 2 ranks bitwise
    # with it (``test_ranks_bitwise_and_bytes``)


def test_allreduce_bytes_terms():
    c = H.AllreduceBytes(8)
    c.add_ppermute(torch.zeros(100, dtype=torch.int8))
    assert c.total == 100
    c.add_ppermute(torch.zeros(100, dtype=torch.int8), hops=7)
    assert c.total == 800
    with c.repeated(3):
        c.add_all_to_all(torch.zeros(80, dtype=torch.int16))
    assert c.total == 800 + 3 * int(7 * 160 / 8)
    c.add_allgather(torch.zeros(16, dtype=torch.float32))
    assert c.total == 800 + 420 + 56
    assert H.AllreduceBytes(1).total == 0

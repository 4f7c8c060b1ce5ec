"""Learning-to-rank gradients of the port against the JAX package on the
CPU: ``build_group_rows``, B13's plain version (``rank_grad_hess_plain``)
for ``rank:pairwise`` / ``rank:ndcg`` / ``rank:map``, and the group
layouts of each shard at ``num_actors`` 2 under INTERLEAVED and BATCH.

Tolerances: ``build_group_rows`` bitwise; the gradients bitwise against
``jax.jit(make_rank_grad_hess(name))`` where the padded width G is above
32 (XLA's CPU reduce then takes the window-32 tree the port follows; round
0's tied scores too). For G <= 32 LLVM vectorises XLA's fused pair sums
with reassociation, an order the port does not follow: there each row is
held within the f32 summation bound of its terms, 2 G eps32 times the sum
of the |terms| it adds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xgboost_ray_tpu as jx
import xgboost_ray_tpu_torch as tx
from xgboost_ray_tpu.ops import ranking as jr
from xgboost_ray_tpu_torch.engine import TorchEngine
from xgboost_ray_tpu_torch.ops import ranking as tr
from xgboost_ray_tpu_torch.ops.objectives import sigmoid
from xgboost_ray_tpu_torch.params import parse_params

EPS32 = float(np.finfo(np.float32).eps)


def _same(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.array_equal(a.view(np.int32), b.view(np.int32))


def _groups(sizes, seed, ties=False):
    rng = np.random.default_rng(seed)
    qid = np.repeat(np.arange(len(sizes)), sizes)
    n = qid.size
    m = (np.full(n, 0.25, np.float32) if ties
         else rng.standard_normal(n).astype(np.float32))
    y = rng.integers(0, 5, n).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    w[::13] = 0.0
    return qid, m, y, w


def _jax_gh(name, qid, m, y, w):
    rows, _ = jr.build_group_rows(qid)
    g, h = jax.jit(jr.make_rank_grad_hess(name))(
        jnp.asarray(m[:, None]), jnp.asarray(y), jnp.asarray(w),
        jnp.asarray(rows))
    return np.asarray(g)[:, 0], np.asarray(h)[:, 0]


def _port_gh(name, qid, m, y, w):
    lay = tr.GroupLayout(torch.from_numpy(tr.shard_group_offsets([qid])),
                         int(np.bincount(qid).max()))
    gh = tr.rank_grad_hess(*(torch.from_numpy(a) for a in (m, y, w)), lay,
                           name)
    return gh[:, 0].numpy(), gh[:, 1].numpy()


@pytest.mark.parametrize("qid", [
    np.zeros(5, np.int64),
    np.array([0, 0, 1, 1, 1, 2, 5, 5, 9]),
    np.repeat(np.arange(40), np.arange(1, 41)),
    np.array([3]),
])
def test_build_group_rows_bitwise(qid):
    for max_group in (0, 50):
        rows, ptr = tr.build_group_rows(qid, max_group)
        jrows, jptr = jr.build_group_rows(qid, max_group)
        assert rows.dtype == jrows.dtype and np.array_equal(rows, jrows)
        assert ptr.dtype == jptr.dtype and np.array_equal(ptr, jptr)
    lay = tr.GroupLayout(torch.from_numpy(tr.shard_group_offsets([qid])),
                         rows.shape[1])
    padded = lay.padded_rows(qid.size).numpy()
    assert np.array_equal(padded, np.where(rows == qid.size, qid.size, rows))


SIZES = [1, 2, 70, 33, 5, 40, 1, 64, 17, 3]


@pytest.mark.parametrize("name", tr.RANKING_OBJECTIVES)
@pytest.mark.parametrize("ties", [False, True])
def test_grad_hess_bitwise_above_32(name, ties):
    """Groups of 1 to 70 documents (G = 70); ``ties``: round 0, every
    margin equal, the ranks from position alone."""
    qid, m, y, w = _groups(SIZES, 3, ties)
    g, h = _jax_gh(name, qid, m, y, w)
    tg, th = _port_gh(name, qid, m, y, w)
    assert _same(tg, g) and _same(th, h)


def _abs_terms(name, qid, m, y):
    """Per row the sum of |terms| its two pair sums add (win + lose of the
    lambdas and of the hessians), from the plain version's pieces."""
    lay = tr.GroupLayout(torch.from_numpy(tr.shard_group_offsets([qid])),
                         int(np.bincount(qid).max()))
    n = qid.size
    r = lay.padded_rows(n)
    v = r < n
    s = torch.cat([torch.from_numpy(m), torch.zeros(1)])[r]
    yy = torch.where(v, torch.cat([torch.from_numpy(y), torch.zeros(1)])[r],
                     0.0)
    beats = (yy[:, :, None] > yy[:, None, :]) & v[:, :, None] & v[:, None, :]
    rho = sigmoid(-(s[:, :, None] - s[:, None, :])).double()
    lam = torch.where(beats, rho, 0.0)
    hs = torch.where(beats, rho * (1 - rho) + 1e-16, 0.0)
    out = torch.zeros(n + 1, dtype=torch.float64)
    tot = lam.sum(2) + lam.sum(1) + hs.sum(2) + hs.sum(1)
    out.index_put_((r.reshape(-1),), tot.reshape(-1), accumulate=True)
    return out[:n].numpy(), lay.width


@pytest.mark.parametrize("name", tr.RANKING_OBJECTIVES)
def test_grad_hess_within_the_sum_bound_at_32_and_below(name):
    """G = 24: XLA's vectorised, reassociated pair sums; each row within
    2 G eps32 times its terms' sum (|delta NDCG| <= 1 bounds the weighted
    terms by the unweighted ones)."""
    qid, m, y, w = _groups([1, 2, 24, 9, 17, 5], 4)
    g, h = _jax_gh(name, qid, m, y, w)
    tg, th = _port_gh(name, qid, m, y, w)
    terms, width = _abs_terms(name, qid, m, y)
    bound = 2 * width * EPS32 * terms * w + 1e-30
    assert (np.abs(tg - g) <= bound).all()
    assert (np.abs(th - h) <= bound + 1e-16 * w).all()


@pytest.mark.parametrize("sharding", ["INTERLEAVED", "BATCH"])
def test_group_layouts_per_shard(sharding):
    """At ``num_actors=2`` each shard's queries are its own groups (a query
    split between the shards is two groups, as the JAX package builds them
    per device block), padded to the largest group of any shard; the
    loader stable-sorts the rows by qid first."""
    rng = np.random.default_rng(8)
    sizes = [7, 40, 3, 25, 12]
    qid = np.repeat(np.arange(len(sizes)), sizes)
    perm = rng.permutation(qid.size)  # the loader sorts them back
    x = rng.standard_normal((qid.size, 4)).astype(np.float32)
    y = rng.integers(0, 3, qid.size).astype(np.float32)
    mode = getattr(tx.RayShardingMode, sharding)
    dm = tx.RayDMatrix(x[perm], y[perm], qid=qid[perm], sharding=mode)
    dm.load_data(2)
    shards = dm.shards()
    jdm = jx.RayDMatrix(x[perm], y[perm], qid=qid[perm],
                        sharding=getattr(jx.RayShardingMode, sharding))
    jdm.load_data(2)
    for rank, sh in enumerate(shards):
        jsh = jdm.get_data(rank)
        assert np.array_equal(sh["qid"], jsh["qid"])
        assert np.array_equal(sh["data"], jsh["data"])
        assert np.array_equal(sh["label"], jsh["label"])
    eng = TorchEngine(shards, parse_params({"objective": "rank:ndcg",
                                            "max_depth": 2}), device="cpu")
    want, base = [0], 0
    for sh in shards:
        ptr = jr.build_group_rows(sh["qid"])[1]
        want += list(ptr[1:] + base)
        base += sh["qid"].size
    assert eng.groups.offsets.tolist() == want
    assert eng.groups.width == max(int(np.diff(jr.build_group_rows(
        sh["qid"])[1]).max()) for sh in shards)
    if sharding == "BATCH":
        assert eng.groups.n_groups == len(sizes) + 1  # one query straddles


def test_ranking_requires_qid_and_refuses_weights():
    x = np.zeros((6, 2), np.float32)
    with pytest.raises(ValueError, match="requires qid"):
        tx.train({"objective": "rank:ndcg"}, tx.RayDMatrix(x, np.zeros(6)),
                 1, ray_params=tx.RayParams(num_actors=1), device="cpu")
    with pytest.raises(NotImplementedError, match="per-group weight"):
        tx.RayDMatrix(x, np.zeros(6), qid=np.zeros(6), weight=np.ones(6))
    with pytest.raises(ValueError, match="group"):
        tx.RayDMatrix(x, np.zeros(6), group=[3, 3])


def test_qid_from_file_columns(tmp_path):
    """``qid`` named as a file column: central loading gives the model of
    the same rows as arrays (both stable-sorted by qid); distributed loading
    gives each rank its files' rows sorted by qid on their own."""
    import pandas as pd

    rng = np.random.default_rng(11)
    sizes = [9, 40, 5, 33, 21, 12]
    qid = np.repeat(np.arange(len(sizes)), sizes)
    x = rng.standard_normal((qid.size, 3)).astype(np.float32)
    y = rng.integers(0, 4, qid.size).astype(np.float32)
    cut = int(np.searchsorted(qid, 3))  # file 0: queries 0-2, file 1: 3-5
    paths, frames = [], []
    for i, sl in enumerate((slice(0, cut), slice(cut, None))):
        df = pd.DataFrame(x[sl], columns=["a", "b", "c"])
        df["rel"], df["q"] = y[sl], qid[sl]
        frames.append(df.iloc[::-1])  # rows out of qid order
        paths.append(str(tmp_path / f"part{i}.csv"))
        frames[-1].to_csv(paths[-1], index=False, float_format="%.9g")
    whole = pd.concat(frames)
    params = {"objective": "rank:ndcg", "max_depth": 2, "max_bin": 16}
    dumps = []
    for dm in (tx.RayDMatrix(whole[["a", "b", "c"]].to_numpy(np.float32),
                             whole["rel"].to_numpy(np.float32),
                             qid=whole["q"].to_numpy()),
               tx.RayDMatrix(paths, label="rel", qid="q",
                             distributed=False)):
        bst = tx.train(params, dm, 2, ray_params=tx.RayParams(num_actors=2),
                       device="cpu")
        dumps.append(bst.get_dump())
    assert dumps[0] == dumps[1]
    dm = tx.RayDMatrix(paths, label="rel", qid="q", distributed=True,
                       sharding=tx.RayShardingMode.BATCH)
    dm.load_data(2)
    for rank, sh in enumerate(dm.shards()):
        want = frames[rank].sort_values("q", kind="stable")
        assert np.array_equal(sh["qid"], want["q"].to_numpy())
        assert np.array_equal(sh["label"], want["rel"].to_numpy(np.float32))
    tx.train(params, dm, 2, ray_params=tx.RayParams(num_actors=2),
             device="cpu")
    with pytest.raises(ValueError, match="column names"):
        tx.RayDMatrix(paths, label="rel", qid=qid, distributed=True)


@pytest.mark.parametrize("sizes", [[1, 2, 70, 5], [3, 0, 4], [40] * 6])
def test_bound_operations_count_what_the_labels_need(sizes):
    """B13's and B9r's operation counts (their bounds) against a loop over
    every pair and group: a lambda for each unordered pair of one group
    with different labels, sorts of g ceil(log2 g) comparisons, and the
    metric's first min(k, g) positions."""
    rng = np.random.default_rng(len(sizes))
    y = rng.integers(0, 5, sum(sizes)).astype(np.float32)
    y[:3] = 2.0
    off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    lay = tr.GroupLayout(torch.from_numpy(off), max(sizes))
    pairs = comparisons = 0
    for a, b in zip(off[:-1], off[1:]):
        g = y[a:b]
        pairs += sum(int(g[i] != g[j]) for i in range(g.size)
                     for j in range(i + 1, g.size))
        comparisons += g.size * int(np.ceil(np.log2(max(g.size, 1))))
    docs = int(off[-1])
    label = torch.from_numpy(y)
    assert tr.pair_operations(lay, label, False) == 22 * pairs + 2 * docs
    assert tr.pair_operations(lay, label) == (
        30 * pairs + 32 * docs + 2 * comparisons)
    for k in (None, 1, 10):
        cut = sum(min(s, max(sizes) if k is None else k) for s in sizes)
        assert tr.rank_metric_operations(lay, "ndcg", k) == (
            2 * comparisons + 34 * cut)
        assert tr.rank_metric_operations(lay, "map", k) == (
            comparisons + 5 * cut)

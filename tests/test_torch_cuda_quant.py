"""Quantized gradients and the quantized histogram wire on a CUDA device:
B10 (``xrt_quantize_gh``), K1's integer instantiation, the form-and-
dequantise step, B11's three wire kernels and K2's totals input, each
against its plain version, and ``train()`` against the CPU path. Every test
skips without a CUDA device (the kernels have no CPU mode); run them on the
card with ``python -m pytest tests/test_torch_cuda_quant.py -q
--noconftest``.

Tolerances: every kernel output is bitwise its plain version's. A model
trained with quantized gradients equals the port's CPU path bit for bit
(integer sums, the same f32 arithmetic after them), with no fixed-point
patch; with f32 gradients on the wire it equals the CPU path summing K1's
histograms in the card's fixed point.
"""

import numpy as np
import pytest
import torch

from xgboost_ray_tpu_torch import distributed as D
from xgboost_ray_tpu_torch.ops import histogram as th
from xgboost_ray_tpu_torch.ops import objectives as to
from xgboost_ray_tpu_torch.ops import split as ts


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def _bits(t):
    t = t.detach().cpu()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b):
    return torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("mode", ["int8", "int16"])
@pytest.mark.parametrize("n,max_rows", [(1, None), (1000, None),
                                        (1_000_003, 10_500_000)])
def test_b10_bitwise(cuda, mode, n, max_rows):
    rng = np.random.default_rng(n)
    gh = torch.from_numpy((rng.standard_normal((n, 2)) * [2.0, 0.3])
                          .astype(np.float32))
    gh[::7] = 0.0
    amax = gh.abs().amax(dim=0) * 1.5  # the world's: larger than this block's
    for key in ((0, 1), (12345, 0xFFFFFFFF)):
        qc, sc = to.quantize_gh(gh.to(cuda), mode, key, amax.to(cuda),
                                max_rows)
        qp, sp = to.quantize_gh(gh, mode, key, amax, max_rows)
        assert torch.equal(qc.cpu(), qp) and _same(sc, sp)
        assert (qc[::7] == 0).all()


def _int_level(n, f, n_nodes, seed, dtype=torch.int8, bin_dtype=np.int16):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, 257, (n, f)).astype(bin_dtype)
    if bin_dtype == np.uint8:
        bins = rng.integers(0, 256, (n, f)).astype(bin_dtype)
    gh = torch.from_numpy(rng.integers(-100, 101, (n, 2))).to(dtype)
    pos = rng.integers(0, n_nodes, n)
    order = np.argsort(pos, kind="stable").astype(np.int32)
    seg = np.concatenate([[0], np.cumsum(np.bincount(
        pos, minlength=n_nodes))]).astype(np.int32)
    return (torch.from_numpy(bins), gh, torch.from_numpy(order),
            torch.from_numpy(seg))


@pytest.mark.parametrize("f", [28, 54])
@pytest.mark.parametrize("n_nodes", [1, 32])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16])
def test_k1_int_exact(cuda, f, n_nodes, dtype):
    bins, gh, order, seg = _int_level(60_000, f, n_nodes, f + n_nodes, dtype)
    nbt = 257
    hc, tc = th.build_histogram(bins.to(cuda), gh.to(cuda), order.to(cuda),
                                seg.to(cuda), n_nodes, nbt)
    hp, tp = th.build_histogram_plain(bins, gh, order, seg, n_nodes, nbt)
    assert hc.dtype == torch.int32 and torch.equal(hc.cpu(), hp)
    assert torch.equal(tc.cpu(), tp)
    _, tc2 = th.build_histogram(bins.to(cuda), gh.to(cuda), order.to(cuda),
                                seg.to(cuda), n_nodes, nbt, with_hist=False)
    assert torch.equal(tc2.cpu(), tp)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.float32])
def test_k1_middle_nodes(cuda, dtype):
    """``seg[0]`` past 0 (the lossguide grower's two children on the
    quantized wire): K1's integer instantiation (its CTAs split the nodes'
    rows only; the int8 gh at an odd address, no alignment asked) and the
    fixed-point K1 (its CTAs before ``seg[0]`` idle) equal their plain
    versions."""
    bins, gh, order, seg = _int_level(90_000, 28, 4, 9,
                                      torch.int8 if dtype == torch.float32
                                      else dtype)
    mid = seg[1:4].contiguous()
    if dtype == torch.float32:
        gh = gh.to(torch.float32) * 0.37
        qs = th.quant_scales(gh, gh.shape[0])
        hc, tc = th.build_histogram(bins.to(cuda), gh.to(cuda),
                                    order.to(cuda), mid.to(cuda), 2, 257,
                                    qscale=qs.to(cuda))
        hp, tp = th.build_histogram_fixed_plain(bins, gh, order, mid, 2, 257,
                                                qs)
    else:
        g = gh.to(cuda)
        if dtype == torch.int8:  # the same values one byte off
            buf = torch.empty(2 * gh.shape[0] + 1, dtype=dtype, device=cuda)
            g = buf[1:].view(gh.shape)
            g.copy_(gh.to(cuda))
        hc, tc = th.build_histogram(bins.to(cuda), g, order.to(cuda),
                                    mid.to(cuda), 2, 257)
        hp, tp = th.build_histogram_plain(bins, gh, order, mid, 2, 257)
    assert int(mid[0]) > 0
    assert torch.equal(hc.cpu(), hp) and torch.equal(tc.cpu(), tp)


def test_k1_int_uint8_bins_and_root_cap(cuda):
    """uint8 bins; a root whose every row sits at +qmax sums near 2^31."""
    bins, gh, order, seg = _int_level(70_000, 7, 1, 3, torch.int16, np.uint8)
    gh[:, 1] = 30_000
    hc, tc = th.build_histogram(bins.to(cuda), gh.to(cuda), order.to(cuda),
                                seg.to(cuda), 1, 257)
    hp, tp = th.build_histogram_plain(bins, gh, order, seg, 1, 257)
    assert torch.equal(hc.cpu(), hp) and torch.equal(tc.cpu(), tp)
    assert int(tp[0, 1]) == 70_000 * 30_000


@pytest.mark.parametrize("kind", ["int_int", "root_int", "f32_f32",
                                  "f32_int", "root_int_to_f32"])
def test_form_dequantize_bitwise(cuda, kind):
    rng = np.random.default_rng(7)
    shape = (16, 28, 257, 2)
    ints = lambda: torch.from_numpy(rng.integers(-2 ** 20, 2 ** 20, shape)
                                    .astype(np.int32))
    flts = lambda: torch.from_numpy((rng.standard_normal(shape) * 1e5)
                                    .astype(np.float32))
    sir = torch.from_numpy(rng.random(16) < 0.5)
    scale = torch.tensor([3.1e-4, 7.7e-6])
    small, prev, dtype, totals = {
        "int_int": (ints(), ints(), torch.int32, True),
        "root_int": (ints(), None, torch.int32, True),
        "f32_f32": (flts(), flts(), torch.float32, False),
        "f32_int": (flts(), ints(), torch.float32, False),
        "root_int_to_f32": (ints(), None, torch.float32, True),
    }[kind]
    c = th.form_dequantize(small.to(cuda), None if prev is None
                           else prev.to(cuda), sir.to(cuda), scale.to(cuda),
                           dtype, totals)
    p = th.form_dequantize(small, prev, sir, scale, dtype, totals)
    for a, b in zip(c, p):
        assert (a is None) == (b is None)
        if a is not None:
            assert _same(a, b)


def _higgs_level(seed=0):
    """A level-5 HIGGS-shaped local histogram: 16 smaller children x 28 x
    257 x 2, sums of a few hundred f32 gradients a bucket, empty buckets."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((16, 28, 257, 2)) * np.array([40.0, 9.0])
    h[rng.random(h.shape) < 0.1] = 0.0
    return torch.from_numpy(h.astype(np.float32))


@pytest.mark.parametrize("mode", ["int8", "int16"])
def test_b11_row_kernels_bitwise(cuda, mode):
    h = _higgs_level(1)
    qmax, qdt = th._QMAX[mode], th._QDTYPE[mode]
    hr = h.reshape(16 * 28, 514)
    cols = 514
    a_c = th.wire_quantize(hr.to(cuda), cols, qmax, qdt, absmax_only=True)
    a_p = th.wire_quantize_plain(hr, cols, qmax, qdt, absmax_only=True)
    assert _same(a_c, a_p)
    q_c, s_c = th.wire_quantize(hr.to(cuda), cols, qmax, qdt, amax=a_c * 1.5)
    q_p, s_p = th.wire_quantize_plain(hr, cols, qmax, qdt, amax=a_p * 1.5)
    assert torch.equal(q_c.cpu(), q_p) and _same(s_c, s_p)
    pay_c = th.wire_quantize(hr.to(cuda), cols, qmax, qdt, inband=True)
    pay_p = th.wire_quantize_plain(hr, cols, qmax, qdt, inband=True)
    assert torch.equal(pay_c.cpu(), pay_p)
    recv = torch.stack([q_p, q_p.flip(0), -q_p])
    acc_c = th.wire_accumulate(recv.to(cuda), s_p.to(cuda))
    assert _same(acc_c, th.wire_accumulate_plain(recv, s_p))
    assert _same(th.wire_dequantize(pay_c, cols, cols),
                 th.wire_dequantize_plain(pay_p, cols, cols))
    assert _same(th.wire_dequantize(q_c, cols, cols, s_c),
                 th.wire_dequantize_plain(q_p, cols, cols, s_p))


@pytest.mark.parametrize("mode", ["int8", "int16"])
@pytest.mark.parametrize("block", [64, 512, 4096])
def test_b11_block_kernels_bitwise(cuda, mode, block):
    h = _higgs_level(2).reshape(1, -1)
    n = h.shape[1] // 2 + 5  # a chunk whose last block is ragged
    x = h[:, :n].contiguous()
    qmax, qdt = th._QMAX[mode], th._QDTYPE[mode]
    pay_c = th.wire_quantize(x.to(cuda), block, qmax, qdt, inband=True)
    pay_p = th.wire_quantize_plain(x, block, qmax, qdt, inband=True)
    assert torch.equal(pay_c.cpu(), pay_p)
    local = h[0, -n:].contiguous()
    acc_c = th.wire_accumulate(pay_c.view(-1), local.to(cuda), block)
    assert _same(acc_c, th.wire_accumulate_plain(pay_p.view(-1), local,
                                                 block))
    assert _same(th.wire_dequantize(pay_c, n, block),
                 th.wire_dequantize_plain(pay_p, n, block))


@pytest.mark.parametrize("mode", ["int8", "int16", "int8_block",
                                  "int16_block"])
def test_one_rank_wire_on_card(cuda, mode):
    h = _higgs_level(3)
    out_c = th.quantized_hist_allreduce(h.to(cuda), mode, D.Collectives(), 0,
                                        512)
    out_p = th.quantized_hist_allreduce(h, mode, D.Collectives(), 0, 512)
    assert _same(out_c, out_p)


def test_k2_totals_input(cuda):
    """K2's level step and records-free search with given node totals
    (the exact totals of a quantized level): bitwise the plain version."""
    from xgboost_ray_tpu_torch.ops import grow as tg

    rng = np.random.default_rng(4)
    hist = torch.from_numpy(np.abs(rng.standard_normal((8, 28, 257, 2)))
                            .astype(np.float32))
    totals = hist[:, 0].sum(dim=1) * 1.01
    cuts = torch.from_numpy(np.sort(rng.standard_normal((28, 255)), 1)
                            .astype(np.float32))
    active = torch.ones(8, dtype=torch.bool)
    outs = []
    for dev in ("cpu", cuda):
        tree = tg.empty_tree(31, dev)
        rec = ts.TreeRecords(tree, cuts.to(dev), None, ts.SplitParams())
        step = ts.split_level(hist.to(dev), None, None, active.to(dev), rec,
                              True, totals=totals.to(dev))
        out = torch.empty_like(hist).to(dev)
        sp = ts.split_nodes(hist[:2].to(dev), None, None, rec, out[:2],
                            totals=totals[:2].to(dev))
        outs.append((step, tree, sp))
    (s0, t0, p0), (s1, t1, p1) = outs
    assert _same(s0.node_value, s1.node_value)
    assert all(_same(a, b) for a, b in zip(s0.splits, s1.splits))
    assert all(_same(a, b) for a, b in zip(t0, t1))
    assert all(_same(a, b) for a, b in zip(p0, p1))
    assert _same(s1.splits.node_gh, totals)


def _train_data(n=20_000, f=12, seed=9):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    x[rng.random(x.shape) < 0.03] = np.nan
    z = np.nan_to_num(x)
    y = (z[:, 0] + 0.5 * z[:, 1] - 0.3 * z[:, 2] * z[:, 3]
         + rng.standard_normal(n) > 0).astype(np.float32)
    return x, y


RUNS = {
    "gh_int8": {"gh_precision": "int8"},
    "gh_int16": {"gh_precision": "int16"},
    "gh_int8_wire_int8_block": {"gh_precision": "int8",
                                "hist_quant": "int8_block"},
    "gh_int8_wire_int16": {"gh_precision": "int8", "hist_quant": "int16"},
    "gh_int8_subsample": {"gh_precision": "int8", "subsample": 0.5},
    "gh_int8_softprob": {"gh_precision": "int8",
                         "objective": "multi:softprob", "num_class": 3},
    "gh_int8_lossguide": {"gh_precision": "int8", "grow_policy": "lossguide",
                          "max_leaves": 16},
    "gh_int8_wire_int8_lossguide": {"gh_precision": "int8",
                                    "hist_quant": "int8",
                                    "grow_policy": "lossguide",
                                    "max_leaves": 16},
}


@pytest.mark.parametrize("name", list(RUNS))
def test_quantized_gradients_train_like_the_cpu(cuda, name):
    """Quantized gradients: the card's model is the port's CPU path's bit
    for bit, no fixed-point patch (integer sums; the same f32 arithmetic
    after them); the counters show B10 and K1's integer instantiation."""
    import xgboost_ray_tpu_torch as tx
    from xgboost_ray_tpu_torch import engine as E

    x, y = _train_data()
    params = {"objective": "binary:logistic", "max_depth": 5, "seed": 3,
              "hist_quant_min_bytes": 0, "eval_metric": ["logloss"],
              **RUNS[name]}
    if params["objective"] == "multi:softprob":
        y = (np.nan_to_num(x[:, 0]) > 0).astype(np.float32) + (
            np.nan_to_num(x[:, 1]) > 0.5)
        params["eval_metric"] = ["mlogloss"]
    runs = []
    for dev in ("cuda", "cpu"):
        dm = tx.RayDMatrix(x, y)
        ev = {}
        E.reset_kernel_launches()
        bst = tx.train(params, dm, 3, evals=[(dm, "train")], evals_result=ev,
                       ray_params=tx.RayParams(num_actors=2), device=dev)
        runs.append((bst, ev, E.kernel_launches()))
    (bc, evc, lc), (bp, evp, _) = runs
    assert bc.get_dump(with_stats=True) == bp.get_dump(with_stats=True)
    mc = bc.predict(x, output_margin=True, device="cpu")
    mp = bp.predict(x, output_margin=True, device="cpu")
    assert np.array_equal(mc.view(np.int32), mp.view(np.int32))
    assert lc["B10"] > 0 and lc["K1"] == 0
    assert (lc["K1int"] > 0) == ("sampling_method" not in params)


def test_f32_gradients_on_the_wire_train_like_fixed_point(cuda, monkeypatch):
    """f32 gradients on the int8 wire: the card's model is the CPU path's
    summing K1's histograms in the card's fixed point."""
    import xgboost_ray_tpu_torch as tx
    from xgboost_ray_tpu_torch import engine as E
    from xgboost_ray_tpu_torch.ops import grow as tg
    from xgboost_ray_tpu_torch.ops import grow_lossguide as lg

    x, y = _train_data(seed=11)
    for extra in ({"hist_quant": "int8"},
                  {"hist_quant": "int16_block", "hist_quant_block": 64},
                  {"hist_quant": "int8", "grow_policy": "lossguide",
                   "max_leaves": 16}):
        params = {"objective": "binary:logistic", "max_depth": 5, "seed": 3,
                  "hist_quant_min_bytes": 0, **extra}

        def run(dev):
            return tx.train(params, tx.RayDMatrix(x, y), 3, device=dev,
                            ray_params=tx.RayParams(num_actors=1))

        E.reset_kernel_launches()
        bc = run("cuda")
        launches = E.kernel_launches()
        assert launches["B11q"] > 0 and launches["B11deq"] > 0
        with monkeypatch.context() as m:
            def fixed(bins, gh, rows, seg, n_nodes, nbt, with_hist=True,
                      qscale=None):
                return th.build_histogram_fixed_plain(
                    bins, gh, rows, seg, n_nodes, nbt, qscale, with_hist)

            for mod in (tg, lg):
                m.setattr(mod, "build_histogram", fixed)
                m.setattr(mod, "dequantize", th.dequantize_plain)
            m.setattr(E.TorchEngine, "_scales", lambda e: th.quant_scales(
                e.gh, e.n_global, e.coll.max))
            bp = run("cpu")
        assert bc.get_dump(with_stats=True) == bp.get_dump(with_stats=True)

#!/usr/bin/env python3
"""Drive xgboost_ray_tpu_torch on one NVIDIA GPU and check it end to end.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device, ``nvcc`` and ``triton``, and nothing of JAX. Phases:

1. build: compile the CUDA kernels of ``xgboost_ray_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel) and the Triton kernel; report each K1
   and K3 kernel's registers, shared memory and spills (``-Xptxas -v``)
   and the atomic opcodes ``cuobjdump -sass`` finds in them (whether K1's
   shared float add is native or a compare-and-swap loop);
2. every kernel against its plain PyTorch version on the card, at the main
   path's shapes (HIGGS width F = 28, int16 bins, 257 buckets, a level-5
   fan-out of 32 nodes; K1 also at the root: one node, identity order;
   K3's leaf-value mode at the final level's 64 nodes), with
   integer-valued gradients (exact f32 sums: K1 and K2 must be bitwise)
   and random ones (stated tolerances); each kernel is timed with CUDA
   events beside its plain version and, where one PyTorch call computes
   the same function, that call (K1: ``index_add_``; K3: a stable
   ``torch.sort`` of the child key, which covers only the partition core);
3. the main path: ``train()`` on a HIGGS-shaped synthetic set (11,000,000 x
   28 rows, depth 6, 256 bins, 10 rounds) with ``num_actors=1`` and ``2``,
   with the launch counters set to 0 before and read after each run, then
   two more rounds under ``torch.profiler`` (device time by kernel, idle
   share against the unprofiled round);
4. the card against the port's CPU path on a 200,000-row slice (3 rounds);
5. ``save_model`` -> ``load_model`` on the card, ``save_raw`` bytes equal.

It prints one JSON line per phase result, the ``{"kernels": [...]}`` line,
the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line. ``--rows`` and ``--rounds`` shrink phase 3 for a quick run;
results also go to ``chiprun_out/chip_smoke.json``.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, H100 SXM
OUT_DIR = "chiprun_out"


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def emit(obj):
    print(json.dumps(obj), flush=True)


def make_higgs_like(n_rows, n_features, seed=0):
    """The HIGGS-shaped synthetic recipe of the repo's benchmark."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal(size=(n_rows, n_features)).astype(np.float32)
    logits = 0.8 * x[:, 0] - 0.6 * x[:, 1] + 0.4 * x[:, 2] * x[:, 3] + 0.3 * x[:, 4]
    y = (logits + rng.standard_normal(n_rows).astype(np.float32) > 0).astype(np.float32)
    return x, y


def cuda_ms(fn, iters=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, nflops):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = nflops / H100_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 1: what nvcc made of K1 and K3
# ---------------------------------------------------------------------------

_TYPE_CODES = {"s": "int16", "h": "uint8"}


def kernel_name(mangled):
    """``_Z15xrt_hist_kernelIsEv...`` -> ``xrt_hist_kernel<int16>``."""
    m = re.match(r"_Z(\d+)", mangled)
    if not m:
        return mangled
    start = m.end()
    name = mangled[start:start + int(m.group(1))]
    t = re.match(r"I([a-z])(?:Lb([01])E)?E", mangled[start + int(m.group(1)):])
    if t:
        args = [_TYPE_CODES.get(t.group(1), t.group(1))]
        if t.group(2) is not None:
            args.append("true" if t.group(2) == "1" else "false")
        name += f"<{', '.join(args)}>"
    return name


def ptxas_report(log):
    """{kernel: registers, shared bytes, spills} from ``-Xptxas -v``."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(_Z\w+)", line)
        if m:
            name = kernel_name(m.group(1))
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def cuobjdump_path():
    import shutil

    found = shutil.which("cuobjdump")
    if found:
        return found
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "cuobjdump")]
    try:
        import triton

        cands.append(os.path.join(os.path.dirname(triton.__file__),
                                  "backends", "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    return next((c for c in cands if os.path.exists(c)), None)


def sass_atomics(lib_path):
    """{kernel: {atomic opcode: count}} from ``cuobjdump -sass``."""
    exe = cuobjdump_path()
    if exe is None:
        return {"error": "cuobjdump not found"}
    out = subprocess.run([exe, "-sass", lib_path], capture_output=True,
                         text=True, timeout=120)
    if out.returncode != 0:
        return {"error": out.stderr.strip()[:300]}
    funcs, cur = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = kernel_name(m.group(1))
            funcs[cur] = {}
            continue
        m = re.search(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)(?:\.[A-Za-z0-9_]+)*)"
                      r"\s", line)
        if m and cur is not None:
            funcs[cur][m.group(1)] = funcs[cur].get(m.group(1), 0) + 1
    return funcs


def phase_build_report():
    """Registers, shared memory and spills of K1's and K3's kernels, and
    whether K1's shared float adds compile to a native add or a
    compare-and-swap loop."""
    from xgboost_ray_tpu_torch.ops import _build

    paths = _build.build_all()
    report = {}
    for stem in ("histogram", "partition"):
        report[stem] = {"ptxas": ptxas_report(_build.build_log(stem)),
                        "sass_atomics": sass_atomics(paths[stem])}
    shared = {op: c for fn, ops in report["histogram"]["sass_atomics"].items()
              if fn.startswith("xrt_hist_kernel") and isinstance(ops, dict)
              for op, c in ops.items() if op.startswith("ATOMS")}
    if not shared:
        finding = "no ATOMS opcode found in xrt_hist_kernel"
    elif any("CAS" in op for op in shared):
        finding = "shared float add compiles to a compare-and-swap loop"
    else:
        finding = "shared float add compiles to a native ATOMS add"
    report["k1_shared_atomic_finding"] = finding
    report["k1_shared_atomic_opcodes"] = shared
    emit({"phase": "build_report", **report})
    return report


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def level_inputs(n, f, n_nodes, seed, integer_gh):
    """A level-5-like state: bins, gh, node-sorted rows and segments."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    bins = torch.randint(0, 256, (n, f), generator=g, device=dev,
                         dtype=torch.int16)
    miss = torch.rand((n, f), generator=g, device=dev) < 0.05
    bins[miss] = 256
    if integer_gh:
        gh = torch.stack([
            torch.randint(-2, 3, (n,), generator=g, device=dev),
            torch.randint(1, 4, (n,), generator=g, device=dev)], 1).float()
    else:
        gh = torch.stack([torch.randn(n, generator=g, device=dev),
                          torch.rand(n, generator=g, device=dev) * 0.25], 1)
    node = torch.randint(0, n_nodes, (n,), generator=g, device=dev)
    order = torch.sort(node, stable=True).indices.to(torch.int32)
    counts = torch.bincount(node, minlength=n_nodes)
    seg = torch.cat([torch.zeros(1, device=dev, dtype=torch.long),
                     torch.cumsum(counts, 0)]).to(torch.int32)
    return bins.contiguous(), gh.contiguous(), order, seg


def phase_kernels(n, records):
    import torch

    from xgboost_ray_tpu_torch.ops import histogram as H
    from xgboost_ray_tpu_torch.ops import objectives as O
    from xgboost_ray_tpu_torch.ops import split as S

    f, nbt, n_nodes = 28, 257, 32
    p = S.SplitParams()
    res = {}
    for integer_gh in (True, False):
        tag = "int" if integer_gh else "rand"
        bins, gh, order, seg = level_inputs(n, f, n_nodes, 7 if integer_gh else 8,
                                            integer_gh)
        # K1
        hk, tk = H.build_histogram(bins, gh, order, seg, n_nodes, nbt)
        hp, tp = H.build_histogram_plain(bins, gh, order, seg, n_nodes, nbt)
        torch.cuda.synchronize()
        err1 = float((hk - hp).abs().max())
        if integer_gh:
            check(torch.equal(hk, hp) and torch.equal(tk, tp),
                  f"K1 not bitwise with integer gh (max err {err1})")
        else:
            habs, _ = H.build_histogram_plain(bins, gh.abs(), order, seg,
                                              n_nodes, nbt)
            ok = ((hk - hp).abs() <= 1e-4 * habs + 1e-6).all()
            check(bool(ok), f"K1 beyond 1e-4 x sum|gh| (max err {err1})")
        # K1 at the root: one node, identity order (the heaviest launch of
        # the main path). Integer gh here keeps |sum| < 2**24 over all rows
        # (g in -1..1, h in 0..1), so totals are exact too.
        ident = torch.arange(n, dtype=torch.int32, device="cuda")
        seg1 = torch.tensor([0, n], dtype=torch.int32, device="cuda")
        gh1 = (torch.stack([torch.remainder(gh[:, 0], 3) - 1,
                            torch.remainder(gh[:, 1], 2)], 1).contiguous()
               if integer_gh else gh)
        hk1, tk1 = H.build_histogram(bins, gh1, ident, seg1, 1, nbt)
        hp1, tp1 = H.build_histogram_plain(bins, gh1, ident, seg1, 1, nbt)
        torch.cuda.synchronize()
        err1r = float((hk1 - hp1).abs().max())
        if integer_gh:
            check(torch.equal(hk1, hp1) and torch.equal(tk1, tp1),
                  f"K1 (root) not bitwise with integer gh (max err {err1r})")
        else:
            habs1, tabs1 = H.build_histogram_plain(bins, gh1.abs(), ident,
                                                   seg1, 1, nbt)
            ok = (((hk1 - hp1).abs() <= 1e-4 * habs1 + 1e-6).all()
                  and ((tk1 - tp1).abs() <= 1e-4 * tabs1 + 1e-6).all())
            check(bool(ok), f"K1 (root) beyond 1e-4 x sum|gh| (max err {err1r})")
        del hk1, hp1
        # K2 on one histogram (the plain one) through both
        sk = S.find_splits(hp, p)
        sp = S.find_splits_plain(hp, p)
        torch.cuda.synchronize()
        same = all(torch.equal(getattr(sk, k), getattr(sp, k))
                   for k in ("feature", "split_bin", "default_left", "valid"))
        err2 = float(torch.nan_to_num((sk.gain - sp.gain).abs(), 0.0).max())
        err2 = max(err2, float((sk.node_gh - sp.node_gh).abs().max()))
        if integer_gh:
            check(same and err2 == 0.0,
                  f"K2 not bitwise with integer gh (gain err {err2})")
        else:
            check(same, "K2 split choice differs from the plain version")
            check(err2 <= 1e-4 * float(sp.gain.abs().max()) + 1e-6,
                  f"K2 gain beyond tolerance ({err2})")
        # K3 with a mix of splitting, new-leaf and inactive nodes
        gen = torch.Generator(device="cuda").manual_seed(11)
        feature = torch.randint(0, f, (n_nodes,), generator=gen,
                                device="cuda", dtype=torch.int32)
        sbin = torch.randint(0, 255, (n_nodes,), generator=gen, device="cuda",
                             dtype=torch.int32)
        dl = torch.rand(n_nodes, generator=gen, device="cuda") < 0.5
        state = torch.full((n_nodes,), H.SPLIT, dtype=torch.uint8, device="cuda")
        state[::7] = H.LEAF
        state[3::11] = H.INACTIVE
        nval = torch.randn(n_nodes, generator=gen, device="cuda")
        rvk = torch.zeros(n, device="cuda")
        rvp = torch.zeros(n, device="cuda")
        pk = H.partition_level(order, seg, bins, feature, sbin, dl, state,
                               nval, rvk, True, 256)
        pp = H.partition_level_plain(order, seg, bins, feature, sbin, dl,
                                     state, nval, rvp, True, 256)
        torch.cuda.synchronize()
        m = int(pp.small_seg[-1])
        check(torch.equal(pk.order, pp.order) and torch.equal(pk.seg, pp.seg)
              and torch.equal(pk.small_seg, pp.small_seg)
              and torch.equal(pk.small_is_right, pp.small_is_right)
              and torch.equal(pk.small_rows[:m], pp.small_rows[:m])
              and torch.equal(rvk, rvp), "K3 differs from the plain version")
        # K3 leaf-value mode at the final level of a depth-6 tree: 64 nodes,
        # every row moves nowhere, rows of LEAF nodes take the node's value
        node64 = torch.randint(0, 64, (n,), generator=gen, device="cuda")
        order64 = torch.sort(node64, stable=True).indices.to(torch.int32)
        seg64 = torch.cat([torch.zeros(1, dtype=torch.int32, device="cuda"),
                           torch.cumsum(torch.bincount(node64, minlength=64),
                                        0).to(torch.int32)])
        del node64
        state64 = torch.full((64,), H.LEAF, dtype=torch.uint8, device="cuda")
        state64[5::9] = H.INACTIVE
        nval64 = torch.randn(64, generator=gen, device="cuda")
        rvk.zero_()
        rvp.zero_()
        H.partition_leaf_values(order64, seg64, state64, nval64, rvk)
        H.partition_leaf_values_plain(order64, seg64, state64, nval64, rvp)
        torch.cuda.synchronize()
        check(torch.equal(rvk, rvp), "K3 leaf mode differs from the plain version")
        # K4
        gen = torch.Generator(device="cuda").manual_seed(13)
        margin = torch.randn(n, generator=gen, device="cuda") * 2
        rv = torch.randn(n, generator=gen, device="cuda") * 0.1
        label = (torch.rand(n, generator=gen, device="cuda") > 0.5).float()
        weight = torch.ones(n, device="cuda")
        mk, mp = margin.clone(), margin.clone()
        ghk, sk4 = O.round_update(mk, rv, label, weight, True)
        ghp, sp4 = O.round_update_plain(mp, rv, label, weight, True)
        torch.cuda.synchronize()
        err4 = float((ghk - ghp).abs().max())
        check(torch.equal(mk, mp), "K4 margin update differs")
        check(err4 <= 1e-6, f"K4 gradients beyond 1e-6 ({err4})")
        rel = float(((sk4 - sp4).abs() / sp4.abs().clamp(min=1e-12)).max())
        check(rel <= 1e-5, f"K4 metric sums beyond 1e-5 relative ({rel})")
        res[tag] = {"K1": err1, "K1root": err1r, "K2": err2, "K3": 0.0,
                    "K3leaf": 0.0, "K4": err4}
        emit({"phase": "kernel_vs_plain", "gh": tag, "max_abs_err": res[tag]})

        if integer_gh:
            continue
        # timings on the random-gh inputs (main-path shapes)
        t = {}
        t["K1"] = (cuda_ms(lambda: H.build_histogram(bins, gh, order, seg,
                                                     n_nodes, nbt)),
                   cuda_ms(lambda: H.build_histogram_plain(
                       bins, gh, order, seg, n_nodes, nbt), iters=3))
        flat = H.flat_bucket_ids(bins, order, seg, n_nodes, nbt)
        src = gh[order.long()][:, None, :].expand(n, f, 2).reshape(-1, 2)
        out = torch.zeros((n_nodes * f * nbt, 2), device="cuda")
        lib_k1 = cuda_ms(lambda: out.index_add_(0, flat, src), iters=3)
        del flat, src
        t["K1root"] = (cuda_ms(lambda: H.build_histogram(bins, gh, ident, seg1,
                                                         1, nbt)),
                       cuda_ms(lambda: H.build_histogram_plain(
                           bins, gh, ident, seg1, 1, nbt), iters=3))
        flat = H.flat_bucket_ids(bins, ident, seg1, 1, nbt)
        src = gh[:, None, :].expand(n, f, 2).reshape(-1, 2)
        out1 = torch.zeros((f * nbt, 2), device="cuda")
        lib_k1root = cuda_ms(lambda: out1.index_add_(0, flat, src), iters=3)
        del flat, src
        t["K2"] = (cuda_ms(lambda: S.find_splits(hp, p)),
                   cuda_ms(lambda: S.find_splits_plain(hp, p), iters=3))
        t["K3"] = (cuda_ms(lambda: H.partition_level(
                       order, seg, bins, feature, sbin, dl, state, nval, rvk,
                       True, 256)),
                   cuda_ms(lambda: H.partition_level_plain(
                       order, seg, bins, feature, sbin, dl, state, nval, rvp,
                       True, 256), iters=3))
        t["K3leaf"] = (cuda_ms(lambda: H.partition_leaf_values(
                           order64, seg64, state64, nval64, rvk)),
                       cuda_ms(lambda: H.partition_leaf_values_plain(
                           order64, seg64, state64, nval64, rvp), iters=3))
        # yardstick for K3's partition core only (no routing, no
        # compaction): a stable sort of the precomputed child key
        # 2 * node + go_right
        node_of_pos = H._node_of_slot(seg, n_nodes)
        pb = bins[order.long(), feature.long()[node_of_pos]].long()
        from xgboost_ray_tpu_torch.ops.grow import route_right_binned
        go = route_right_binned(pb, sbin[node_of_pos], dl[node_of_pos], 256)
        go &= state[node_of_pos] == H.SPLIT
        key = (2 * node_of_pos + go.long()).to(torch.int32)
        del node_of_pos, pb, go
        lib_k3 = cuda_ms(lambda: torch.sort(key, stable=True), iters=10)
        del key
        # K3 where every row is routed but rows are read in id order (the
        # root, one splitting node): how much of K3 the gather's locality is
        root_nodes = [torch.tensor([v], dtype=dt, device="cuda") for v, dt in
                      ((0, torch.int32), (127, torch.int32), (True, torch.bool),
                       (H.SPLIT, torch.uint8), (0.0, torch.float32))]
        k3_root_ms = cuda_ms(lambda: H.partition_level(
            ident, seg1, bins, *root_nodes, rvk, True, 256))
        emit({"phase": "kernel_context", "k3_root_ms": k3_root_ms,
              "k3_level5_ms": t["K3"][0]})
        t["K4"] = (cuda_ms(lambda: O.round_update(mk, rv, label, weight, True)),
                   cuda_ms(lambda: O.round_update_plain(mp, rv, label, weight,
                                                       True), iters=3))
        n_leaf_rows = int(sum(int(seg[k + 1] - seg[k])
                              for k in range(n_nodes) if int(state[k]) == H.LEAF))
        n_leaf64 = int(sum(int(seg64[k + 1] - seg64[k])
                           for k in range(64) if int(state64[k]) == H.LEAF))
        hist_bytes = n_nodes * f * nbt * 2 * 4
        bounds = {
            # bins + rows + gh read once, histogram and totals written once
            "K1": bound_ms(n * f * 2 + n * 4 + n * 8 + hist_bytes, 2 * n * f),
            "K1root": bound_ms(n * f * 2 + n * 4 + n * 8 + f * nbt * 2 * 4,
                               2 * n * f),
            # histogram read once; prefix adds + ~30 flops per candidate
            "K2": bound_ms(hist_bytes, n_nodes * f * (2 * nbt + 30 * (nbt - 2))),
            # order + one bin per row read, order + compacted list +
            # leaf values written
            "K3": bound_ms(n * 4 + n * 2 + n * 4 + m * 4 + n_leaf_rows * 4, n),
            # order read and row_value written for the rows of leaf nodes
            "K3leaf": bound_ms(n_leaf64 * 8, n_leaf64),
            # margin, row_value, label, weight read; margin, gh written
            "K4": bound_ms(n * 4 * 4 + n * 4 + n * 8, 60 * n),
        }
        library = {"K1": lib_k1, "K1root": lib_k1root, "K3": lib_k3}
        for k in t:
            records[k].update(
                ms=t[k][0], plain_ms=t[k][1], bound_ms=bounds[k][0],
                bound_by=bounds[k][1], library_ms=library.get(k))
    for k in records:
        records[k]["max_abs_err"] = max(res["int"][k], res["rand"][k])
    return res


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def counters():
    from xgboost_ray_tpu_torch.ops import histogram as H
    from xgboost_ray_tpu_torch.ops import objectives as O
    from xgboost_ray_tpu_torch.ops import split as S

    return {"K1": H.build_histogram, "K2": S.find_splits,
            "K3": H.partition_level, "K3leaf": H.partition_leaf_values,
            "K4": O.round_update}


def phase_main(x, y, rounds, depth, actors):
    import torch

    import xgboost_ray_tpu_torch as xrt

    params = {"objective": "binary:logistic",
              "eval_metric": ["logloss", "error"],
              "max_depth": depth, "max_bin": 256}
    dm = xrt.RayDMatrix(x, y)
    evals_result, extra = {}, {}
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst = xrt.train(params, dm, rounds, evals=[(dm, "train")],
                    evals_result=evals_result, additional_results=extra,
                    ray_params=xrt.RayParams(num_actors=actors))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in fns.items()}
    # per tree: K1 at every level + the final totals, K2 and the full K3 at
    # every level, K3's leaf-value mode once (the final leaves)
    expect = {"K1": rounds * (depth + 1), "K2": rounds * depth,
              "K3": rounds * depth, "K3leaf": rounds, "K4": rounds + 1}
    ll = evals_result["train"]["logloss"]
    check(all(np.isfinite(ll)), f"non-finite train logloss {ll}")
    check(all(b < a for a, b in zip(ll, ll[1:])),
          f"train logloss does not fall every round: {ll}")
    for k in expect:
        check(launches[k] > 0, f"{k} never launched on the main path")
        check(launches[k] == expect[k],
              f"{k} launched {launches[k]} times, expected {expect[k]}")
    check(bst.num_boosted_rounds() == rounds, "wrong number of trees")
    rt = [r * 1e3 for r in extra["round_times_s"]]
    emit({"phase": "main_path", "rows": int(x.shape[0]), "features": int(x.shape[1]),
          "max_depth": depth, "max_bin": 256, "rounds": rounds,
          "num_actors": actors, "launches": launches, "expected": expect,
          "train_logloss": ll, "train_error": evals_result["train"]["error"],
          "round_ms": rt, "round_ms_median": float(np.median(rt)),
          "setup_s": extra["setup_time_s"], "sketch_s": extra["sketch_time_s"],
          "train_wall_s": wall})
    return bst, launches, rt


def phase_profile(x, y, depth, round_ms, rounds=2):
    """Device busy time by kernel over ``rounds`` steady rounds of the main
    path (torch.profiler). The idle share is taken against ``round_ms``,
    the median round of the unprofiled run: the profiler slows the host
    side of a round, so its own wall time overstates the idle share (that
    figure is kept as ``device_idle_share_profiled``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import xgboost_ray_tpu_torch as xrt

    seen = {}

    class Keep:
        def after_iteration(self, engine, i, res):
            seen["engine"] = engine

    dm = xrt.RayDMatrix(x, y)
    xrt.train({"objective": "binary:logistic", "max_depth": depth}, dm, 1,
              evals=[(dm, "train")], callbacks=[Keep()],
              ray_params=xrt.RayParams(num_actors=1))
    engine = seen["engine"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(rounds):
            engine.step(1 + i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    kern = {}
    for e in prof.key_averages():
        if e.device_type != cuda:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        kern[e.key] = (kern.get(e.key, (0.0, 0))[0] + t / 1e3,
                       kern.get(e.key, (0.0, 0))[1] + e.count)
    device_ms = sum(v[0] for v in kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:12]
    out = {"phase": "profile", "rows": int(x.shape[0]), "rounds": rounds,
           "round_ms_unprofiled": round_ms,
           "device_ms_per_round": device_ms / rounds,
           "device_idle_share": max(0.0, 1.0 - device_ms / rounds / round_ms),
           "wall_ms_per_round_profiled": wall_ms / rounds,
           "device_idle_share_profiled": max(0.0, 1.0 - device_ms / wall_ms),
           "top_kernels_ms_per_round": [
               [k[:80], v[0] / rounds, v[1] / rounds] for k, v in top]}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 4: card against the CPU path
# ---------------------------------------------------------------------------


def phase_cpu_vs_card(x, y, rounds=3):
    import xgboost_ray_tpu_torch as xrt

    params = {"objective": "binary:logistic", "eval_metric": ["logloss"]}
    out = {}
    for device in ("cuda", "cpu"):
        seen = {}

        class Keep:
            def after_iteration(self, engine, i, res):
                seen["engine"] = engine

        dm = xrt.RayDMatrix(x, y)
        ev = {}
        bst = xrt.train(params, dm, rounds, evals=[(dm, "train")],
                        evals_result=ev, device=device, callbacks=[Keep()],
                        ray_params=xrt.RayParams(num_actors=1))
        out[device] = (bst, ev["train"]["logloss"],
                       seen["engine"].get_margins()[:, 0])
    (bg, llg, mg), (bc, llc, mc) = out["cuda"], out["cpu"]
    fields = ("feature", "split_bin", "default_left", "is_leaf")
    diff = [k for k in fields
            if not np.array_equal(getattr(bg.forest, k)[0], getattr(bc.forest, k)[0])]
    if diff:
        nodes = np.nonzero(bg.forest.feature[0] != bc.forest.feature[0])[0]
        emit({"phase": "cpu_vs_card", "first_tree_differs": diff,
              "nodes": nodes.tolist(),
              "gain_card": bg.forest.gain[0][nodes].tolist(),
              "gain_cpu": bc.forest.gain[0][nodes].tolist()})
    dll = float(np.max(np.abs(np.array(llg) - np.array(llc))))
    dm_ = float(np.max(np.abs(mg - mc)))
    emit({"phase": "cpu_vs_card", "rows": int(x.shape[0]), "rounds": rounds,
          "first_tree_equal": not diff, "logloss_max_abs_diff": dll,
          "margin_max_abs_diff": dm_, "logloss_card": llg, "logloss_cpu": llc})
    check(not diff, f"first tree differs between card and CPU in {diff}")
    check(dll <= 1e-5, f"per-round logloss differs by {dll} > 1e-5")
    check(dm_ <= 1e-3, f"final margins differ by {dm_} > 1e-3")
    return {"logloss": dll, "margin": dm_}


def phase_save_load(bst):
    import xgboost_ray_tpu_torch as xrt

    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "chip_smoke_model.json")
    bst.save_model(path)
    back = xrt.RayXGBoostBooster.load_model(path)
    os.remove(path)
    same = back.save_raw() == bst.save_raw()
    emit({"phase": "save_load", "save_raw_equal": same})
    check(same, "save_raw bytes differ after save_model/load_model")


KERNELS = {
    "K1": dict(name="K1 histogram build + node totals (level 5: 32 nodes)",
               route="cuda", source="xgboost_ray_tpu_torch/csrc/histogram.cu",
               replaces="46abde5^:xgboost_ray_tpu/ops/hist_pallas.py:105"),
    "K1root": dict(name="K1 histogram build + node totals (root: 1 node, "
                   "identity order)", route="cuda",
                   source="xgboost_ray_tpu_torch/csrc/histogram.cu",
                   replaces="46abde5^:xgboost_ray_tpu/ops/hist_pallas.py:105"),
    "K2": dict(name="K2 node totals + split search", route="cuda",
               source="xgboost_ray_tpu_torch/csrc/split.cu",
               replaces="xgboost_ray_tpu/ops/split.py:79"),
    "K3": dict(name="K3 routing + stable partition + small-child compaction",
               route="cuda", source="xgboost_ray_tpu_torch/csrc/partition.cu",
               replaces="xgboost_ray_tpu/ops/histogram.py:558"),
    "K3leaf": dict(name="K3 leaf-value mode (final level: 64 nodes)",
                   route="cuda",
                   source="xgboost_ray_tpu_torch/csrc/partition.cu",
                   replaces="xgboost_ray_tpu/ops/grow.py:782"),
    "K4": dict(name="K4 margin update + metric partials + gradients",
               route="triton", source="xgboost_ray_tpu_torch/ops/objectives.py",
               replaces="xgboost_ray_tpu/ops/objectives.py:88"),
}


def run(args):
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    try:
        import xgboost_ray_tpu_torch  # noqa: F401
        from xgboost_ray_tpu_torch.ops import _build
        from xgboost_ray_tpu_torch.ops import objectives as O
    except ImportError as exc:
        raise SmokeFailure(f"cannot import xgboost_ray_tpu_torch: {exc}")
    bad = [m for m in sys.modules
           if m == "jax" or m.startswith("jax.") or m == "xgboost_ray_tpu"
           or m.startswith("xgboost_ray_tpu.")]
    check(not bad, f"JAX modules imported: {bad[:5]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_and_power()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": card})

    # phase 1: build
    t0 = time.perf_counter()
    _build.build_all()
    cuda_build_s = time.perf_counter() - t0
    for stem in _build.SIGNATURES:
        _build.library(stem)
    t1 = time.perf_counter()
    z = torch.zeros(4, device="cuda")
    O.round_update(z, z.clone(), z.clone(), torch.ones(4, device="cuda"), True)
    torch.cuda.synchronize()
    emit({"phase": "build", "nvcc_seconds": cuda_build_s,
          "triton_first_launch_seconds": time.perf_counter() - t1})
    build_report = phase_build_report()

    records = {k: dict(v) for k, v in KERNELS.items()}
    phase_kernels(args.rows, records)

    x, y = make_higgs_like(args.rows, 28, seed=0)
    if args.rows < 11_000_000:
        emit({"phase": "main_path_cut", "rows": args.rows,
              "reason": "--rows below the 11,000,000-row HIGGS protocol"})
    results = {}
    bst = None
    for actors in (1, 2):
        b, launches, rt = phase_main(x, y, args.rounds, 6, actors)
        results[actors] = {"launches": launches, "round_ms": rt}
        if actors == 1:
            bst = b
            for k in records:
                # the root row is K1 at another shape: the same launches
                records[k]["launches"] = launches[k.replace("root", "")]
    results["profile"] = phase_profile(x, y, 6,
                                       float(np.median(results[1]["round_ms"])))
    cmp_rows = min(args.compare_rows, args.rows)
    cmp = phase_cpu_vs_card(x[:cmp_rows], y[:cmp_rows])
    phase_save_load(bst)

    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: records[key][k] for k in order} for key in sorted(records)]
    emit({"kernels": kernels})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "build_report": build_report,
                   "kernels": kernels, "main_path": results,
                   "cpu_vs_card": cmp, "rows": args.rows,
                   "rounds": args.rounds}, f, indent=1)
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=11_000_000)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--compare-rows", type=int, default=200_000)
    args = ap.parse_args()
    try:
        run(args)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()

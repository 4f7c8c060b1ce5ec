#!/usr/bin/env python3
"""Drive xgboost_ray_tpu_torch on one NVIDIA GPU and check it end to end.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device, ``nvcc`` and ``triton``, and nothing of JAX. Phases:

1. build: compile the CUDA kernels of ``xgboost_ray_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel) and the Triton kernel; report each K1,
   K3 and B8 kernel's registers, shared memory and spills (``-Xptxas -v``)
   and the atomic opcodes ``cuobjdump -sass`` finds in them (whether K1's
   shared adds are native or a compare-and-swap loop), and the dynamic
   shared memory per CTA of B8's kernels on the main path;
2. every kernel against its plain PyTorch version on the card, at the main
   path's shapes (HIGGS width F = 28, int16 bins, 257 buckets, a level-5
   fan-out of 32 nodes; K1 also at the root: one node, identity order;
   K2's level step at level 5 with the sibling prologue (16 parents, 32
   nodes) and its final-level records and K3's leaf-value mode at the
   final level's 64 nodes), with integer-valued gradients (exact sums: K1's
   dequantised output equals the f32 sums and K2 must be bitwise) and
   random ones (stated tolerances; K2's level step and records are bitwise
   on both); K1's int64 sums and its dequantise step are bitwise against
   ``build_histogram_fixed_plain`` / ``dequantize_plain`` on both; K3
   also with the smaller children chosen from counts merged with a second
   rank's (what it does above one rank), compacted into N slots; each
   kernel is timed with
   CUDA events around its wrapper (``ms``: the host's issue time shows
   where it is the slower) and by ``torch.profiler`` (``device_ms``: the
   kernels' own device time per launch), beside its plain version and,
   where one PyTorch call computes the same function, that call (K1: an
   int64 ``index_add_``; the dequantise step: int64 times f32; K3: a
   stable ``torch.sort`` of the child key, which covers only the partition
   core);
3. the main path: ``train()`` on a HIGGS-shaped synthetic set (11,000,000 x
   28 rows, depth 6, 256 bins, 10 rounds) with ``num_actors=1`` twice and
   ``2`` once (folded onto the card), with the launch counters set to 0
   before and read after each run; determinism (ROADMAP C1): the three
   runs' dumps equal and their final margins bitwise; ranks (A6): two
   ranks sharing the card in one gloo world (``distributed.launch_world``)
   train the same config on their shards and must give the 1-rank dump
   and margins bitwise, each rank's kernel launches counted from 0 just
   before its ``train()`` and checked exactly (world size, backend,
   all-reduce bytes per round and round times printed; the NCCL path, a
   rank per card, and ``train()`` alone spawning its NCCL ranks run only
   with two or more cards and are reported as not run otherwise); then
   two more rounds under ``torch.profiler`` (device time by kernel, CUDA
   launches per round, idle share against the unprofiled round);
4. the card against the port's CPU path on a 200,000-row slice (3 rounds);
5. ``save_model`` -> ``load_model`` on the card, ``save_raw`` bytes equal;
6. predict and serve (the main paths of the predict slice): ``train()``
   for 500 rounds on the same set (``num_actors=1``), keeping the engine's
   final margins; then four paths, each with B8's launch counters set to 0
   just before it and read just after, and each count checked exactly:
   ``predict(bst, RayDMatrix(x), RayParams(num_actors=2))`` over every row,
   margins and values (one launch per device chunk and call, the values'
   through the kernel's fused sigmoid; no row's margin may differ from
   training's by more than 1e-3, the values must be bitwise the sigmoid of
   the margins on the CPU and their logloss equal the last
   ``train-logloss`` within 1e-5);
   ``predict(..., pred_leaf=True)`` over two leaf chunks (one launch per
   chunk; the first rows equal to the plain walk on the CPU); and
   ``serve.create_server`` with that model in the heap and the node-array
   layout (``max_batch`` 256, ``max_delay_ms`` 2.0; 16 clients sending
   1-32 row requests, 1.5 s of warmup and 6 s measured for the heap,
   0.5 s and 2 s for the node array: the clients are parked at both ends
   of the window, so the window's launches equal its batches, each a value
   launch of B8's windows mapping in the server's layout; probe responses
   bitwise equal to ``booster.predict`` and to the plain walk on the CPU,
   no kernel build after warmup, no client error); then whether
   ``torch.profiler`` sees B8's full-size launch this late in the process
   (recorded only);
7. B8 against its plain version (bitwise, in both layouts, every mode:
   margins, values, leaf indices, and each mapping, forced by the SM count
   the launch plan reads) at 262,144 rows x 500 trees and at every serve
   bucket (8-256 rows), one row and a size for each rows-per-CTA choice
   of the windows mapping; then timed at the
   main path's shapes: the margins over every row, the leaf indices over
   the booster's chunk, and the margins of a serve batch of 8, 32 and 256
   rows (``device_ms`` from ``torch.profiler``, as for the other
   kernels).

Phase 6's model is trained, and phase 7 run, right after phase 1: later in
the process ``torch.profiler`` records no device activity for B8's
full-size launches (not in a fresh process, nor after any one of phases
2-4 alone), so phase 7 runs first. Phase 6's paths run last.

It prints one JSON line per phase result, the ``{"kernels": [...]}`` line,
the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line. ``--rows`` and ``--rounds`` shrink phase 3 for a quick run;
results also go to ``chiprun_out/chip_smoke.json``.

``--predict-rounds`` shrinks phase 6's model for a quick run.
``--b8-only`` stops after phase 7 (build, phase 6's model, B8's checks
and timings) and prints no result line; it works on another tree of the
package too (copy this script into it; there it checks the modes and
mappings that tree has), to compare two versions of B8 in one call.

``--profile-only`` runs the build and phase 3's profile alone and prints
no result line; it also works against an older tree of the package (copy
this script into that tree), to count that tree's CUDA launches per round.

``--k1-time`` runs the build and then times K1 alone (``torch.profiler``
device time at level 5 and at the root of the 11M x 28 set, and whether
it is bitwise its fixed-point plain version there) and a 10-round
``train()`` (median round, md5 of the dump); it prints one JSON line and
no result line, and works in an older tree too (one from before K1's
fixed point is timed with its f32 K1), so two trees are compared in turns
in one call.

``--ranks-only`` runs the build, the 1-rank main path and the ranks phase
(on a host of two or more cards also the NCCL path, against the 1-rank
run) and prints no result line.
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
#: the card's name and power limit, stamped on every result line once known
CARD = None


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def emit(obj):
    if CARD is not None and "ok" not in obj:
        obj = {**obj, "card": CARD}
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


def device_ms(fn, iters=10):
    """Device time per call of ``fn`` of the kernels it launches, from
    ``torch.profiler``: the port's own kernels, not the wrapper's
    allocations and fills (PyTorch's ``at::`` kernels, copies, memsets)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    seen = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        t = e.self_cuda_time_total if t is None else t
        seen.append((e.key[:60], str(e.device_type), t))
        if (e.device_type != torch.autograd.DeviceType.CUDA or "at::" in e.key
                or e.key.startswith(("Memcpy", "Memset"))):
            continue
        total += t / 1e3
    check(total > 0, f"torch.profiler saw no device time of the kernels; "
                     f"events: {sorted(seen, key=lambda v: -v[2])[:8]}")
    return total / iters


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
    """``_Z15xrt_hist_kernelIsLb1EEv...`` -> ``xrt_hist_kernel<int16, true>``,
    ``_Z18xrt_predict_kernelILi0ELi1EEv...`` -> ``xrt_predict_kernel<0, 1>``."""
    m = re.match(r"_Z(\d+)", mangled)
    if not m:
        return mangled
    start = m.end()
    name = mangled[start:start + int(m.group(1))]
    rest = mangled[start + int(m.group(1)):]
    if not rest.startswith("I"):
        return name
    args, i = [], 1
    while i < len(rest) and rest[i] != "E":
        if rest[i] == "L":  # a literal: L<type code><value>E
            j = rest.index("E", i)
            code, value = rest[i + 1], rest[i + 2:j]
            args.append(("true" if value == "1" else "false") if code == "b"
                        else value)
            i = j + 1
        else:
            args.append(_TYPE_CODES.get(rest[i], rest[i]))
            i += 1
    return f"{name}<{', '.join(args)}>"


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


def b8_main_path_kernels(n_trees, n_rows):
    """{B8 kernel: (what it runs, dynamic shared memory per CTA)} at the
    main path's shapes (depth 6, F = 28): the rows mapping of predict()'s
    margins and leaf chunks, the windows mapping of the serve buckets."""
    import torch

    from xgboost_ray_tpu_torch.ops import predict as PR

    fo = PR.PredictForest(None, n_trees, 6, "heap", 28, False)
    out = {}
    for what, n, leaf in (("predict() margins and values", n_rows, False),
                          ("predict(pred_leaf=True) chunks", 1_000_000, True),
                          ("serve batches of 8-256 rows", 32, False)):
        plan = PR.launch_plan(n, 1, fo, leaf, torch.device("cuda"))
        name = (f"xrt_rows_kernel<{int(leaf)}, {str(plan.staged).lower()}, "
                f"false>" if plan.mapping == "rows"
                else f"xrt_windows_kernel<{int(leaf)}, false>")
        out[name] = (what, plan.shared_bytes)
    return out


def phase_build_report(n_trees, n_rows):
    """Registers, shared memory and spills of K1's, K3's and B8's kernels
    (B8's main-path kernels with their dynamic shared memory per CTA), and
    whether K1's shared adds compile to native adds or a compare-and-swap
    loop."""
    from xgboost_ray_tpu_torch.ops import _build
    from xgboost_ray_tpu_torch.ops import predict as PR

    paths = _build.build_all()
    report = {}
    for stem in ("histogram", "partition", "predict"):
        report[stem] = {"ptxas": ptxas_report(_build.build_log(stem)),
                        "sass_atomics": sass_atomics(paths[stem])}
    if hasattr(PR, "launch_plan"):  # this tree's B8 (not an older one)
        ptxas = report["predict"]["ptxas"]
        report["b8_main_path"] = {
            name: {"runs": what, "dynamic_smem_bytes": smem,
                   **ptxas.get(name, {"error": "not in the ptxas log"})}
            for name, (what, smem) in b8_main_path_kernels(
                n_trees, n_rows).items()}
    shared = {op: c for fn, ops in report["histogram"]["sass_atomics"].items()
              if fn.startswith("xrt_hist_kernel") and isinstance(ops, dict)
              for op, c in ops.items() if op.startswith("ATOMS")}
    if not shared:
        finding = "no ATOMS opcode found in xrt_hist_kernel"
    elif any("CAS" in op for op in shared):
        finding = "a shared add compiles to a compare-and-swap loop"
    else:
        finding = "every shared add compiles to a native ATOMS add"
    report["k1_shared_atomic_finding"] = finding
    report["k1_shared_atomic_opcodes"] = shared
    emit({"phase": "build_report", **report})
    return report


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def bits(t):
    """A tensor to compare bit for bit (float32 as its int32 pattern)."""
    import torch

    return t.view(torch.int32) if t.dtype == torch.float32 else t


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


def hold_k1(bins, gh, rows, seg, n_nodes, nbt, qs, integer_gh, what):
    """K1 against ``build_histogram_fixed_plain`` on the card: raw int64
    histogram and totals bitwise, the totals-only launch bitwise, the
    dequantise kernel bitwise against ``dequantize_plain``; then the
    dequantised sums against the f32 plain sums. Returns (max abs error
    against the f32 sums, max abs error of the dequantise kernel: 0)."""
    import torch

    from xgboost_ray_tpu_torch.ops import histogram as H

    hk, tk = H.build_histogram(bins, gh, rows, seg, n_nodes, nbt, qscale=qs)
    hq, tq = H.build_histogram_fixed_plain(bins, gh, rows, seg, n_nodes, nbt,
                                           qs)
    _, tk0 = H.build_histogram(bins, gh, rows, seg, n_nodes, nbt,
                               with_hist=False, qscale=qs)
    torch.cuda.synchronize()
    check(hk.dtype == torch.int64 and torch.equal(hk, hq)
          and torch.equal(tk, tq) and torch.equal(tk0, tq),
          f"K1 ({what}) int64 sums not bitwise equal to the fixed-point "
          f"plain version")
    dk, dtk = H.dequantize(hk, qs), H.dequantize(tk, qs)
    dq, dtq = H.dequantize_plain(hq, qs), H.dequantize_plain(tq, qs)
    torch.cuda.synchronize()
    check(torch.equal(bits(dk), bits(dq)) and torch.equal(bits(dtk), bits(dtq)),
          f"K1 dequantise ({what}) not bitwise equal to its plain version")
    del hk, hq, dq
    hp, tp = H.build_histogram_plain(bins, gh, rows, seg, n_nodes, nbt)
    err = max(float((dk - hp).abs().max()), float((dtk - tp).abs().max()))
    if integer_gh:
        check(torch.equal(dk, hp) and torch.equal(dtk, tp),
              f"K1 ({what}) dequantised sums differ from the exact f32 sums "
              f"with integer gh (max err {err})")
    else:
        habs, tabs = H.build_histogram_plain(bins, gh.abs(), rows, seg,
                                             n_nodes, nbt)
        # the f32 sums' own rounding sets the tolerance: a node total adds
        # up to N / 32 values (the dequantised sums are the closer ones)
        ok = (((dk - hp).abs() <= 1e-4 * habs).all()
              and ((dtk - tp).abs() <= 1e-4 * tabs).all())
        check(bool(ok), f"K1 ({what}) dequantised beyond 1e-4 x sum|gh| of "
                        f"the f32 sums (max err {err})")
    return err, 0.0


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
        # K1: int64 sums bitwise against the fixed-point plain version, the
        # dequantise kernel bitwise against its plain version; the
        # dequantised sums against the f32 plain sums (exact with integer
        # gh, within 1e-4 x sum|gh| with random gh)
        qs = H.quant_scales(gh, n)
        err1, err1d = hold_k1(bins, gh, order, seg, n_nodes, nbt, qs,
                              integer_gh, "level 5")
        hp, tp = H.build_histogram_plain(bins, gh, order, seg, n_nodes, nbt)
        # K1 at the root: one node, identity order (the heaviest launch of
        # the main path). Integer gh here keeps |sum| < 2**24 over all rows
        # (g in -1..1, h in 0..1), so the f32 totals are exact too.
        ident = torch.arange(n, dtype=torch.int32, device="cuda")
        seg1 = torch.tensor([0, n], dtype=torch.int32, device="cuda")
        gh1 = (torch.stack([torch.remainder(gh[:, 0], 3) - 1,
                            torch.remainder(gh[:, 1], 2)], 1).contiguous()
               if integer_gh else gh)
        qs1 = H.quant_scales(gh1, n)
        err1r, _ = hold_k1(bins, gh1, ident, seg1, 1, nbt, qs1, integer_gh,
                           "root")
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
        # K2's level step at level 5: 16 parents (two level-5 histograms
        # each), their smaller children, 32 nodes formed (a few inactive),
        # records written and the formed histogram kept
        g2 = torch.Generator(device="cuda").manual_seed(17)
        level = dict(
            hist=hp[0::2].contiguous(), prev_hist=hp[0::2] + hp[1::2],
            small_is_right=torch.rand(16, generator=g2, device="cuda") < 0.5,
            active=torch.arange(32, device="cuda") % 13 != 5)
        cuts = torch.sort(torch.randn(f, nbt - 2, generator=g2, device="cuda"),
                          dim=1).values
        fhm = torch.arange(f, device="cuda") % 3 != 0
        from xgboost_ray_tpu_torch.ops.grow import empty_tree
        rec_k = S.TreeRecords(empty_tree(127, "cuda"), cuts, fhm, p)
        rec_p = S.TreeRecords(empty_tree(127, "cuda"), cuts, fhm, p)
        lk = S.split_level(**level, rec=rec_k)
        lp = S.split_level_plain(**level, rec=rec_p)
        torch.cuda.synchronize()
        level_out = ([(getattr(lk.splits, k), getattr(lp.splits, k))
                      for k in lk.splits._fields]
                     + [(getattr(lk, k), getattr(lp, k))
                        for k in ("node_value", "state", "active", "hist")]
                     + list(zip(rec_k.tree, rec_p.tree)))
        check(all(torch.equal(bits(a), bits(b)) for a, b in level_out),
              "K2 level step not bitwise equal to its plain version")
        err2l = float((lk.hist - lp.hist).abs().max())
        # K2's final-level records: 64 nodes, a few inactive
        gh64 = torch.stack([torch.randn(64, generator=g2, device="cuda") * 40,
                            torch.rand(64, generator=g2, device="cuda") * 90], 1)
        act64 = torch.arange(64, device="cuda") % 7 != 3
        rec64_k = S.TreeRecords(empty_tree(127, "cuda"), cuts, fhm, p)
        rec64_p = S.TreeRecords(empty_tree(127, "cuda"), cuts, fhm, p)
        leaf_k = S.leaf_records(gh64, act64, rec64_k)
        leaf_p = S.leaf_records_plain(gh64, act64, rec64_p)
        torch.cuda.synchronize()
        check(all(torch.equal(bits(a), bits(b)) for a, b in
                  list(zip(leaf_k, leaf_p)) + list(zip(rec64_k.tree, rec64_p.tree))),
              "K2 leaf records not bitwise equal to their plain version")
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
        # K3 above one rank: the smaller child chosen from the children's
        # counts merged with a second rank's (here each child's count plus
        # twice its sibling's, which turns most choices round), compacted
        # into N slots
        def merge(c):
            return c + 2 * c.view(-1, 2).flip(1).reshape(-1)

        pk = H.partition_level(order, seg, bins, feature, sbin, dl, state,
                               nval, rvk, True, 256, merge_counts=merge)
        pp = H.partition_level_plain(order, seg, bins, feature, sbin, dl,
                                     state, nval, rvp, True, 256,
                                     merge_counts=merge)
        torch.cuda.synchronize()
        mw = int(pp.small_seg[-1])
        check(mw > n // 2 and pk.small_rows.shape == (n,),
              f"K3's merged choice packed {mw} of {n} rows in "
              f"{pk.small_rows.shape[0]} slots")
        check(torch.equal(pk.order, pp.order) and torch.equal(pk.seg, pp.seg)
              and torch.equal(pk.small_seg, pp.small_seg)
              and torch.equal(pk.small_is_right, pp.small_is_right)
              and torch.equal(pk.small_rows[:mw], pp.small_rows[:mw])
              and torch.equal(rvk, rvp),
              "K3 with merged counts differs from the plain version")
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
        res[tag] = {"K1": err1, "K1root": err1r, "K1deq": err1d, "K2": err2,
                    "K2level": err2l, "K2leaf": 0.0, "K3": 0.0,
                    "K3leaf": 0.0, "K4": err4}
        emit({"phase": "kernel_vs_plain", "gh": tag, "max_abs_err": res[tag]})

        if integer_gh:
            continue
        # timings on the random-gh inputs (main-path shapes)
        t = {}
        t["K1"] = (cuda_ms(lambda: H.build_histogram(bins, gh, order, seg,
                                                     n_nodes, nbt, qscale=qs)),
                   cuda_ms(lambda: H.build_histogram_fixed_plain(
                       bins, gh, order, seg, n_nodes, nbt, qs), iters=3))
        # yardstick: one int64 index_add_ of the quantised rows (the
        # quantisation and the bucket ids precomputed)
        flat = H.flat_bucket_ids(bins, order, seg, n_nodes, nbt)
        src = H.quantize_gh(gh[order.long()], qs)[:, None, :].expand(
            n, f, 2).reshape(-1, 2)
        out = torch.zeros((n_nodes * f * nbt, 2), dtype=torch.int64,
                          device="cuda")
        lib_k1 = cuda_ms(lambda: out.index_add_(0, flat, src), iters=3)
        del flat, src, out
        t["K1root"] = (cuda_ms(lambda: H.build_histogram(bins, gh, ident, seg1,
                                                         1, nbt, qscale=qs)),
                       cuda_ms(lambda: H.build_histogram_fixed_plain(
                           bins, gh, ident, seg1, 1, nbt, qs), iters=3))
        flat = H.flat_bucket_ids(bins, ident, seg1, 1, nbt)
        src = H.quantize_gh(gh, qs)[:, None, :].expand(n, f, 2).reshape(-1, 2)
        out1 = torch.zeros((f * nbt, 2), dtype=torch.int64, device="cuda")
        lib_k1root = cuda_ms(lambda: out1.index_add_(0, flat, src), iters=3)
        del flat, src, out1
        # the dequantise step at level 5's shape: the 16 parents' smaller
        # children (the main path's largest); yardstick: int64 * f32 in one
        # PyTorch call (type promotion: float(sum) * 2^-e)
        h16 = H.build_histogram(bins, gh, order, seg, n_nodes, nbt,
                                qscale=qs)[0][:16].contiguous()
        inv = qs[2:]
        t["K1deq"] = (cuda_ms(lambda: H.dequantize(h16, qs), iters=50),
                      cuda_ms(lambda: H.dequantize_plain(h16, qs), iters=10))
        lib_k1deq = cuda_ms(lambda: torch.mul(h16, inv), iters=50)
        t["K2"] = (cuda_ms(lambda: S.find_splits(hp, p)),
                   cuda_ms(lambda: S.find_splits_plain(hp, p), iters=3))
        t["K2level"] = (cuda_ms(lambda: S.split_level(**level, rec=rec_k)),
                        cuda_ms(lambda: S.split_level_plain(**level, rec=rec_p),
                                iters=3))
        t["K2leaf"] = (cuda_ms(lambda: S.leaf_records(gh64, act64, rec64_k)),
                       cuda_ms(lambda: S.leaf_records_plain(gh64, act64,
                                                            rec64_p), iters=3))
        # the level step's host issue time: enqueue only, no synchronise
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            S.split_level(**level, rec=rec_k)
        k2_host_ms = (time.perf_counter() - t0) / 50 * 1e3
        torch.cuda.synchronize()
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
        dev_ms = {
            "K1": device_ms(lambda: H.build_histogram(bins, gh, order, seg,
                                                      n_nodes, nbt, qscale=qs)),
            "K1root": device_ms(lambda: H.build_histogram(bins, gh, ident,
                                                          seg1, 1, nbt,
                                                          qscale=qs)),
            "K1deq": device_ms(lambda: H.dequantize(h16, qs), iters=50),
            "K2": device_ms(lambda: S.find_splits(hp, p)),
            "K2level": device_ms(lambda: S.split_level(**level, rec=rec_k)),
            "K2leaf": device_ms(lambda: S.leaf_records(gh64, act64, rec64_k)),
            "K3": device_ms(lambda: H.partition_level(
                order, seg, bins, feature, sbin, dl, state, nval, rvk, True,
                256)),
            "K3leaf": device_ms(lambda: H.partition_leaf_values(
                order64, seg64, state64, nval64, rvk)),
            "K4": device_ms(lambda: O.round_update(mk, rv, label, weight,
                                                   True)),
        }
        emit({"phase": "kernel_context", "k3_root_ms": k3_root_ms,
              "k3_level5_ms": t["K3"][0],
              "k2_level5_host_issue_ms": k2_host_ms,
              "k2_level5_event_ms": t["K2level"][0],
              "k2_level5_device_ms": dev_ms["K2level"]})
        t["K4"] = (cuda_ms(lambda: O.round_update(mk, rv, label, weight, True)),
                   cuda_ms(lambda: O.round_update_plain(mp, rv, label, weight,
                                                       True), iters=3))
        n_leaf_rows = int(sum(int(seg[k + 1] - seg[k])
                              for k in range(n_nodes) if int(state[k]) == H.LEAF))
        n_leaf64 = int(sum(int(seg64[k + 1] - seg64[k])
                           for k in range(64) if int(state64[k]) == H.LEAF))
        hist_bytes = n_nodes * f * nbt * 2 * 4
        cells16 = 16 * f * nbt * 2
        bounds = {
            # bins + rows + gh read once, the int64 histogram and totals
            # written once; an add per (row, feature) and plane, a multiply
            # and a conversion per row and plane
            "K1": bound_ms(n * f * 2 + n * 4 + n * 8 + 2 * hist_bytes
                           + n_nodes * 16, 2 * n * f + 4 * n),
            "K1root": bound_ms(n * f * 2 + n * 4 + n * 8 + f * nbt * 2 * 8
                               + 16, 2 * n * f + 4 * n),
            # int64 sums read, f32 written; a conversion and a multiply each
            "K1deq": bound_ms(cells16 * (8 + 4), 2 * cells16),
            # histogram read once; prefix adds + ~30 flops per candidate
            "K2": bound_ms(hist_bytes, n_nodes * f * (2 * nbt + 30 * (nbt - 2))),
            # 16 parents' and 16 children's histograms read, 32 formed ones
            # written, a cut read and ~38 bytes of records and outputs per
            # node; the subtraction, prefix adds and candidates as for K2
            "K2level": bound_ms(2 * hist_bytes + 16 + 32 + 32 * (4 + 38),
                                n_nodes * f * (3 * nbt + 30 * (nbt - 2))),
            # totals and active read; value, state, 4 records written
            "K2leaf": bound_ms(64 * (8 + 1 + 4 + 1 + 13), 64 * 12),
            # order + one bin per row read, order + compacted list +
            # leaf values written
            "K3": bound_ms(n * 4 + n * 2 + n * 4 + m * 4 + n_leaf_rows * 4, n),
            # order read and row_value written for the rows of leaf nodes
            "K3leaf": bound_ms(n_leaf64 * 8, n_leaf64),
            # margin, row_value, label, weight read; margin, gh written
            "K4": bound_ms(n * 4 * 4 + n * 4 + n * 8, 60 * n),
        }
        library = {"K1": lib_k1, "K1root": lib_k1root, "K1deq": lib_k1deq,
                   "K3": lib_k3}
        for k in t:
            records[k].update(
                ms=t[k][0], device_ms=dev_ms[k], plain_ms=t[k][1],
                bound_ms=bounds[k][0], bound_by=bounds[k][1],
                library_ms=library.get(k))
    for k in records:
        records[k]["max_abs_err"] = max(res["int"][k], res["rand"][k])
    return res


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def train_expect(rounds, depth):
    """Launches of each training kernel in ``rounds`` rounds at ``depth``:
    per tree K1 at every level + the final totals, each dequantised once,
    K2's level step and the full K3 at every level, K2's final records and
    K3's leaf-value mode once (the final leaves); K4 once a round and once
    at set-up; K2's bare search is off the path."""
    return {"K1": rounds * (depth + 1), "K1deq": rounds * (depth + 1),
            "K2": 0, "K2level": rounds * depth,
            "K2leaf": rounds, "K3": rounds * depth, "K3leaf": rounds,
            "K4": rounds + 1}


def check_launches(launches, expect, what):
    for k in expect:
        check(launches[k] > 0 or expect[k] == 0,
              f"{k} never launched on {what}")
        check(launches[k] == expect[k],
              f"{k} launched {launches[k]} times on {what}, expected "
              f"{expect[k]}")


def phase_main(x, y, rounds, depth, actors):
    import torch

    import xgboost_ray_tpu_torch as xrt

    params = {"objective": "binary:logistic",
              "eval_metric": ["logloss", "error"],
              "max_depth": depth, "max_bin": 256}
    from xgboost_ray_tpu_torch.distributed import _KeepEngine
    from xgboost_ray_tpu_torch.engine import kernel_counters
    from xgboost_ray_tpu_torch.matrix import RayShardingMode, combine_data

    dm = xrt.RayDMatrix(x, y)
    evals_result, extra = {}, {}
    keep = _KeepEngine()
    fns = kernel_counters()
    for fn in fns.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # card 0 named: on a host of several cards train() alone would spawn a
    # rank a card (phase_ranks' NCCL path); the main path folds onto one
    bst = xrt.train(params, dm, rounds, evals=[(dm, "train")],
                    evals_result=evals_result, additional_results=extra,
                    callbacks=[keep], device="cuda:0",
                    ray_params=xrt.RayParams(num_actors=actors))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in fns.items()}
    # the engine's margins are the shards concatenated in rank order: put
    # them back in row order (INTERLEAVED sharding)
    margins = keep.engine.get_margins()[:, 0]
    sizes = [len(range(r, x.shape[0], actors)) for r in range(actors)]
    margins = combine_data(RayShardingMode.INTERLEAVED,
                           np.split(margins, np.cumsum(sizes)[:-1]))
    del keep
    expect = train_expect(rounds, depth)
    ll = evals_result["train"]["logloss"]
    check(all(np.isfinite(ll)), f"non-finite train logloss {ll}")
    check(all(b < a for a, b in zip(ll, ll[1:])),
          f"train logloss does not fall every round: {ll}")
    check_launches(launches, expect, "the main path")
    check(bst.num_boosted_rounds() == rounds, "wrong number of trees")
    rt = [r * 1e3 for r in extra["round_times_s"]]
    emit({"phase": "main_path", "rows": int(x.shape[0]), "features": int(x.shape[1]),
          "max_depth": depth, "max_bin": 256, "rounds": rounds,
          "num_actors": actors, "launches": launches, "expected": expect,
          "train_logloss": ll, "train_error": evals_result["train"]["error"],
          "round_ms": rt, "round_ms_median": float(np.median(rt)),
          "setup_s": extra["setup_time_s"], "sketch_s": extra["sketch_time_s"],
          "train_wall_s": wall, "world_size": extra["world_size"],
          "allreduce_bytes_per_round": extra["allreduce_bytes_per_round"]})
    return bst, launches, rt, margins


def same_bits(a, b):
    """Two float32 host arrays equal bit for bit."""
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def phase_determinism(runs):
    """C1: the main-path config trained twice in this process (and once
    with its rows in two shards folded onto the card) gives the same dump
    and bitwise the same margins."""
    (b1, m1), (b2, m2), (b3, m3) = runs
    d1 = b1.get_dump()
    out = {"phase": "determinism", "runs": ["num_actors=1", "num_actors=1",
                                            "num_actors=2 (folded)"],
           "dump_equal_rerun": b2.get_dump() == d1,
           "margins_bitwise_rerun": same_bits(m2, m1),
           "dump_equal_two_shards": b3.get_dump() == d1,
           "margins_bitwise_two_shards": same_bits(m3, m1),
           "margin_max_abs_diff_rerun": float(np.abs(m2 - m1).max()),
           "margin_max_abs_diff_two_shards": float(np.abs(m3 - m1).max())}
    emit(out)
    check(out["dump_equal_rerun"] and out["margins_bitwise_rerun"],
          "training the main path twice gave different models or margins")
    check(out["dump_equal_two_shards"] and out["margins_bitwise_two_shards"],
          "num_actors=2 on one card gave another model or margins than 1")
    return out


def ranks_world(data, params, rounds, depth, backend, ref_dump, ref_margins):
    """``_train_rank`` in a 2-rank world over ``backend`` (each rank on its
    INTERLEAVED shard): the ranks' report, with each rank's kernel launches
    (set to 0 just before its ``train()``) checked exactly."""
    from xgboost_ray_tpu_torch import distributed as D
    from xgboost_ray_tpu_torch.matrix import RayShardingMode, combine_data
    from xgboost_ray_tpu_torch.models.booster import RayXGBoostBooster

    t0 = time.perf_counter()
    out = D.launch_world(D._train_rank, 2, "cuda", data, params, rounds,
                         backend=backend)
    wall = time.perf_counter() - t0
    margins = combine_data(RayShardingMode.INTERLEAVED,
                           [o["margins"] for o in out])
    extra = out[0]["additional_results"]
    rt = [r * 1e3 for r in extra["round_times_s"]]
    expect = train_expect(rounds, depth)
    res = {"world_size": extra["world_size"], "backend": extra["backend"],
           "allreduce_bytes_per_round": extra["allreduce_bytes_per_round"],
           "round_ms": rt, "round_ms_median": float(np.median(rt)),
           "round_ms_median_rank1": float(np.median(
               [r * 1e3 for r in out[1]["additional_results"]["round_times_s"]])),
           "setup_s": extra["setup_time_s"],
           "launch_and_train_wall_s": wall,
           "train_logloss": out[0]["evals_result"]["train"]["logloss"],
           "launches": [o["launches"] for o in out], "expected": expect,
           "dumps_equal_one_rank": [
               RayXGBoostBooster.load_raw(o["model"]).get_dump() == ref_dump
               for o in out],
           "margins_bitwise_one_rank": same_bits(margins, ref_margins)}
    check(res["world_size"] == 2 and res["backend"] == backend,
          f"the ranks ran as {res['world_size']} over {res['backend']}")
    for r, o in enumerate(out):
        check_launches(o["launches"], expect, f"rank {r} over {backend}")
    check(all(res["dumps_equal_one_rank"]),
          f"a rank's model over {backend} differs from the 1-rank model")
    check(res["margins_bitwise_one_rank"],
          f"the 2-rank margins over {backend} are not bitwise the 1-rank "
          f"margins")
    return res


def phase_ranks(x, y, rounds, depth, ref_bst, ref_margins):
    """A6 on the card at full width: two ranks in one gloo world sharing
    the card (int64 CUDA all-reduces), each on its INTERLEAVED shard, give
    the 1-rank model and margins bit for bit, each rank's kernels launched
    as on the main path. Where there are two or more cards the same runs
    over NCCL, a card a rank, and ``train`` alone (no device named) spawns
    its NCCL ranks; with one card the NCCL path is reported as not run."""
    import torch

    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch import distributed as D

    params = {"objective": "binary:logistic",
              "eval_metric": ["logloss", "error"],
              "max_depth": depth, "max_bin": 256}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    data = D.share({"x": x, "label": y})
    share_s = time.perf_counter() - t0
    ref_dump = ref_bst.get_dump()
    res = {"phase": "ranks", "rows": int(x.shape[0]), "rounds": rounds,
           "share_s": share_s,
           **ranks_world(data, params, rounds, depth, "gloo", ref_dump,
                         ref_margins)}
    cards = torch.cuda.device_count()
    if cards >= 2:
        nccl = ranks_world(data, params, rounds, depth, "nccl", ref_dump,
                           ref_margins)
        ev, extra = {}, {}
        dm = xrt.RayDMatrix(x, y)
        bst = xrt.train(params, dm, rounds, evals=[(dm, "train")],
                        evals_result=ev, additional_results=extra,
                        ray_params=xrt.RayParams(num_actors=2))
        nccl["train_alone"] = {
            "world_size": extra["world_size"], "backend": extra["backend"],
            "dump_equal_one_rank": bst.get_dump() == ref_dump,
            "round_ms_median": float(np.median(extra["round_times_s"])) * 1e3}
        res["nccl"] = nccl
        check(nccl["train_alone"]["world_size"] == 2
              and nccl["train_alone"]["backend"] == "nccl"
              and nccl["train_alone"]["dump_equal_one_rank"],
              f"train() alone on {cards} cards: {nccl['train_alone']}")
    else:
        res["nccl"] = {"not_run": f"{cards} device"}
    del data
    emit(res)
    return res


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
    syncs = 0  # host waits on the card: scalar reads, stream/device syncs
    for e in prof.key_averages():
        if e.key in ("aten::_local_scalar_dense", "cudaStreamSynchronize",
                     "cudaDeviceSynchronize", "cudaMemcpy"):
            syncs += e.count
        if e.device_type != cuda:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        kern[e.key] = (kern.get(e.key, (0.0, 0))[0] + t / 1e3,
                       kern.get(e.key, (0.0, 0))[1] + e.count)
    # K2's level step, device us per launch by tree level
    lvl = sorted((e.time_range.start, e.time_range.elapsed_us())
                 for e in prof.events() if e.device_type == cuda
                 and e.name.startswith("xrt_split_level_kernel"))
    by_level = ([float(np.mean([t for _, t in lvl[d::depth]]))
                 for d in range(depth)] if len(lvl) == rounds * depth else None)
    device_ms = sum(v[0] for v in kern.values())
    launches = sum(v[1] for v in kern.values())
    kernels = sum(v[1] for k, v in kern.items()
                  if not k.startswith(("Memcpy", "Memset")))
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:20]
    out = {"phase": "profile", "rows": int(x.shape[0]), "rounds": rounds,
           "round_ms_unprofiled": round_ms,
           "device_ms_per_round": device_ms / rounds,
           "cuda_launches_per_round": launches / rounds,
           "kernel_launches_per_round": kernels / rounds,
           "host_syncs_per_round": syncs / rounds,
           "split_level_us_by_level": by_level,
           "device_idle_share": (None if round_ms is None else
                                 max(0.0, 1.0 - device_ms / rounds / round_ms)),
           "wall_ms_per_round_profiled": wall_ms / rounds,
           "device_idle_share_profiled": max(0.0, 1.0 - device_ms / wall_ms),
           "top_kernels_ms_per_round": [
               [k[:80], v[0] / rounds, v[1] / rounds] for k, v in top]}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 4: card against the CPU path
# ---------------------------------------------------------------------------


def phase_k1_time(n_rows, rounds):
    """K1's device time at level 5 and at the root, and the main path's
    median round, of the package this script is run beside."""
    import hashlib

    import torch

    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch.ops import histogram as H

    f, nbt = 28, 257
    out = {"phase": "k1_time", "package": os.path.dirname(xrt.__file__),
           "rows": n_rows}
    bins, gh, order, seg = level_inputs(n_rows, f, 32, 8, False)
    kw = {}
    if hasattr(H, "quant_scales"):
        qs = H.quant_scales(gh, n_rows)
        kw = {"qscale": qs}
        hk, tk = H.build_histogram(bins, gh, order, seg, 32, nbt, **kw)
        hq, tq = H.build_histogram_fixed_plain(bins, gh, order, seg, 32, nbt,
                                               qs)
        out["level5_bitwise"] = bool(torch.equal(hk, hq)
                                     and torch.equal(tk, tq))
        del hk, tk, hq, tq
    ident = torch.arange(n_rows, dtype=torch.int32, device="cuda")
    seg1 = torch.tensor([0, n_rows], dtype=torch.int32, device="cuda")
    out["k1_level5_device_ms"] = device_ms(lambda: H.build_histogram(
        bins, gh, order, seg, 32, nbt, **kw))
    out["k1_root_device_ms"] = device_ms(lambda: H.build_histogram(
        bins, gh, ident, seg1, 1, nbt, **kw))
    del bins, gh, order, seg, ident
    torch.cuda.empty_cache()
    x, y = make_higgs_like(n_rows, f, seed=0)
    dm = xrt.RayDMatrix(x, y)
    extra = {}
    bst = xrt.train({"objective": "binary:logistic",
                     "eval_metric": ["logloss"], "max_depth": 6,
                     "max_bin": 256}, dm, rounds, evals=[(dm, "train")],
                    additional_results=extra, device="cuda:0",
                    ray_params=xrt.RayParams(num_actors=1))
    rt = [r * 1e3 for r in extra["round_times_s"]]
    out.update(round_ms_median=float(np.median(rt)), round_ms=rt,
               dump_md5=hashlib.md5("".join(bst.get_dump()).encode())
               .hexdigest())
    emit(out)


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


# ---------------------------------------------------------------------------
# phase 6: predict and serve
# ---------------------------------------------------------------------------


#: B8's launch counters by (layout, mapping): the kernel table's rows
B8_PLAN_ROWS = {("heap", "rows"): "B8margin", ("node_array", "rows"):
                "B8margin_na", ("heap", "windows"): "B8serve",
                ("node_array", "windows"): "B8serve_na"}


def b8_counters():
    """B8's launch counts: margins (and values) by layout and mapping, leaf
    indices of the heap's rows mapping (each a kernel table row; the serve
    rows read the heap's windows launches), values alone, and every other
    launch (``B8other``: leaf indices of another plan)."""
    from xgboost_ray_tpu_torch.ops import predict as PR

    m, leaf = PR.predict_margin, PR.predict_leaf_index
    out = {key: m.launches_by_plan[plan]
           for plan, key in B8_PLAN_ROWS.items()}
    out["B8leaf"] = leaf.launches_by_plan["heap", "rows"]
    out["B8other"] = m.launches + leaf.launches - sum(out.values())
    out["B8value"] = m.launches_by_mode["value"]
    return out


def reset_b8_counters():
    from xgboost_ray_tpu_torch.ops import predict as PR

    for fn in (PR.predict_margin, PR.predict_leaf_index):
        fn.launches = 0
        fn.launches_by_layout = dict.fromkeys(PR.LAYOUTS, 0)
        fn.launches_by_plan = dict.fromkeys(PR.PLANS, 0)
    PR.predict_margin.launches_by_mode = dict.fromkeys(("margin", "value"), 0)


def b8_expect(**counts):
    """B8's counters all 0 but ``counts``."""
    return {**dict.fromkeys((*B8_PLAN_ROWS.values(), "B8leaf", "B8other",
                             "B8value"), 0), **counts}


def logloss_of_values(p, y):
    p = np.asarray(p, np.float64)
    y = np.asarray(y, np.float64)
    return float(-np.mean(y * np.log(p) + (1.0 - y) * np.log1p(-p)))


def phase_train_model(x, y, rounds):
    """The served model: ``train()`` for ``rounds`` rounds, keeping the
    engine's final margins (the after_iteration hook of the last round)."""
    import torch

    import xgboost_ray_tpu_torch as xrt

    kept = {}

    class KeepMargins:
        def after_iteration(self, engine, i, res):
            if i == rounds - 1:
                kept["margin"] = engine.get_margins()[:, 0]

    dm = xrt.RayDMatrix(x, y)
    ev, extra = {}, {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst = xrt.train({"objective": "binary:logistic", "eval_metric": ["logloss"],
                     "max_depth": 6, "max_bin": 256}, dm, rounds,
                    evals=[(dm, "train")], evals_result=ev,
                    additional_results=extra, callbacks=[KeepMargins()],
                    ray_params=xrt.RayParams(num_actors=1))
    torch.cuda.synchronize()
    ll = ev["train"]["logloss"]
    check(bst.num_trees == rounds, "wrong number of trees")
    check(all(np.isfinite(ll)), "non-finite train logloss")
    rt = [r * 1e3 for r in extra["round_times_s"]]
    emit({"phase": "served_model", "rows": int(x.shape[0]), "rounds": rounds,
          "train_wall_s": time.perf_counter() - t0,
          "round_ms_median": float(np.median(rt)),
          "train_logloss_first_last": [ll[0], ll[-1]]})
    return bst, kept["margin"], ll[-1]


def predict_chunks(bst, n_rows, row_bytes):
    """B8 launches of one ``RayXGBoostBooster.predict`` over ``n_rows``
    rows: one per device chunk."""
    return len(list(bst._chunks(n_rows, row_bytes)))


def phase_predict(bst, x, y, train_margin, last_ll):
    """``predict()`` over every row on the card (two ranks), checked
    against training's margins and logloss; B8's counters are set to 0
    just before the two calls and read just after."""
    import torch

    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch.ops.objectives import sigmoid

    n, f = x.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xd = torch.from_numpy(x).to("cuda")
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    del xd
    rp = xrt.RayParams(num_actors=2)
    dm = xrt.RayDMatrix(x)
    t0 = time.perf_counter()
    dm.load_data(2)  # the loader's share of predict(), timed apart
    load_s = time.perf_counter() - t0
    reset_b8_counters()
    t0 = time.perf_counter()
    margin = xrt.predict(bst, dm, ray_params=rp, output_margin=True)
    margin_s = time.perf_counter() - t0
    del dm
    t0 = time.perf_counter()
    value = xrt.predict(bst, xrt.RayDMatrix(x), ray_params=rp)
    value_s = time.perf_counter() - t0
    launches = b8_counters()
    chunks = predict_chunks(bst, n, 4 * (f + 2 * bst.num_outputs))
    # every row goes through the rows mapping; the values through the
    # kernel's fused sigmoid
    expect = b8_expect(B8margin=2 * chunks, B8value=chunks)
    check(margin.shape == (n,) and value.shape == (n,),
          "predict returned the wrong shape")
    check(bool(np.isfinite(margin).all()), "non-finite predicted margins")
    diff = np.abs(margin.astype(np.float64) - train_margin.astype(np.float64))
    n_over = int((diff > 1e-3).sum())
    ll = logloss_of_values(value, y)
    same_values = bool(np.array_equal(
        value, sigmoid(torch.from_numpy(margin)[:, None])[:, 0].numpy()))
    out = {"phase": "predict", "rows": int(n),
           "trees": bst.num_trees, "num_actors": 2,
           "predict_value_wall_s": value_s, "matrix_load_s": load_s,
           "predict_margin_wall_after_load_s": margin_s,
           "h2d_copy_s": h2d_s, "rows_over_1e-3": n_over,
           "max_abs_margin_diff_vs_training": float(diff.max()),
           "logloss_predicted": ll, "train_logloss_last": last_ll,
           "logloss_abs_diff": abs(ll - last_ll),
           "values_are_sigmoid_of_margins": same_values,
           "b8_launches": launches, "b8_launches_expected": expect}
    emit(out)
    check(n_over == 0, f"{n_over} rows' predicted margins differ from "
                       f"training's by more than 1e-3 (max {diff.max()})")
    check(abs(ll - last_ll) <= 1e-5,
          f"predicted logloss {ll} vs last train-logloss {last_ll}")
    check(same_values, "values are not the sigmoid of the margins")
    check(launches == expect, f"B8 launches of predict(): {launches}, "
                              f"expected {expect} (one per chunk and call)")
    return out


def phase_predict_leaf(bst, x):
    """``predict(..., pred_leaf=True)`` over two of the booster's leaf
    chunks (two ranks); B8's counters set to 0 just before, read just
    after. Checked against the plain walk on the CPU on the first rows."""
    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch.models import booster as B

    f = x.shape[1]
    row_bytes = 4 * (f + bst.num_trees)
    chunk = max(1, B._CHUNK_BYTES // row_bytes)
    n = min(x.shape[0], 2 * chunk)
    xs = x[:n]
    dm = xrt.RayDMatrix(xs)
    dm.load_data(2)
    reset_b8_counters()
    t0 = time.perf_counter()
    leaf = xrt.predict(bst, dm, ray_params=xrt.RayParams(num_actors=2),
                       pred_leaf=True)
    wall_s = time.perf_counter() - t0
    launches = b8_counters()
    del dm
    expect = b8_expect(B8leaf=predict_chunks(bst, n, row_bytes))
    ref = bst.predict(xs[:4096], pred_leaf=True, device="cpu")
    same = bool(leaf.shape == (n, bst.num_trees) and leaf.dtype == np.int32
                and np.array_equal(leaf[:4096], ref))
    del leaf
    out = {"phase": "predict_leaf", "rows": int(n), "trees": bst.num_trees,
           "chunk_rows": chunk, "num_actors": 2, "wall_s": wall_s,
           "first_4096_rows_equal_plain_cpu": same,
           "b8_launches": launches, "b8_launches_expected": expect}
    emit(out)
    check(same, "predict(pred_leaf=True) differs from the plain CPU walk")
    check(launches == expect, f"B8 launches of predict(pred_leaf=True): "
                              f"{launches}, expected {expect}")
    return out


def _post_json(url, doc, timeout=30.0):
    import urllib.request

    req = urllib.request.Request(url, json.dumps(doc).encode("utf-8"),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _probe(handle, bst, q):
    """Every served kind of ``q`` against ``booster.predict`` on the card
    and against the plain walk on the CPU, bitwise."""
    ok = {}
    for kind, kw in (("value", {}), ("margin", {"output_margin": True}),
                     ("leaf", {"pred_leaf": True})):
        r = _post_json(handle.url + "/predict",
                       {"data": q.tolist(), "kind": kind})
        for where, dev in (("card", None), ("cpu", "cpu")):
            ref = bst.predict(q, device=dev, **kw)
            got = np.asarray(r["predictions"], ref.dtype)
            ok[f"{kind}_{where}"] = bool(got.shape == ref.shape
                                         and np.array_equal(got, ref))
    return ok


def _closed_loop(handle, x, clients, req_rows_max, warm_s, duration_s):
    """``clients`` threads send 1-``req_rows_max``-row value requests to
    ``handle``. After ``warm_s`` the clients are parked until every request
    is answered; the serve metrics and B8's counters are set to 0 and the
    clients resume for ``duration_s``, then are parked again and the
    counters read: every launch of the window is one of its batches.
    Returns (snapshot at the end of the window, snapshot once parked,
    launches, client errors)."""
    import threading
    import urllib.request

    n_rows = x.shape[0]
    stop = threading.Event()
    go = threading.Event()
    go.set()
    parked = threading.Semaphore(0)
    errors = []

    def client(seed):
        rng = np.random.RandomState(seed)
        while not stop.is_set():
            if not go.is_set():
                parked.release()
                go.wait()
                continue
            n = int(rng.randint(1, req_rows_max + 1))
            lo = int(rng.randint(0, n_rows - n))
            body = json.dumps({"data": x[lo:lo + n].tolist()}).encode()
            req = urllib.request.Request(
                handle.url + "/predict", body,
                {"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=30.0) as r:
                    r.read()
            except Exception as exc:  # noqa: BLE001 - counted
                errors.append(repr(exc))

    def park():
        go.clear()
        for _ in range(clients):
            check(parked.acquire(timeout=60.0), "a serve client hung")

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    try:
        for t in threads:
            t.start()
        time.sleep(warm_s)
        park()
        handle.metrics.reset()
        reset_b8_counters()
        del errors[:]
        go.set()
        time.sleep(duration_s)
        snap = handle.metrics.snapshot()
        park()
        parked_snap = handle.metrics.snapshot()
        launches = b8_counters()
    finally:
        stop.set()
        go.set()
        for t in threads:
            t.join(10.0)
    return snap, parked_snap, launches, errors


def phase_serve(bst, x, layout="heap", clients=16, max_batch=256,
                max_delay_ms=2.0, req_rows_max=32, warm_s=1.5,
                duration_s=6.0):
    """The closed loop of ``bench.py``'s serve section on the card, for a
    server of the given forest layout."""
    from xgboost_ray_tpu_torch import serve

    handle = serve.create_server(bst, max_batch=max_batch,
                                 max_delay_ms=max_delay_ms, layout=layout)
    builds_after_warmup = serve.compile_count()
    try:
        probe = _probe(handle, bst, x[:37])
        snap, parked, launches, errors = _closed_loop(
            handle, x, clients, req_rows_max, warm_s, duration_s)
        builds = serve.compile_count() - builds_after_warmup
        batch_device_ms = None
        if layout == "heap":
            with handle.registry.lease() as entry:
                q32 = x[:32]
                batch_device_ms = device_ms(
                    lambda: entry.predictor.predict(q32, "value"), iters=20)
        probe_after = _probe(handle, bst, x[37:74])
    finally:
        handle.shutdown()
    # every batch: one value launch (the sigmoid fused) of the windows
    # mapping in the server's layout
    expect = b8_expect(**{B8_PLAN_ROWS[layout, "windows"]: parked["batches"],
                          "B8value": parked["batches"]})
    out = {"phase": "serve", "layout": layout, "trees": bst.num_trees,
           "clients": clients, "max_batch": max_batch,
           "max_delay_ms": max_delay_ms, "req_rows_max": req_rows_max,
           "warm_s": warm_s, "duration_s": duration_s,
           "client_errors": len(errors), "errors_sample": errors[:3],
           "probe_bitwise": probe, "probe_bitwise_after_load": probe_after,
           "builds_after_warmup": builds,
           "b8_device_ms_per_batch_32_rows": batch_device_ms,
           "b8_launches": launches, "batches_once_parked": parked["batches"],
           **{k: snap[k] for k in (
               "requests", "rows", "errors", "qps", "rows_per_s", "batches",
               "mean_batch_rows", "padding_waste", "latency_p50_ms",
               "latency_p95_ms", "latency_p99_ms", "latency_mean_ms",
               "recompile_count")}}
    emit(out)
    check(len(errors) == 0, f"{len(errors)} client errors: {errors[:3]}")
    check(all(probe.values()) and all(probe_after.values()),
          f"served probes not bitwise equal to booster.predict and the "
          f"plain CPU walk: {probe}, {probe_after}")
    check(builds == 0 and snap["recompile_count"] == 0,
          f"{builds} kernel builds after warmup")
    check(snap["requests"] > 0, "no request served in the measured window")
    check(launches == expect, f"B8 launches in the serve window ({layout}): "
                              f"{launches}, expected one per batch {expect}")
    return out


SERVE_ROWS = (8, 32, 256)  # serve buckets timed as rows of the kernel table
#: SM counts that make B8's launch plan take each mapping at any batch
#: size: on one SM every batch fills the card in rows; on a vast card none
SMS_FOR = {"rows": 1, "windows": 1 << 30}


def b8_visits(fo, xq):
    """Node visits the rows of ``xq`` need through ``fo``: a leaf at heap
    index h was reached after floor(log2(h + 1)) compares."""
    import torch

    from xgboost_ray_tpu_torch.ops import predict as PR

    h = PR.predict_leaf_index(fo, xq)
    return int(torch.floor(torch.log2(h.double() + 1)).sum())


def phase_b8(bst, x, records, slice_rows=262_144):
    """B8 against its plain version (bitwise) on a slice, at every serve
    bucket, one row and a size for each rows-per-CTA choice, in both
    layouts and every mode (margins, values, leaf indices) and mapping;
    then timed at the main path's shapes: margins over every row (the
    predict() launch), leaf indices over the booster's predict_leaf chunk,
    and margins at 8, 32 and 256 rows (serve buckets)."""
    import torch

    from xgboost_ray_tpu_torch.models import booster as B
    from xgboost_ray_tpu_torch.ops import predict as PR

    # this tree's B8 has the value mode and mappings; an older tree's B8
    # (copied this script into it for a one-call comparison) has neither
    new = hasattr(PR, "launch_plan")
    value_kw = {"transform": bst.params.objective}
    m0 = bst.base_score_margin_np()
    n, f = x.shape
    t_trees = bst.num_trees
    fo = {lay: bst.device_forest("cuda", lay) for lay in PR.LAYOUTS}
    sm_count = getattr(PR, "_sm_count", None)

    def sms_as(sms):
        """Make the launch plan read ``sms`` SMs (None: the card's own)."""
        if new:
            PR._sm_count = sm_count if sms is None else (lambda index: sms)

    def plan(m):
        if not new:
            return f"R{PR.rows_per_block(m, 1, torch.device('cuda'))}"
        p = PR.launch_plan(m, 1, fo["heap"], False, torch.device("cuda"))
        return (f"windows R{p.rows_per_block}" if p.mapping == "windows"
                else f"rows tile {p.trees_per_tile}")

    def hold(xq, what):
        """Every mode of B8 on xq, both layouts (and each mapping), against
        the plain version on the card: bitwise. Returns max abs errors."""
        errs = {}
        for lay in PR.LAYOUTS:
            mp = PR.predict_margin_plain(fo[lay], xq, base0=m0)
            lp = PR.predict_leaf_index_plain(fo[lay], xq)
            vp = (PR.predict_margin_plain(fo[lay], xq, base0=m0, **value_kw)
                  if new else None)
            for mapping in PR.MAPPINGS if new else (None,):
                sms_as(SMS_FOR.get(mapping))
                mk = PR.predict_margin(fo[lay], xq, base0=m0)
                lk = PR.predict_leaf_index(fo[lay], xq)
                torch.cuda.synchronize()
                check(torch.equal(bits(mk), bits(mp)),
                      f"B8 margins ({lay}, {mapping}, {what}) not bitwise "
                      f"equal to the plain version")
                check(torch.equal(lk, lp),
                      f"B8 leaf indices ({lay}, {mapping}, {what}) not "
                      f"equal to the plain version")
                errs[lay] = max(errs.get(lay, 0.0),
                                float((mk - mp).abs().max()))
                if new:
                    vk = PR.predict_margin(fo[lay], xq, base0=m0, **value_kw)
                    torch.cuda.synchronize()
                    check(torch.equal(bits(vk), bits(vp)),
                          f"B8 values ({lay}, {mapping}, {what}) not "
                          f"bitwise equal to the plain version")
        sms_as(None)
        return errs

    xs = torch.from_numpy(x[:slice_rows]).to("cuda")
    errs = hold(xs, f"{xs.shape[0]} rows")
    emit({"phase": "b8_vs_plain", "rows": int(xs.shape[0]), "trees": t_trees,
          "plan": plan(xs.shape[0]), "max_abs_err": errs, "leaf_equal": True,
          "values_bitwise": new})
    del xs

    # the shapes serving gives B8: every bucket of a max_batch-256 server,
    # one row, and a size for each other rows-per-CTA choice
    ctas = 4 * PR._sm_count(torch.cuda.current_device())
    sizes = (1, 8, 16, 32, 64, 128, 256, 2 * ctas, 4 * ctas, 8 * ctas)
    plans, bucket_errs = {}, {}
    for i, m in enumerate(sizes):
        lo = (i * 7919) % (n - m)
        bucket_errs[m] = hold(torch.from_numpy(x[lo:lo + m]).to("cuda"),
                              f"{m} rows")
        plans[m] = plan(m)
    emit({"phase": "b8_buckets_vs_plain", "trees": t_trees,
          "plan_by_rows": plans, "bitwise": True, "values_bitwise": new})
    if new:
        want = {"windows R1", "windows R2", "windows R4", "windows R8"}
        check(want <= set(plans.values()) and plan(slice_rows).startswith(
            "rows"), f"not every mapping was checked: {plans}")

    xd = torch.from_numpy(x).to("cuda")
    n_leaf = min(n, max(1, B._CHUNK_BYTES // (4 * (f + t_trees))))
    visits, visits_leaf = 0, None
    for lo in range(0, n, n_leaf):
        visits += b8_visits(fo["heap"], xd[lo:lo + n_leaf])
        if visits_leaf is None:  # the leaf timing's rows: the first chunk
            visits_leaf = visits
    heap = bst.forest.feature.shape[1]
    # the forest as the heap's six separate fields, 18 bytes a node: the
    # count the B8 rows have always used, whatever the kernel reads
    forest_bytes = t_trees * heap * (4 + 4 + 4 + 1 + 1 + 4)
    out_m = torch.empty((n, 1), device="cuda")
    xl = xd[:n_leaf]
    out_l = torch.empty((n_leaf, t_trees), dtype=torch.int32, device="cuda")
    kernel = {
        "B8margin": lambda: PR.predict_margin(fo["heap"], xd, base0=m0,
                                              out=out_m),
        "B8margin_na": lambda: PR.predict_margin(fo["node_array"], xd,
                                                 base0=m0, out=out_m),
        "B8leaf": lambda: PR.predict_leaf_index(fo["heap"], xl, out=out_l),
    }
    plain = {
        "B8margin": lambda: PR.predict_margin_plain(fo["heap"], xd, base0=m0),
        "B8margin_na": lambda: PR.predict_margin_plain(fo["node_array"], xd,
                                                       base0=m0),
        "B8leaf": lambda: PR.predict_leaf_index_plain(fo["heap"], xl),
    }
    margin_bound = bound_ms(n * f * 4 + n * 4 + forest_bytes,
                            visits + 2 * n * t_trees)
    t = {key: dict(bound=margin_bound, max_abs_err=errs[lay])
         for key, lay in (("B8margin", "heap"), ("B8margin_na", "node_array"))}
    t["B8leaf"] = dict(
        bound=bound_ms(n_leaf * f * 4 + n_leaf * t_trees * 4 + forest_bytes,
                       visits_leaf), max_abs_err=0.0)
    for m in SERVE_ROWS:  # a serve bucket's batch, bound counted alike
        xq = xd[1000:1000 + m]
        oq = torch.empty((m, 1), device="cuda")
        key = f"B8serve{m}"
        kernel[key] = (lambda xq=xq, oq=oq: PR.predict_margin(
            fo["heap"], xq, base0=m0, out=oq))
        plain[key] = (lambda xq=xq: PR.predict_margin_plain(
            fo["heap"], xq, base0=m0))
        t[key] = dict(bound=bound_ms(m * f * 4 + m * 4 + forest_bytes,
                                     b8_visits(fo["heap"], xq)
                                     + 2 * m * t_trees),
                      max_abs_err=bucket_errs[m]["heap"], plan=plan(m))
    for key, fn in kernel.items():
        t[key]["device_ms"] = device_ms(
            fn, iters=50 if key.startswith("B8serve") else 5)
    if new:  # the value mode at full size (the fused sigmoid's cost)
        t["B8margin"]["value_device_ms"] = device_ms(
            lambda: PR.predict_margin(fo["heap"], xd, base0=m0, out=out_m,
                                      **value_kw), iters=5)
    for key, fn in kernel.items():
        small = key.startswith("B8serve")
        t[key]["ms"] = cuda_ms(fn, iters=50 if small else 5, warmup=1)
    for key, fn in plain.items():
        t[key]["plain_ms"] = cuda_ms(fn, iters=1, warmup=0)
    for key, v in t.items():
        records[key].update(ms=v["ms"], device_ms=v["device_ms"],
                            plain_ms=v["plain_ms"], bound_ms=v["bound"][0],
                            bound_by=v["bound"][1], library_ms=None,
                            max_abs_err=v["max_abs_err"])
    emit({"phase": "b8_timing", "rows_margin": n, "rows_leaf": n_leaf,
          "trees": t_trees, "node_visits": visits,
          "visits_per_row_tree": visits / (n * t_trees),
          "plan": {"margin": plan(n)},
          **{k: {kk: (vv if kk != "bound" else list(vv))
                 for kk, vv in v.items()} for k, v in t.items()}})
    return t


def phase_late_profile(bst, x):
    """Whether torch.profiler sees B8's full-size margins launch late in the
    process (after phases 2-6); recorded, not checked."""
    import torch

    from xgboost_ray_tpu_torch.ops import predict as PR

    xd = torch.from_numpy(x).to("cuda")
    fo = bst.device_forest("cuda")
    m0 = bst.base_score_margin_np()
    try:
        ms = device_ms(lambda: PR.predict_margin(fo, xd, base0=m0), iters=3)
    except SmokeFailure as exc:
        ms, seen = None, str(exc)[:300]
    else:
        seen = "device time recorded"
    out = {"phase": "late_profile", "b8_margin_device_ms": ms,
           "profiler": seen}
    emit(out)
    return out


KERNELS = {
    "K1": dict(name="K1 histogram build + node totals, int64 fixed point "
               "(level 5: 32 nodes)",
               route="cuda", source="xgboost_ray_tpu_torch/csrc/histogram.cu",
               replaces="46abde5^:xgboost_ray_tpu/ops/hist_pallas.py:105"),
    "K1root": dict(name="K1 histogram build + node totals, int64 fixed point "
                   "(root: 1 node, "
                   "identity order)", route="cuda",
                   source="xgboost_ray_tpu_torch/csrc/histogram.cu",
                   replaces="46abde5^:xgboost_ray_tpu/ops/hist_pallas.py:105"),
    "K1deq": dict(name="K1 dequantise: merged int64 sums -> the f32 "
                  "histogram K2 reads (level 5: 16 parents' smaller "
                  "children)", route="cuda",
                  source="xgboost_ray_tpu_torch/csrc/histogram.cu",
                  replaces="46abde5^:xgboost_ray_tpu/ops/hist_pallas.py:105"),
    "K2": dict(name="K2 node totals + split search alone (find_splits, "
               "level 5: 32 nodes)", route="cuda",
               source="xgboost_ray_tpu_torch/csrc/split.cu",
               replaces="xgboost_ray_tpu/ops/split.py:79"),
    "K2level": dict(name="K2 level step: sibling formation + totals + split "
                    "search + tree records (level 5: 16 parents, 32 nodes)",
                    route="cuda", source="xgboost_ray_tpu_torch/csrc/split.cu",
                    replaces="xgboost_ray_tpu/ops/grow.py:570"),
    "K2leaf": dict(name="K2 final-level records (64 nodes)", route="cuda",
                   source="xgboost_ray_tpu_torch/csrc/split.cu",
                   replaces="xgboost_ray_tpu/ops/grow.py:765"),
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
    "B8margin": dict(name="B8 forest walk: margins, heap layout (every row "
                     "of predict(), 500 trees)", route="cuda",
                     source="xgboost_ray_tpu_torch/csrc/predict.cu",
                     replaces="xgboost_ray_tpu/ops/predict.py:52"),
    "B8margin_na": dict(name="B8 forest walk: margins, node-array layout "
                        "(every row, 500 trees; predict() walks the heap, "
                        "so no launch on the main path)", route="cuda",
                        source="xgboost_ray_tpu_torch/csrc/predict.cu",
                        replaces="xgboost_ray_tpu/ops/node_array.py:141"),
    "B8leaf": dict(name="B8 forest walk: leaf indices, heap layout (one "
                   "predict_leaf chunk, 500 trees)", route="cuda",
                   source="xgboost_ray_tpu_torch/csrc/predict.cu",
                   replaces="xgboost_ray_tpu/ops/predict.py:512"),
    **{f"B8serve{m}": dict(
        name=f"B8 forest walk: margins, heap layout, a serve batch of {m} "
             f"rows (windows mapping; launches: every batch of the heap "
             f"server, all buckets together)",
        route="cuda", source="xgboost_ray_tpu_torch/csrc/predict.cu",
        replaces="xgboost_ray_tpu/ops/predict.py:52") for m in SERVE_ROWS},
}

#: kernels of the training path (phase 3's counters)
TRAIN_KERNELS = ("K1", "K1root", "K1deq", "K2", "K2level", "K2leaf", "K3",
                 "K3leaf", "K4")


def run(args):
    global CARD
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
    card = CARD = gpu_name_and_power()
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
    if args.k1_time:
        phase_k1_time(args.rows, args.rounds)
        return
    if args.ranks_only:
        x, y = make_higgs_like(args.rows, 28, seed=0)
        bst, _, _, margins = phase_main(x, y, args.rounds, 6, 1)
        phase_ranks(x, y, args.rounds, 6, bst, margins)
        return
    build_report = phase_build_report(args.predict_rounds, args.rows)

    x, y = make_higgs_like(args.rows, 28, seed=0)
    if args.profile_only:
        phase_profile(x, y, 6, None)
        return
    # phase 6's model, then phase 7 (B8 against its plain version and its
    # times) before the other phases: later in the process torch.profiler
    # records no device activity for B8's full-size launches (PERF.md §7)
    records = {k: dict(v) for k, v in KERNELS.items()}
    served, train_margin, last_ll = phase_train_model(x, y,
                                                      args.predict_rounds)
    b8 = phase_b8(served, x, records)
    torch.cuda.empty_cache()
    if args.b8_only:
        return

    phase_kernels(args.rows, {k: records[k] for k in TRAIN_KERNELS})

    if args.rows < 11_000_000:
        emit({"phase": "main_path_cut", "rows": args.rows,
              "reason": "--rows below the 11,000,000-row HIGGS protocol"})
    results = {}
    runs = []
    for i, (key, actors) in enumerate((("1", 1), ("1_rerun", 1), ("2", 2))):
        b, launches, rt, margins = phase_main(x, y, args.rounds, 6, actors)
        results[key] = {"launches": launches, "round_ms": rt}
        runs.append((b, margins))
        if i == 0:
            for k in TRAIN_KERNELS:
                # the root row is K1 at another shape: the same launches
                records[k]["launches"] = launches[k.replace("root", "")]
    bst = runs[0][0]
    results["determinism"] = phase_determinism(runs)
    results["ranks"] = phase_ranks(x, y, args.rounds, 6, bst, runs[0][1])
    del runs
    results["profile"] = phase_profile(x, y, 6,
                                       float(np.median(results["1"]["round_ms"])))
    cmp_rows = min(args.compare_rows, args.rows)
    cmp = phase_cpu_vs_card(x[:cmp_rows], y[:cmp_rows])
    phase_save_load(bst)

    # phase 6: predict and serve, each path with B8's counters set to 0
    # just before it and read just after
    results["b8"] = b8
    results["predict"] = phase_predict(served, x, y, train_margin, last_ll)
    results["predict_leaf"] = phase_predict_leaf(served, x)
    results["serve"] = phase_serve(served, x)
    results["serve_node_array"] = phase_serve(
        served, x, layout="node_array", warm_s=0.5, duration_s=2.0)
    by_path = {p: results[p]["b8_launches"] for p in (
        "predict", "predict_leaf", "serve", "serve_node_array")}
    b8_launches = {k: sum(v[k] for v in by_path.values())
                   for k in by_path["predict"]}
    emit({"phase": "b8_launches", "by_path": by_path,
          "launches": b8_launches})
    for k, v in b8_launches.items():
        # the node array's rows mapping is off these paths (predict()
        # walks the heap); it is held and timed in phase 7
        check(v > 0 or k in ("B8other", "B8margin_na"),
              f"{k} never launched on the predict/serve path")
    for k in ("B8margin", "B8margin_na", "B8leaf"):
        records[k]["launches"] = b8_launches[k]
    for m in SERVE_ROWS:  # the windows kernel of the heap server's batches
        records[f"B8serve{m}"]["launches"] = b8_launches["B8serve"]
    results["late_profile"] = phase_late_profile(served, x)
    pr = results["predict"]
    emit({"phase": "predict_summary", "rows": pr["rows"], "trees": pr["trees"],
          "predict_value_wall_s": pr["predict_value_wall_s"],
          "matrix_load_s": pr["matrix_load_s"],
          "predict_margin_wall_after_load_s":
              pr["predict_margin_wall_after_load_s"],
          "h2d_copy_s": pr["h2d_copy_s"],
          "b8_device_ms_all_rows": results["b8"]["B8margin"]["device_ms"],
          "b8_device_ms_per_serve_batch_32_rows":
              results["serve"]["b8_device_ms_per_batch_32_rows"]})

    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
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
    ap.add_argument("--predict-rounds", type=int, default=500,
                    help="rounds of phase 6's served model")
    ap.add_argument("--b8-only", action="store_true",
                    help="only the served model and B8's timings (works on "
                         "another tree of the package too); prints no "
                         "result line")
    ap.add_argument("--profile-only", action="store_true",
                    help="only the main path's profile (device time and CUDA "
                         "launches per round; works on an older tree of the "
                         "package too); prints no result line")
    ap.add_argument("--k1-time", action="store_true",
                    help="only K1's times and the main path's median round "
                         "(works on an older tree of the package too); "
                         "prints no result line")
    ap.add_argument("--ranks-only", action="store_true",
                    help="only the 1-rank main path and the ranks phase (on "
                         "a host of two or more cards: the NCCL path); "
                         "prints no result line")
    args = ap.parse_args()
    try:
        run(args)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()

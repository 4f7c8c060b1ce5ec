#!/usr/bin/env python3
"""Drive xgboost_ray_tpu_torch on one NVIDIA GPU and check it end to end.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device and ``nvcc``, and nothing of JAX (``triton``, where installed,
is only where it may find ``cuobjdump``). Phases:

1. build: compile the CUDA kernels of ``xgboost_ray_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel); time K4's first launches in both
   modes and the softmax pass's; report each K1, K3, B8, B4, K4 and softmax
   kernel's registers, shared memory and spills (``-Xptxas -v``)
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
   on both; K4's margins and gradients bitwise, 0 ulps, its partials within
   1e-5 relative); K1's int64 sums and its dequantise step are bitwise against
   ``build_histogram_fixed_plain`` / ``dequantize_plain`` on both; K3
   also with the smaller children chosen from counts merged with a second
   rank's (what it does above one rank), compacted into N slots; each
   kernel is timed with
   CUDA events around its wrapper (``ms``: the host's issue time shows
   where it is the slower) and by ``torch.profiler`` (``device_ms``: the
   kernels' own device time per launch; K4 also with the L2 flushed by a
   write and by a read, warm, and its host time a call), beside its plain
   version and,
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
4. the card against the port's CPU path on a 200,000-row slice (3 rounds):
   against the f32 CPU path the first tree equal, logloss within 1e-5 and
   margins within 1e-3; against the CPU path summing in the card's fixed
   point the whole model (dumps equal, final margins bitwise);
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

8. held-out eval sets (``evals``, right after phase 2), the HIGGS
   protocol's split: the first 10,500,000 rows train, the last 500,000 are
   the test set (``evals=[(dtrain, "train"), (dtest, "test")]``, 10
   rounds, ``eval_metric`` error then logloss); ``train()`` without and
   with the test set in turns (without, with, with, without: round times,
   each run's launches counted from 0 and checked exactly, with the test
   set one B4 and one K4 eval-mode launch a round; no kernel build in any
   of them); B4 bitwise against its
   plain version over the test rows for every tree, K4's eval mode against
   its plain version (margins bitwise, partials within 1e-5 relative), both
   timed (B4's bound from the 32-byte sectors of bins its walks read; B4
   also on each mapping of its launch plan, each bitwise, beside the plan's
   choice and the bytes a tiled walk reads); the
   test margins within 1e-4 of ``booster.predict(x_test,
   output_margin=True)``; 30 rounds with ``early_stopping_rounds=3``
   (``best_iteration`` the argmin of the test logloss, stopped 3 rounds
   after it or at round 30); a warm start, 5 rounds then 5 more through
   ``xgb_model``, twice (10 trees, the first 5 the uninterrupted run's, the
   rerun bitwise; the margin difference to the uninterrupted run printed);
   and ROADMAP C2, every row sketched with random positive weights twice
   and with its rows in two shards folded: bitwise the same cuts.

9. multiclass (``multiclass``, right after phase 8): Covertype's shape
   (``make_covertype_like``: 581,012 rows x 54 features, 10 continuous
   then 4 + 40 one-hot columns, labels a seeded function of the features
   with Covertype's class counts), the last 116,202 rows the test set,
   ``multi:softprob`` with ``num_class`` 7, depth 6, 256 bins, 10 rounds
   (70 trees); ``train()`` without and with the test set in turns, each
   run's launches counted from 0 and checked exactly (per tree the binary
   path's K1-K3, one training-mode softmax pass a round and round 0's;
   with the test set one B4 over the round's 7 trees and one eval-mode
   pass a round); reruns and two shards folded give equal dumps and
   bitwise margins; the test mlogloss falls and the test margins are the
   booster's within 1e-4; the softmax pass in each mode and B4 at T = 7
   bitwise against their plain versions on the phase's tensors (partial
   sums within 1e-5 relative) and timed, the transform beside
   ``torch.softmax``; K1 and K2's level step at 54 features; a profile
   of two rounds; ``predict()`` over every row (values bitwise the plain
   transform of B8's margins, one B8 and one transform launch a chunk);
   a server of the model (probes bitwise, no build after warmup, a short
   closed loop: every batch one B8 margin launch and one transform
   launch, no client error); early stopping on the test mlogloss; a
   5 + 5 warm start twice; the card against the CPU path on 50,000 rows
   and 3 rounds (phase 4's rule); and ``multi:softprob`` at K = 33 classes
   (the softmax pass's path above 32 classes: 10,000 rows, 3 rounds, labels
   a seeded score's quantiles), launches checked, against the CPU path
   summing in the card's fixed point by phase 4's rule.

10. the facade (``facade``, right after phase 9), each step's launches
   counted from 0 and checked exactly: ``RayXGBClassifier`` (10 rounds,
   depth 6, 256 bins, ``eval_metric`` error then logloss) on phase 8's
   HIGGS split with the test set as ``eval_set``: its model, test history
   and launches equal to ``train()``'s with the test set, ``predict_proba``
   bitwise ``booster.predict``, ``predict`` the classes of p > 0.5,
   ``apply`` bitwise ``predict(pred_leaf=True)``, ``feature_importances_``
   the normalised gain, the fit's wall time beside ``train()``'s and the
   label encoding's (``np.unique``) beside the JAX module's per-row dict
   loop; early stopping over 30 rounds (``best_iteration`` the argmin of
   the test logloss, predictions from rounds [0, best + 1)); a pickle
   round trip (bitwise predictions); ``RayXGBRegressor`` over all
   11,000,000 rows with a numpy squared-error objective and with
   ``reg:squarederror`` (``base_score`` 0.5): the same model and final
   margins bit for bit, K4 only in its no-gradient mode in the custom run,
   whose mode at this shape is held against its plain version and timed,
   the two runs' rounds printed; the classifier on phase 9's Covertype
   set with labels 1..7 (``classes_``, the ``train()`` model, predictions
   the classes of the probabilities' argmax); a numpy softmax objective
   and mlogloss ``custom_metric`` at Covertype's shape (history within
   1e-5 of the built-in mlogloss; the softmax pass's no-gradient mode at
   464,810 x 7 held and timed); Covertype's 116,202 test rows x 54 as 4
   CSV files loaded centrally (the native parser read every file; the tune
   report callback under a ``TuneSession`` reported every round) and by 2
   gloo ranks sharing the card (``distributed=True``, 2 files a rank, each
   rank's distributed callbacks in the JAX package's hook order), every
   model the numpy-input model; Parquet where pyarrow imports; and, where
   scikit-learn imports, ``clone`` and a 2-fold ``GridSearchCV`` over
   ``max_depth`` {2, 3} on 50,000 rows.
11. SHAP (``shap``, after phase 6's paths), B15's counters set to 0 just
   before each path and checked exactly after it (one launch a chunk):
   ``predict(bst, RayDMatrix(x[:1,048,576]), RayParams(num_actors=2),
   pred_contribs=True)`` on phase 6's 500-tree model (122 MB out), again
   with ``approx_contribs=True``, and ``pred_interactions=True`` over
   65,536 rows (220 MB): every row sums to B8's margin within the f32
   bound of ``shap_sum_bound``, each interaction row to its feature's
   exact contribution; the exact result bitwise the booster's own call, a
   rerun, and the rows at batch 8 and 256 bitwise inside the big call (all
   three entry points); each entry point bitwise its plain version on the
   card on 4,096 rows (exact and Saabas over the whole forest, the
   interactions over the first 50 rounds: the plain version's D^2 loops
   of PyTorch calls take minutes over 500 trees); Covertype's model
   (``multi:softprob``, K = 7, 70 trees, F = 54, trained here) over its
   116,202 test rows (179 MB) and interactions over 4,096 rows, their sums
   checked and exact held against plain; each entry point timed at the
   main path's shape (events; device time L2 flushed by a write, by a
   read, and warm) and at 4,096 rows beside its plain version, its bound
   from the forest's actual leaves (``ops/shap.leaf_ops``); no PyTorch
   call computes TreeSHAP, so ``library_ms`` is null;
12. the replica pool (``serve_pool``): ``create_server(bst,
   n_replicas=1)`` and ``n_replicas=4`` under the 16-client closed loop
   (1 s warmup, 3 s measured; qps and p50/p95/p99 side by side, no
   claim), probes of all four kinds bitwise ``booster.predict`` on the
   card and on the CPU (``contribs`` one B15 launch a batch), no kernel
   build after warmup, one B8 value launch per batch, no client error;
   a replica killed half-way through a 4-replica window and then
   rejoined: no client error, the kill on the trace; an autoscaler up /
   down cycle read back from the trace alone (scale events and the
   replica count replayed from the membership events); the canary on a
   2-replica server: a 20-round model on shuffled labels rolls back, a
   ``refresh`` of the served model (5 rounds with ``xgb_model``, on the
   card) is promoted and then served, counted in the serve metrics; the
   served model exported to xgboost JSON and imported: margins and values
   over 1,000,000 rows and contributions over 4,096 bitwise the
   original's, and ``POST /models`` with the file hot-swaps a server
   (margins bitwise); the whole trace valid against the schema and the
   event names.

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

``--multiclass-only`` runs the build and phase 9 alone and prints its
kernel rows but no result line; ``--evals-only`` the same for phase 8.
Both work in an older tree of the package too (copy this script into its
root), so two versions of the softmax pass and B4 are timed in turns in
one call.

``--kernels-only`` runs the build and phase 2 alone and prints its kernel
rows but no result line; it works in an older tree too (copy this script
into its root; there K4's gradients are held within 1e-6, as that tree's
Triton K4 was), so two versions of K4's gh mode are timed in turns in one
call.

``--k4-variants`` runs the build and then times K4 as built against edits
of its source compiled beside it (``K4_VARIANTS``: no last-CTA sum,
streaming loads, streaming stores) in turns, in both modes, and prints one
JSON line and no result line.

``--facade-only`` runs the build and phase 10 alone and prints its kernel
rows but no result line.

``--ranks-only`` runs the build, the 1-rank main path and the ranks phase
(on a host of two or more cards also the NCCL path, against the 1-rank
run) and prints no result line.

``--shap-only`` runs the build, phase 6's model and phase 11 and prints
its kernel rows but no result line; ``--pool-only`` the same for phase 12.
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


def host_call_us(fn, iters=200, runs=5):
    """Host time per call of ``fn`` called back to back, in us: its Python,
    argument set-up and launch, not the device's work (200 launches stay
    far from the launch queue's bound). The median of ``runs`` runs, each
    followed by a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        per_call.append((time.perf_counter() - t0) / iters * 1e6)
        torch.cuda.synchronize()
    return float(np.median(per_call))


def device_ms(fn, iters=10, only=None, every=False, blind="events",
              tries=3):
    """Device time per call of ``fn`` of the kernels it launches, from
    ``torch.profiler``: the port's own kernels, not the wrapper's
    allocations and fills (PyTorch's ``at::`` kernels, copies, memsets);
    with ``only``, the kernels whose name holds it (any case), PyTorch's
    too (a library call's); with ``every``, all of its device work.

    Late in a long process the profiler drops an execution or two of the
    ``iters`` calls now and then, so a kernel's time is its mean over the
    executions recorded times its executions a call (the recorded count
    over the calls, rounded); a drop is reported as a ``profiler_lost``
    line. Now and then it records no device activity at all (its CUPTI
    buffer comes back empty): it is asked ``tries`` times, and if it stays
    blind the call is timed with CUDA events instead (``cuda_ms``: all of
    the call's device work, the wrapper's fills too), reported as a
    ``profiler_blind`` line; with ``blind="raise"`` it fails instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times, counts = {}, {}
        seen = []
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None)
            t = e.self_cuda_time_total if t is None else t
            seen.append((e.key[:60], str(e.device_type), t))
            if e.device_type != torch.autograd.DeviceType.CUDA or (
                    not every and ((only.lower() not in e.key.lower())
                                   if only else
                                   ("at::" in e.key or
                                    e.key.startswith(("Memcpy", "Memset"))))):
                continue
            times[e.key] = times.get(e.key, 0.0) + t / 1e3
            counts[e.key] = counts.get(e.key, 0) + e.count
        if sum(times.values()) > 0:
            break
    else:
        events = sorted(seen, key=lambda v: -v[2])[:8]
        check(blind == "events",
              f"torch.profiler saw no device time of the kernels in "
              f"{tries} tries; events: {events}")
        ms = cuda_ms(fn, iters=iters)
        emit({"phase": "profiler_blind", "tries": tries, "calls": iters,
              "events": events, "cuda_event_ms": ms})
        return ms
    if any(c % iters for c in counts.values()):
        emit({"phase": "profiler_lost", "calls": iters,
              "executions": {k[:80]: c for k, c in counts.items()}})
    return sum(times[k] / counts[k] * max(1, round(counts[k] / iters))
               for k in times if counts[k])


def profile_steps(step, first, rounds, tries=3):
    """``torch.profiler`` over ``rounds`` calls of ``step(i)`` from round
    ``first`` on: the profile and its wall ms. Where the profiler records no
    device activity, the next ``rounds`` are profiled, up to ``tries``
    times; a profile that stays blind is None (a ``profiler_blind``
    line)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    for k in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(rounds):
                step(first + k * rounds + i)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if any(e.device_type == cuda for e in prof.key_averages()):
            return prof, wall_ms
    emit({"phase": "profiler_blind", "tries": tries, "rounds": rounds})
    return None, wall_ms


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
    """Registers, shared memory and spills of every kernel (K1, K3, B8, B4,
    the softmax pass, K4; B8's main-path kernels with their dynamic shared
    memory per CTA), and whether K1's shared adds compile to native adds or
    a compare-and-swap loop."""
    from xgboost_ray_tpu_torch.ops import _build
    from xgboost_ray_tpu_torch.ops import predict as PR

    paths = _build.build_all()
    report = {}
    for stem in ("histogram", "partition", "predict", "walk", "softmax",
                 "objective"):
        if stem in paths:  # walk, softmax, objective: not in older trees
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
        ulps4 = int((bits(ghk).long() - bits(ghp).long()).abs().max())
        check(torch.equal(bits(mk), bits(mp)), "K4 margin update differs")
        if hasattr(O, "k4_plan"):  # the CUDA K4: bitwise its plain version
            check(ulps4 == 0, f"K4 gradients {ulps4} ulps from the plain "
                              f"version's")
        else:  # an older tree's Triton K4
            check(err4 <= 1e-6, f"K4 gradients beyond 1e-6 ({err4})")
        rel = float(((sk4 - sp4).abs() / sp4.abs().clamp(min=1e-12)).max())
        check(rel <= 1e-5, f"K4 metric sums beyond 1e-5 relative ({rel})")
        res[tag] = {"K1": err1, "K1root": err1r, "K1deq": err1d, "K2": err2,
                    "K2level": err2l, "K2leaf": 0.0, "K3": 0.0,
                    "K3leaf": 0.0, "K4": err4}
        emit({"phase": "kernel_vs_plain", "gh": tag, "max_abs_err": res[tag],
              "k4_gradient_ulps": ulps4, "k4_partials_rel": rel})

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
        }
        # K4 with the L2 flushed by a write (device_ms) and by a read, and
        # warm; its host time a call is taken last, below
        k4 = lambda: O.round_update(mk, rv, label, weight, True)  # noqa: E731
        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        dev_ms["K4"] = profiled_ms(lambda: (flush.zero_(), k4()))
        k4_more = {"device_ms_read_flush": read_flushed_ms(k4),
                   "device_ms_l2_warm": profiled_ms(k4),
                   # every kernel of a call (a Triton K4's sum kernel too)
                   "call_device_ms_l2_warm": device_ms(k4, every=True),
                   "gradient_ulps": ulps4, "partials_rel": rel}
        del flush
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
        # last: its 1,000 calls change the margins K4 updates in place
        records["K4"].update(k4_more, host_us=host_call_us(k4))
        emit({"phase": "k4_gh_mode", **{k: records["K4"][k] for k in (
            "ms", "host_us", "device_ms", "device_ms_read_flush",
            "device_ms_l2_warm", "call_device_ms_l2_warm", "plain_ms",
            "bound_ms", "gradient_ulps", "partials_rel")}})
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
    at set-up; K2's bare search is off the path; B4 and K4's eval mode only
    with a held-out eval set (``evals_expect``)."""
    return {"K1": rounds * (depth + 1), "K1deq": rounds * (depth + 1),
            "K2": 0, "K2level": rounds * depth,
            "K2leaf": rounds, "K3": rounds * depth, "K3leaf": rounds,
            "K4": rounds + 1, "B4": 0, "K4eval": 0, "SMX": 0, "SMXeval": 0}


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
    from xgboost_ray_tpu_torch.engine import (
        kernel_launches,
        reset_kernel_launches,
    )
    from xgboost_ray_tpu_torch.matrix import RayShardingMode, combine_data

    dm = xrt.RayDMatrix(x, y)
    evals_result, extra = {}, {}
    keep = _KeepEngine()
    reset_kernel_launches()
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
    launches = kernel_launches()
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
    figure is kept as ``device_idle_share_profiled``). A profile that stays
    blind (``profile_steps``) leaves the device figures None."""
    import torch

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
    prof, wall_ms = profile_steps(engine.step, 1, rounds)
    cuda = torch.autograd.DeviceType.CUDA
    kern = {}
    syncs = 0  # host waits on the card: scalar reads, stream/device syncs
    for e in (prof.key_averages() if prof else []):
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
                 for e in (prof.events() if prof else [])
                 if e.device_type == cuda
                 and e.name.startswith("xrt_split_level_kernel"))
    by_level = ([float(np.mean([t for _, t in lvl[d::depth]]))
                 for d in range(depth)] if len(lvl) == rounds * depth else None)
    device_ms = sum(v[0] for v in kern.values())
    blind = prof is None
    launches = sum(v[1] for v in kern.values())
    kernels = sum(v[1] for k, v in kern.items()
                  if not k.startswith(("Memcpy", "Memset")))
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:20]
    out = {"phase": "profile", "rows": int(x.shape[0]), "rounds": rounds,
           "round_ms_unprofiled": round_ms,
           "device_ms_per_round": None if blind else device_ms / rounds,
           "cuda_launches_per_round": None if blind else launches / rounds,
           "kernel_launches_per_round": None if blind else kernels / rounds,
           "host_syncs_per_round": None if blind else syncs / rounds,
           "split_level_us_by_level": by_level,
           "device_idle_share": (None if round_ms is None or blind else
                                 max(0.0, 1.0 - device_ms / rounds / round_ms)),
           "wall_ms_per_round_profiled": wall_ms / rounds,
           "device_idle_share_profiled": (
               None if blind else max(0.0, 1.0 - device_ms / wall_ms)),
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
    """The main path's configuration on a slice, on the card and on the CPU
    twice: with the f32 sums of the JAX package (the first tree equal,
    logloss within 1e-5, margins within 1e-3) and summing in the card's
    fixed point (``_cpu_fixed_point``), where the card's model must be the
    CPU's: dumps equal, final margins bitwise."""
    import xgboost_ray_tpu_torch as xrt

    params = {"objective": "binary:logistic", "eval_metric": ["logloss"]}
    out = {}
    for device, fixed in (("cuda", False), ("cpu", False), ("cpu", True)):
        seen = {}

        class Keep:
            def after_iteration(self, engine, i, res):
                seen["engine"] = engine

        dm = xrt.RayDMatrix(x, y)
        ev = {}
        with _cpu_fixed_point(fixed):
            bst = xrt.train(params, dm, rounds, evals=[(dm, "train")],
                            evals_result=ev, device=device,
                            callbacks=[Keep()],
                            ray_params=xrt.RayParams(num_actors=1))
        out[device, fixed] = (bst, ev["train"]["logloss"],
                              seen["engine"].get_margins()[:, 0])
    (bg, llg, mg), (bc, llc, mc) = out["cuda", False], out["cpu", False]
    bx, llx, mx = out["cpu", True]
    fixed_point = {"dump_equal": bg.get_dump() == bx.get_dump(),
                   "margins_bitwise": same_bits(mg, mx),
                   "logloss_cpu_fixed_point": llx,
                   "logloss_max_abs_diff": float(np.max(np.abs(
                       np.array(llg) - np.array(llx)))),
                   "margin_max_abs_diff": float(np.max(np.abs(mg - mx)))}
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
          "margin_max_abs_diff": dm_, "logloss_card": llg, "logloss_cpu": llc,
          "cpu_fixed_point": fixed_point})
    check(not diff, f"first tree differs between card and CPU in {diff}")
    check(dll <= 1e-5, f"per-round logloss differs by {dll} > 1e-5")
    check(dm_ <= 1e-3, f"final margins differ by {dm_} > 1e-3")
    check(fixed_point["dump_equal"] and fixed_point["margins_bitwise"],
          f"the card's model is not the CPU path's summing in the card's "
          f"fixed point: {fixed_point}")
    return {"logloss": dll, "margin": dm_, "cpu_fixed_point": fixed_point}


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
    # the softmax pass's transform mode after B8 (K-output values; absent
    # in a tree of the package from before it)
    out["SMXtransform"] = getattr(_softmax_transform(), "launches", 0)
    return out


def _softmax_transform():
    from xgboost_ray_tpu_torch.ops import objectives as O

    return getattr(O, "softmax_transform", None)


def reset_b8_counters():
    from xgboost_ray_tpu_torch.ops import predict as PR

    for fn in (PR.predict_margin, PR.predict_leaf_index):
        fn.launches = 0
        fn.launches_by_layout = dict.fromkeys(PR.LAYOUTS, 0)
        fn.launches_by_plan = dict.fromkeys(PR.PLANS, 0)
    PR.predict_margin.launches_by_mode = dict.fromkeys(("margin", "value"), 0)
    if _softmax_transform() is not None:
        _softmax_transform().launches = 0


def b8_expect(**counts):
    """B8's counters (and the softmax transform's) all 0 but ``counts``."""
    return {**dict.fromkeys((*B8_PLAN_ROWS.values(), "B8leaf", "B8other",
                             "B8value", "SMXtransform"), 0), **counts}


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


def _closed_loop(handle, x, clients, req_rows_max, warm_s, duration_s,
                 mid=None):
    """``clients`` threads send 1-``req_rows_max``-row value requests to
    ``handle``. After ``warm_s`` the clients are parked until every request
    is answered; the serve metrics and B8's counters are set to 0 and the
    clients resume for ``duration_s``, then are parked again and the
    counters read: every launch of the window is one of its batches.
    ``mid``, where given, is called half-way through the window. Returns
    (snapshot at the end of the window, snapshot once parked, launches,
    client errors)."""
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
        if mid is not None:
            time.sleep(duration_s / 2)
            mid()
            time.sleep(duration_s / 2)
        else:
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
        ms = device_ms(lambda: PR.predict_margin(fo, xd, base0=m0), iters=3,
                       blind="raise")
    except SmokeFailure as exc:
        ms, seen = None, str(exc)[:300]
    else:
        seen = "device time recorded"
    out = {"phase": "late_profile", "b8_margin_device_ms": ms,
           "profiler": seen}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 8: held-out eval sets (B4), early stopping, warm start, C2
# ---------------------------------------------------------------------------

#: the HIGGS protocol's test set: "the last 500,000 examples are used as a
#: test set" (UCI HIGGS description)
TEST_ROWS = 500_000


def evals_expect(rounds, depth):
    """Launches of a ``train()`` with one held-out eval set: the main
    path's, plus one B4 walk and one K4 eval-mode pass a round."""
    return {**train_expect(rounds, depth), "B4": rounds,
            "K4": 2 * rounds + 1, "K4eval": rounds}


def b4_work(tree, bins, depth, missing_bin):
    """(distinct 32-byte sectors of ``bins`` the walk reads, node visits)
    of one B4 walk on this data: the bytes and operations of its bound. A
    tree of [T, heap] fields is a launch over T trees: the sectors of all
    T walks together."""
    import torch

    n, f = bins.shape
    trees = ([type(tree)(*[a[t] for a in tree])
              for t in range(tree.feature.shape[0])]
             if tree.feature.dim() == 2 else [tree])
    rows = torch.arange(n, device=bins.device)
    addrs, visits = [], 0
    for tr in trees:
        idx = torch.zeros(n, dtype=torch.int64, device=bins.device)
        for _ in range(depth):
            live = ~tr.is_leaf[idx]
            feat = tr.feature[idx].clamp(0, f - 1).long()
            addrs.append(((rows * f + feat) * bins.element_size())[live] // 32)
            visits += int(live.sum())
            bv = bins.gather(1, feat[:, None])[:, 0].int()
            right = torch.where(bv == missing_bin, ~tr.default_left[idx],
                                bv > tr.split_bin[idx])
            idx = torch.where(live, 2 * idx + 1 + right.long(), idx)
    return int(torch.unique(torch.cat(addrs)).numel()), visits


def b4_mappings(forest, bins, depth, flush):
    """B4 on each mapping of its launch plan (``ops/grow.walk_plan``), each
    held bitwise against the plain version and timed (device time L2
    flushed and warm, events), beside the plan's own choice and the bytes a
    tiled walk reads (every byte of the bins, the row values written, the
    forest's 13 bytes a node). Empty for a tree of the package without
    launch plans (the first B4, one mapping)."""
    import torch

    from xgboost_ray_tpu_torch.ops import grow as G

    if not hasattr(G, "walk_plan"):
        return {}
    n, f = bins.shape
    t = forest.feature.shape[0] if forest.feature.dim() == 2 else 1
    heap = forest.feature.shape[-1]
    ref = G.predict_tree_binned_plain(forest, bins, depth, 256)
    tiled_bytes = n * f * bins.element_size() + t * n * 4 + t * heap * 13
    out = {"plan": G.walk_plan(f, bins.element_size(), t, depth)._asdict(),
           "tiled_bytes_read": tiled_bytes,
           "tiled_bytes_ms": bound_ms(tiled_bytes, 0)[0]}
    for mapping in G.WALK_MAPPINGS:
        plan = G.walk_plan(f, bins.element_size(), t, depth, mapping)

        def fn(plan=plan):
            return G.predict_tree_binned(forest, bins, depth, 256, plan=plan)

        check(torch.equal(bits(fn()), bits(ref)),
              f"B4 ({mapping} mapping) differs from its plain version")
        out[mapping] = {"shared_bytes": plan.shared_bytes,
                        "rows_per_tile": plan.rows_per_tile,
                        "trees_per_group": plan.trees_per_group,
                        "ms": cuda_ms(fn, iters=20),
                        "device_ms": profiled_ms(
                            lambda: (flush.zero_(), fn())),
                        "device_ms_read_flush": read_flushed_ms(fn),
                        "device_ms_l2_warm": profiled_ms(fn)}
    return out


def phase_evals(x, y, records, rounds=10, depth=6, es_rounds=30):
    """The HIGGS protocol with its test set: the first rows train, the last
    ``TEST_ROWS`` are ``evals=[(dtrain, "train"), (dtest, "test")]``. Round
    times without and with the test set in turns (without, with, with,
    without), each run's launches counted from 0 and checked exactly; B4
    bitwise against its plain version for every tree over the test rows
    and timed, K4's eval mode against its plain version and timed; the
    test margins within 1e-4 of ``booster.predict(x_test,
    output_margin=True)``; early stopping over ``es_rounds``; a warm start
    (5 + 5 rounds) against the uninterrupted run and against itself; and
    ROADMAP C2: a weighted sketch of every row twice and from two shards
    folded, bitwise the same cuts."""
    import torch

    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch.distributed import _KeepEngine
    from xgboost_ray_tpu_torch.engine import (
        kernel_launches,
        reset_kernel_launches,
    )
    from xgboost_ray_tpu_torch.ops import binning as BN
    from xgboost_ray_tpu_torch.ops import grow as G
    from xgboost_ray_tpu_torch.ops import objectives as O

    n_test = min(TEST_ROWS, x.shape[0] // 10)
    xt, yt, xv, yv = x[:-n_test], y[:-n_test], x[-n_test:], y[-n_test:]
    params = {"objective": "binary:logistic",
              "eval_metric": ["error", "logloss"],  # early stopping: logloss
              "max_depth": depth, "max_bin": 256}

    def run(n_rounds, held_out=True, **kw):
        dtrain = xrt.RayDMatrix(xt, yt)
        evals = [(dtrain, "train")]
        if held_out:
            evals.append((xrt.RayDMatrix(xv, yv), "test"))
        keep, ev, extra = _KeepEngine(), {}, {}
        reset_kernel_launches()
        torch.cuda.synchronize()
        bst = xrt.train(params, dtrain, n_rounds, evals=evals,
                        evals_result=ev, additional_results=extra,
                        callbacks=[keep], device="cuda:0",
                        ray_params=xrt.RayParams(num_actors=1), **kw)
        torch.cuda.synchronize()
        out = {"bst": bst, "ev": ev, "launches": kernel_launches(),
               "round_ms": [r * 1e3 for r in extra["round_times_s"]],
               "setup_s": extra["setup_time_s"], "engine": keep.engine,
               "margins": keep.engine.get_margins()[:, 0]}
        if held_out:
            out["test_margins"] = keep.engine.evals[1].margins.cpu().numpy()[:, 0]
        return out

    res = {"phase": "evals", "train_rows": int(xt.shape[0]),
           "test_rows": int(n_test), "rounds": rounds}
    from xgboost_ray_tpu_torch.ops import _build

    builds = _build.compile_count()
    timed = {False: [], True: []}
    for held_out in (False, True, True, False):
        r = run(rounds, held_out)
        check_launches(r["launches"], evals_expect(rounds, depth) if held_out
                       else train_expect(rounds, depth),
                       f"train() {'with' if held_out else 'without'} the "
                       f"test set")
        timed[held_out].append(r)
        if held_out and len(timed[True]) == 1:
            kept = r  # its engine: B4 and K4 are held and timed on it
        else:
            r.pop("engine")
    # kernel builds during the four runs (a tree with a Triton K4 compiles
    # its eval variant in the first run with the test set)
    res["kernel_builds_during_runs"] = _build.compile_count() - builds
    if hasattr(O, "k4_plan"):
        check(res["kernel_builds_during_runs"] == 0,
              f"{res['kernel_builds_during_runs']} kernel builds during "
              f"train() after the build phase")
    first, again = timed[True]
    check(first["bst"].get_dump() == again["bst"].get_dump()
          and same_bits(first["test_margins"], again["test_margins"])
          and first["ev"] == again["ev"],
          "train() with the test set twice gave other models, test margins "
          "or eval histories")
    ev = first["ev"]
    ll = ev["test"]["logloss"]
    check(all(np.isfinite(ll)) and ll[-1] < ll[0],
          f"test logloss does not fall: {ll}")
    pred = first["bst"].predict(xv, output_margin=True)
    margin_err = float(np.abs(first["test_margins"] - pred).max())
    check(margin_err <= 1e-4, f"test margins differ from the booster's "
                              f"predicted margins by {margin_err} > 1e-4")
    res.update(
        eval_history=ev, launches=first["launches"],
        expected=evals_expect(rounds, depth),
        round_ms_without_test=[r["round_ms"] for r in timed[False]],
        round_ms_with_test=[r["round_ms"] for r in timed[True]],
        round_ms_median_without_test=[float(np.median(r["round_ms"]))
                                      for r in timed[False]],
        round_ms_median_with_test=[float(np.median(r["round_ms"]))
                                   for r in timed[True]],
        first_round_ms_with_test=[r["round_ms"][0] for r in timed[True]],
        setup_s_with_test=[r["setup_s"] for r in timed[True]],
        test_margin_max_abs_diff_to_predict=margin_err)
    del timed, again

    # B4 and K4's eval mode against their plain versions, then timed, on
    # the kept run's test bins and trees
    engine = kept.pop("engine")
    es = engine.evals[1]
    err_b4 = 0.0
    for t, tree in enumerate(engine.trees):
        got = G.predict_tree_binned(tree, es.bins, depth, 256)
        ref = G.predict_tree_binned_plain(tree, es.bins, depth, 256)
        check(torch.equal(got.view(torch.int32), ref.view(torch.int32)),
              f"B4 differs from its plain version on tree {t}")
        err_b4 = max(err_b4, float((got - ref).abs().max()))
    tree = engine.trees[-1]
    walk = lambda: G.predict_tree_binned(tree, es.bins, depth, 256)  # noqa: E731
    # on the path the test set's 28 MB of bins and 10 MB of K4 inputs are
    # cold: the round before streamed ~0.6 GB of training bins through the
    # 50 MB L2. device_ms writes 64 MB between launches (a fill kernel,
    # which device_ms does not count); device_ms_l2_warm repeats the
    # launch on the same inputs
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    sectors, visits = b4_work(tree, es.bins, depth, 256)
    heap = tree.feature.shape[0]
    b4_bound = bound_ms(sectors * 32 + n_test * 4 + heap * 13, visits)
    records["B4"].update(
        launches=first["launches"]["B4"], max_abs_err=err_b4,
        ms=cuda_ms(walk, iters=20),
        device_ms=profiled_ms(lambda: (flush.zero_(), walk())),
        device_ms_read_flush=read_flushed_ms(walk),
        device_ms_l2_warm=profiled_ms(walk),
        plain_ms=cuda_ms(lambda: G.predict_tree_binned_plain(
            tree, es.bins, depth, 256), iters=3),
        bound_ms=b4_bound[0], bound_by=b4_bound[1], library_ms=None,
        mappings=b4_mappings(tree, es.bins, depth, flush),
        host_us=host_call_us(walk))
    value = walk()
    m0 = es.margins.view(-1).clone()
    mk, mp = m0.clone(), m0.clone()
    _, sk = O.round_update(mk, value, es.label, es.weight, True,
                           with_gh=False)
    _, sp = O.round_update_plain(mp, value, es.label, es.weight, True,
                                 with_gh=False)
    check(torch.equal(mk, mp), "K4's eval mode: margins differ")
    rel = float(((sk - sp).abs() / sp.abs().clamp_min(1e-30)).max())
    check(rel <= 1e-5, f"K4's eval mode: metric sums beyond 1e-5 ({rel})")
    k4e = lambda: O.round_update(mk, value, es.label, es.weight, True,  # noqa: E731
                                 with_gh=False)
    # margin, row value, label, weight read, margin written: 20 B a row
    k4_bound = bound_ms(n_test * 4 * 5, 45 * n_test)
    _kernel_record(
        records, "K4eval", k4e,
        lambda: O.round_update_plain(mp, value, es.label, es.weight, True,
                                     with_gh=False),
        k4_bound, flush, first["launches"]["K4eval"],
        float((sk - sp).abs().max()))
    records["K4eval"].update(partials_rel=rel,
                             call_device_ms_l2_warm=device_ms(k4e, every=True))
    res.update(b4_sectors=sectors, b4_visits=visits,
               b4_visits_per_row=visits / n_test,
               b4={k: records["B4"][k] for k in (
                   "ms", "host_us", "device_ms", "device_ms_read_flush",
                   "device_ms_l2_warm", "plain_ms", "bound_ms", "bound_by",
                   "mappings")},
               k4_eval={k: records["K4eval"][k] for k in (
                   "ms", "host_us", "device_ms", "device_ms_read_flush",
                   "device_ms_l2_warm", "call_device_ms_l2_warm", "plain_ms",
                   "bound_ms", "max_abs_err", "partials_rel")})
    del engine, es, tree, value, m0, mk, mp, walk, k4e, flush
    torch.cuda.empty_cache()

    # early stopping on the test logloss
    es_run = run(es_rounds, early_stopping_rounds=3)
    hist = es_run["ev"]["test"]["logloss"]
    best = es_run["bst"].best_iteration
    res["early_stopping"] = {"rounds_run": len(hist), "best_iteration": best,
                             "best_score": es_run["bst"].best_score,
                             "test_logloss": hist}
    check(best == int(np.argmin(hist)), f"best_iteration {best} is not the "
                                        f"argmin of the test logloss {hist}")
    check(len(hist) in (es_rounds, best + 4)
          and es_run["bst"].num_boosted_rounds() == len(hist),
          f"early stopping ran {len(hist)} rounds (best {best})")
    del es_run

    # warm start: half the rounds, then the rest from them, twice
    half = rounds // 2
    five = run(half)
    warm = [run(rounds - half, xgb_model=five["bst"]) for _ in range(2)]
    dump = warm[0]["bst"].get_dump()
    res["warm_start"] = {
        "trees": warm[0]["bst"].num_trees,
        "init_trees_equal_uninterrupted":
            dump[:half] == first["bst"].get_dump()[:half],
        "rerun_dump_equal": warm[1]["bst"].get_dump() == dump,
        "rerun_margins_bitwise": same_bits(warm[0]["margins"],
                                           warm[1]["margins"])
        and same_bits(warm[0]["test_margins"], warm[1]["test_margins"]),
        "margin_max_abs_diff_to_uninterrupted": float(
            np.abs(warm[0]["margins"] - first["margins"]).max()),
        "test_margin_max_abs_diff_to_uninterrupted": float(
            np.abs(warm[0]["test_margins"] - first["test_margins"]).max()),
        "test_logloss": warm[0]["ev"]["test"]["logloss"]}
    ws = res["warm_start"]
    check(ws["trees"] == rounds
          and warm[0]["bst"].num_boosted_rounds() == rounds,
          f"the warm start has {ws['trees']} trees, not {rounds}")
    check(ws["init_trees_equal_uninterrupted"],
          "the warm start's init trees differ from the uninterrupted run's")
    check(ws["rerun_dump_equal"] and ws["rerun_margins_bitwise"],
          "the warm start repeated gave another model or other margins")
    del five, warm, first, kept
    torch.cuda.empty_cache()

    # C2: the weighted sketch of every row, twice and from two shards
    rng = np.random.RandomState(1)
    w = rng.uniform(0.05, 3.0, x.shape[0]).astype(np.float32)
    xd, wd = torch.from_numpy(x).cuda(), torch.from_numpy(w).cuda()
    cuts = [BN.sketch_and_bin(xd, wd, 256)[1] for _ in range(2)]
    order = torch.cat([torch.arange(r, x.shape[0], 2, device="cuda")
                       for r in range(2)])
    cuts.append(BN.sketch_and_bin(xd[order], wd[order], 256)[1])
    mn, mx = BN.feature_min_max(xd)
    f32 = [BN.sketch_histogram(v, mn, mx, u) for v, u in
           ((xd, wd), (xd, wd), (xd[order], wd[order]))]
    res["c2"] = {
        "rows": int(x.shape[0]),
        "cuts_bitwise_rerun": same_bits(cuts[0].cpu().numpy(),
                                        cuts[1].cpu().numpy()),
        "cuts_bitwise_two_shards": same_bits(cuts[0].cpu().numpy(),
                                             cuts[2].cpu().numpy()),
        # the f32 sums the card took before (recorded, not checked)
        "f32_sketch_bitwise_rerun": bool(torch.equal(f32[0], f32[1])),
        "f32_sketch_bitwise_two_shards": bool(torch.equal(f32[0], f32[2])),
        "f32_cuts_bitwise_two_shards": bool(torch.equal(
            BN.cuts_from_sketch(mn, mx, f32[0], 256),
            BN.cuts_from_sketch(mn, mx, f32[2], 256)))}
    check(res["c2"]["cuts_bitwise_rerun"]
          and res["c2"]["cuts_bitwise_two_shards"],
          f"the weighted sketch's cuts moved: {res['c2']}")
    del xd, wd, order, cuts, f32
    torch.cuda.empty_cache()
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase 9: multiclass at Covertype's width (multi:softprob, K = 7)
# ---------------------------------------------------------------------------

#: UCI Covertype (Blackard & Dean): 581,012 rows x 54 features (10
#: continuous, then 4 wilderness-area and 40 soil-type one-hot columns), 7
#: classes of these counts
COVERTYPE_CLASS_COUNTS = (211_840, 283_301, 35_754, 2_747, 9_493, 17_367,
                          20_510)
COVERTYPE_ROWS = sum(COVERTYPE_CLASS_COUNTS)
#: the held-out rows: the last 116,202 (the first 464,810 train)
COVERTYPE_TEST = 116_202


def make_covertype_like(n_rows, seed=0):
    """Covertype's layout from a numpy seed: f32 [n_rows, 54] (10
    continuous columns at the data set's means and spreads, a 4-column
    wilderness one-hot and a 40-column soil one-hot, exactly one 1 in each
    group of every row) and f32 labels 0-6: the rows ranked by a seeded
    score of their features plus noise, cut into blocks of Covertype's
    class counts (scaled to ``n_rows``), so trees learn them."""
    rng = np.random.RandomState(seed)
    loc = np.array([2959, 156, 14, 269, 46, 2350, 212, 223, 143, 1980],
                   np.float32)
    scale = np.array([280, 112, 7.5, 212, 58, 1559, 27, 20, 38, 1324],
                     np.float32)
    z = rng.standard_normal((n_rows, 10)).astype(np.float32)
    wild = rng.choice(4, n_rows, p=[0.45, 0.05, 0.44, 0.06])
    soil = rng.choice(40, n_rows, p=rng.dirichlet(np.full(40, 0.5)))
    x = np.zeros((n_rows, 54), np.float32)
    x[:, :10] = z * scale + loc
    x[np.arange(n_rows), 10 + wild] = 1.0
    x[np.arange(n_rows), 14 + soil] = 1.0
    score = (z @ rng.standard_normal(10).astype(np.float32)
             + rng.standard_normal(4)[wild] + rng.standard_normal(40)[soil]
             + 0.5 * rng.standard_normal(n_rows))
    counts = np.floor(np.array(COVERTYPE_CLASS_COUNTS) * n_rows
                      / sum(COVERTYPE_CLASS_COUNTS)).astype(np.int64)
    counts[np.argmax(counts)] += n_rows - counts.sum()
    order = np.argsort(score, kind="stable")
    y = np.empty(n_rows, np.float32)
    start = 0
    for c in rng.permutation(7):
        y[order[start:start + counts[c]]] = c
        start += counts[c]
    return x, y


class _cpu_fixed_point:
    """With ``on``, a ``train()`` on the CPU sums K1's histograms in the
    card's int64 fixed point (``build_histogram_fixed_plain``, its
    dequantise step's plain version, the round's scales from
    ``quant_scales``) instead of the f32 sums of the JAX package."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        if not self.on:
            return self
        from xgboost_ray_tpu_torch import engine as E
        from xgboost_ray_tpu_torch.ops import grow as G
        from xgboost_ray_tpu_torch.ops import histogram as H

        def fixed(bins, gh, rows, seg, n_nodes, nbt, with_hist=True,
                  qscale=None):
            return H.build_histogram_fixed_plain(bins, gh, rows, seg, n_nodes,
                                                 nbt, qscale, with_hist)

        def scales(engine):
            return H.quant_scales(engine.gh, engine.n_global, engine.coll.max)

        self.saved = [(G, "build_histogram", G.build_histogram),
                      (G, "dequantize", G.dequantize),
                      (E.TorchEngine, "_scales", E.TorchEngine._scales)]
        G.build_histogram, G.dequantize = fixed, H.dequantize_plain
        E.TorchEngine._scales = scales
        return self

    def __exit__(self, *exc):
        for obj, name, value in getattr(self, "saved", ()):
            setattr(obj, name, value)


def multiclass_expect(rounds, depth, k, held_out):
    """Launches of a ``train()`` of K classes: per tree the binary path's
    (``train_expect`` over rounds x K trees), one training-mode softmax
    pass a round and round 0's in place of K4; with a held-out set one B4
    launch over the round's K trees and one eval-mode pass a round."""
    out = {**train_expect(rounds * k, depth), "K4": 0, "SMX": rounds + 1}
    if held_out:
        out.update(B4=rounds, SMX=2 * rounds + 1, SMXeval=rounds)
    return out


def read_flushed_ms(fn, iters=10):
    """``fn``'s device time with the L2 flushed by reading 64 MB between
    launches. ``device_ms`` flushes by writing 64 MB (``zero_``), which
    leaves the L2 full of dirty lines that the kernel's own traffic then
    writes back to device memory; a read leaves clean lines, so this is
    the kernel's cold time without that write-back."""
    import torch

    buf = torch.ones(16 << 20, dtype=torch.float32, device="cuda")
    return profiled_ms(lambda: (buf.sum(), fn()), iters=iters)


#: K4 variants timed by ``--k4-variants``: edits of ``csrc/objective.cu``
#: (old text, new text, how many times the old text occurs)
K4_VARIANTS = {
    "built": [],
    # the CTAs' quadruples left in the partials: no ticket, no last CTA
    "no_final_sum": [(
        "    last = xrt_ticket(a.ticket, gridDim.x - 1) == gridDim.x - 1;",
        "    last = false;", 1)],
    # evict-first loads of the read-once inputs (row value, label, weight)
    "streaming_loads": [("__ldg(", "__ldcs(", 6)],
    # evict-first stores of the margins and the gradients
    "streaming_stores": [
        ("    reinterpret_cast<float4*>(a.margin)[q] = mo;",
         "    __stcs(reinterpret_cast<float4*>(a.margin) + q, mo);", 1),
        ("      gh[l] = stage[l];\n      gh[32 + l] = stage[32 + l];",
         "      __stcs(gh + l, stage[l]);\n"
         "      __stcs(gh + 32 + l, stage[32 + l]);", 1)],
}


def phase_k4_variants(n_eval=500_000, n_gh=11_000_000):
    """K4 as built against edits of its source (``K4_VARIANTS``), each
    compiled by ``nvcc`` as the package builds it and launched directly, in
    turns (every variant, then every variant in reverse order): the eval
    mode over HIGGS's 500,000 test rows and the gh mode over 11M rows,
    device us with the L2 flushed by a write (W), by a read (R) and warm.
    Margins and gradients must be bitwise the built kernel's, and the
    partials too where a variant still sums them. A measurement only: the
    package launches the kernel as built."""
    import ctypes

    import torch
    from xgboost_ray_tpu_torch.ops import _build
    from xgboost_ray_tpu_torch.ops import objectives as O

    with open(os.path.join(_build.CSRC_DIR, "objective.cu")) as f:
        src = f.read()
    vdir = os.path.join(_build.BUILD_DIR, "k4_variants")
    os.makedirs(vdir, exist_ok=True)
    procs = {}
    for name, edits in K4_VARIANTS.items():
        text = src
        for old, new, count in edits:
            check(text.count(old) == count,
                  f"K4 variant {name}: {old!r} occurs {text.count(old)} "
                  f"times, not {count}")
            text = text.replace(old, new)
        cu = os.path.join(vdir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
             "-o", os.path.join(vdir, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        out = proc.communicate()[0].decode(errors="replace")
        check(proc.returncode == 0, f"K4 variant {name}: nvcc failed: {out}")
        ptxas[name] = list(dict.fromkeys(
            ln.split(":", 1)[-1].strip() for ln in out.splitlines()
            if "registers" in ln or "spill" in ln))
        lib = ctypes.CDLL(os.path.join(vdir, f"{name}.so"))
        lib.xrt_k4.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.xrt_k4.restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda", 0)
    stream = _build.stream_ptr(dev)
    ticket, part = O._k4_workspace(0, stream)
    sms = O._k4_sms(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rbuf = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    res = {"card": CARD, "ptxas": ptxas}
    for mode, n in (("eval", n_eval), ("gh", n_gh)):
        m0 = torch.randn(n, device=dev, generator=g)
        rv = torch.randn(n, device=dev, generator=g) * 0.1
        label = (torch.rand(n, device=dev, generator=g) > 0.5).float()
        weight = torch.ones(n, device=dev)
        m = m0.clone()
        gh = (torch.empty((n, 2), device=dev) if mode == "gh" else None)
        out = torch.empty(4, dtype=torch.float64, device=dev)
        plan = O.k4_plan(n, sms)

        def call(lib, m=m, rv=rv, label=label, weight=weight, gh=gh,
                 out=out, plan=plan):
            a = O._k4_args(plan, m, rv, label, weight, gh, part, ticket, out,
                           True, 1.0)
            check(lib.xrt_k4(ctypes.byref(a), stream) == 0,
                  "K4 variant launch failed")

        ref = {}
        for name, lib in libs.items():
            m.copy_(m0)
            out.fill_(float("nan"))
            call(lib)
            got = (m.clone(), None if gh is None else gh.clone(), out.clone())
            if not ref:
                ref = {"m": got[0], "gh": got[1], "out": got[2]}
                continue
            check(torch.equal(bits(got[0]), bits(ref["m"])),
                  f"K4 variant {name} ({mode}): margins differ")
            if gh is not None:
                check(torch.equal(bits(got[1]), bits(ref["gh"])),
                      f"K4 variant {name} ({mode}): gradients differ")
            if name != "no_final_sum":
                check(torch.equal(got[2], ref["out"]),
                      f"K4 variant {name} ({mode}): partials differ")
        times = {name: [] for name in libs}
        order = list(libs) + list(reversed(libs))
        for name in order:
            lib = libs[name]
            times[name].append({
                "W": profiled_ms(lambda: (flush.zero_(), call(lib))),
                "R": profiled_ms(lambda: (rbuf.sum(), call(lib))),
                "warm": profiled_ms(lambda: call(lib))})
        res[mode] = {"rows": n, "grid": plan.grid, "times_ms": times}
        del m0, rv, label, weight, m, gh
    emit({"phase": "k4_variants", **res})
    return res


def _kernel_record(records, key, fn, plain, bound, flush, launches, err,
                   library=None):
    """Time ``fn`` (events, device time L2 flushed by a write and by a
    read, and warm) beside its plain version, then the host time a
    call (last: its 1,000 calls change the margins a pass updates in
    place, and with them its device time); fill ``records[key]``."""
    records[key].update(
        launches=launches, max_abs_err=err, ms=cuda_ms(fn, iters=20),
        device_ms=profiled_ms(lambda: (flush.zero_(), fn())),
        device_ms_read_flush=read_flushed_ms(fn),
        device_ms_l2_warm=profiled_ms(fn),
        plain_ms=cuda_ms(plain, iters=3), bound_ms=bound[0],
        bound_by=bound[1], library_ms=library, host_us=host_call_us(fn))


def phase_k1_k2_f54(n, records, launches):
    """K1 and K2's level step at Covertype's 54 features (K1 in two feature
    tiles of 27) and the phase's training rows, level 5 (32 nodes): K1
    bitwise against its fixed-point plain version, K2 bitwise against its
    plain version, both timed."""
    import torch

    from xgboost_ray_tpu_torch.ops import histogram as H
    from xgboost_ray_tpu_torch.ops import split as S
    from xgboost_ray_tpu_torch.ops.grow import empty_tree

    f, nbt, n_nodes = 54, 257, 32
    bins, gh, order, seg = level_inputs(n, f, n_nodes, 9, False)
    qs = H.quant_scales(gh, n)
    err1, _ = hold_k1(bins, gh, order, seg, n_nodes, nbt, qs, False,
                      "level 5, F = 54")
    hp, _ = H.build_histogram_plain(bins, gh, order, seg, n_nodes, nbt)
    g2 = torch.Generator(device="cuda").manual_seed(19)
    level = dict(
        hist=hp[0::2].contiguous(), prev_hist=hp[0::2] + hp[1::2],
        small_is_right=torch.rand(16, generator=g2, device="cuda") < 0.5,
        active=torch.arange(32, device="cuda") % 13 != 5)
    cuts = torch.sort(torch.randn(f, nbt - 2, generator=g2, device="cuda"),
                      dim=1).values
    fhm = torch.arange(f, device="cuda") % 3 != 0
    p = S.SplitParams()
    rec_k = S.TreeRecords(empty_tree(127, "cuda"), cuts, fhm, p)
    rec_p = S.TreeRecords(empty_tree(127, "cuda"), cuts, fhm, p)
    lk = S.split_level(**level, rec=rec_k)
    lp = S.split_level_plain(**level, rec=rec_p)
    torch.cuda.synchronize()
    pairs = ([(getattr(lk.splits, k), getattr(lp.splits, k))
              for k in lk.splits._fields]
             + [(getattr(lk, k), getattr(lp, k))
                for k in ("node_value", "state", "active", "hist")]
             + list(zip(rec_k.tree, rec_p.tree)))
    check(all(torch.equal(bits(a), bits(b)) for a, b in pairs),
          "K2 level step at F = 54 not bitwise equal to its plain version")
    flat = H.flat_bucket_ids(bins, order, seg, n_nodes, nbt)
    src = H.quantize_gh(gh[order.long()], qs)[:, None, :].expand(
        n, f, 2).reshape(-1, 2)
    out = torch.zeros((n_nodes * f * nbt, 2), dtype=torch.int64,
                      device="cuda")
    lib_k1 = cuda_ms(lambda: out.index_add_(0, flat, src), iters=3)
    del flat, src, out
    hist_bytes = n_nodes * f * nbt * 2 * 4
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    _kernel_record(
        records, "K1f54",
        lambda: H.build_histogram(bins, gh, order, seg, n_nodes, nbt,
                                  qscale=qs),
        lambda: H.build_histogram_fixed_plain(bins, gh, order, seg, n_nodes,
                                              nbt, qs),
        bound_ms(n * f * 2 + n * 4 + n * 8 + 2 * hist_bytes + n_nodes * 16,
                 2 * n * f + 4 * n), flush, launches["K1"], err1, lib_k1)
    _kernel_record(
        records, "K2levelf54", lambda: S.split_level(**level, rec=rec_k),
        lambda: S.split_level_plain(**level, rec=rec_p),
        bound_ms(2 * hist_bytes + 16 + 32 + 32 * (4 + 38),
                 n_nodes * f * (3 * nbt + 30 * (nbt - 2))),
        flush, launches["K2level"], float((lk.hist - lp.hist).abs().max()))
    del bins, gh, order, seg, hp, level, flush
    torch.cuda.empty_cache()


def hold_softmax_update(m0, rv, lab, w, with_gh, what):
    """The softmax pass's training (``with_gh``) or eval mode on copies of
    the margins ``m0`` against its plain version on the same card tensors:
    margins and gradients bitwise (0 ulps), partial sums within 1e-5
    relative. Returns (max abs err, partials' relative err, ulps)."""
    import torch

    from xgboost_ray_tpu_torch.ops import objectives as O

    mk, mp = m0.clone(), m0.clone()
    ghk, sk = O.softmax_update(mk, rv, lab, w, with_gh)
    ghp, sp = O.softmax_update_plain(mp, rv, lab, w, with_gh)
    torch.cuda.synchronize()
    check(torch.equal(bits(mk), bits(mp)), f"softmax pass ({what}): "
                                           f"margins differ")
    rel = float(((sk - sp).abs() / sp.abs().clamp_min(1e-30)).max())
    check(rel <= 1e-5, f"softmax pass ({what}): partial sums beyond "
                       f"1e-5 relative ({rel})")
    err = float((sk - sp).abs().max())
    ulps = 0
    if with_gh:
        ulps = int((bits(ghk).long() - bits(ghp).long()).abs().max())
        err = max(err, float((ghk - ghp).abs().max()))
        check(ulps == 0, f"softmax pass ({what}): gradients {ulps} ulps "
                         f"from the plain version's")
    return err, rel, ulps


def phase_multiclass(records, rounds=10, depth=6, es_rounds=30,
                     cmp_rows=50_000, cmp_rounds=3):
    """Covertype's configuration: ``multi:softprob``, K = 7, depth 6, 256
    bins, ``eval_metric`` merror then mlogloss, 464,810 rows train and the
    last 116,202 are the test set. ``train()`` without and with the test
    set in turns (without, with, with, without), each run's launches
    counted from 0 and checked exactly; determinism (the two runs with the
    test set, and a run with the rows in two shards folded, equal dumps and
    bitwise margins); the test mlogloss falls and the test margins equal
    ``booster.predict(x_test, output_margin=True)`` within 1e-4; the
    softmax pass (each mode) and B4 over a round's 7 trees against their
    plain versions on the phase's own tensors, timed; K1 and K2 at 54
    features; a profile of two rounds; ``predict()`` over every row
    (values bitwise the plain transform of B8's margins, rows summing to
    1; ``multi:softmax`` the argmax classes); a server of the model
    (probes bitwise, no build after warmup, a short closed loop with no
    client error); early stopping on the test mlogloss; a 5 + 5 warm
    start twice; the card against the CPU path on ``cmp_rows`` rows."""
    import torch

    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch import serve
    from xgboost_ray_tpu_torch.distributed import _KeepEngine
    from xgboost_ray_tpu_torch.engine import (
        kernel_launches,
        reset_kernel_launches,
    )
    from xgboost_ray_tpu_torch.matrix import RayShardingMode, combine_data
    from xgboost_ray_tpu_torch.ops import grow as G
    from xgboost_ray_tpu_torch.ops import objectives as O

    k = 7
    t_phase = time.perf_counter()
    x, y = make_covertype_like(COVERTYPE_ROWS, seed=0)
    xt, yt = x[:-COVERTYPE_TEST], y[:-COVERTYPE_TEST]
    xv, yv = x[-COVERTYPE_TEST:], y[-COVERTYPE_TEST:]
    n_train = xt.shape[0]
    params = {"objective": "multi:softprob", "num_class": k,
              "eval_metric": ["merror", "mlogloss"],  # stops on mlogloss
              "max_depth": depth, "max_bin": 256}

    def run(n_rounds, held_out=True, actors=1, rows=None, device="cuda:0",
            **kw):
        xr, yr = (xt, yt) if rows is None else (xt[:rows], yt[:rows])
        dtrain = xrt.RayDMatrix(xr, yr)
        evals = [(dtrain, "train")]
        if held_out:
            evals.append((xrt.RayDMatrix(xv, yv), "test"))
        keep, ev, extra = _KeepEngine(), {}, {}
        reset_kernel_launches()
        if device != "cpu":
            torch.cuda.synchronize()
        bst = xrt.train(params, dtrain, n_rounds, evals=evals,
                        evals_result=ev, additional_results=extra,
                        callbacks=[keep], device=device,
                        ray_params=xrt.RayParams(num_actors=actors), **kw)
        if device != "cpu":
            torch.cuda.synchronize()
        launches = kernel_launches()
        m = keep.engine.get_margins()
        sizes = [len(range(r, xr.shape[0], actors)) for r in range(actors)]
        out = {"bst": bst, "ev": ev, "launches": launches,
               "round_ms": [r * 1e3 for r in extra["round_times_s"]],
               "setup_s": extra["setup_time_s"], "engine": keep.engine,
               "margins": combine_data(RayShardingMode.INTERLEAVED,
                                       np.split(m, np.cumsum(sizes)[:-1]))}
        if held_out:
            out["test_margins"] = keep.engine.evals[1].margins.cpu().numpy()
        return out

    res = {"phase": "multiclass", "rows": int(COVERTYPE_ROWS),
           "train_rows": int(n_train), "test_rows": int(COVERTYPE_TEST),
           "features": int(x.shape[1]), "classes": k, "rounds": rounds,
           "max_depth": depth, "class_counts": np.bincount(
               y.astype(np.int64), minlength=k).tolist()}
    timed = {False: [], True: []}
    for held_out in (False, True, True, False):
        r = run(rounds, held_out)
        check_launches(r["launches"],
                       multiclass_expect(rounds, depth, k, held_out),
                       f"multiclass train() {'with' if held_out else 'without'}"
                       f" the test set")
        check(r["bst"].num_trees == rounds * k,
              f"{r['bst'].num_trees} trees, not {rounds * k}")
        timed[held_out].append(r)
        if held_out and len(timed[True]) == 1:
            kept = r
        else:
            r.pop("engine")
    first, again = timed[True]
    folded = run(rounds, held_out=False, actors=2)
    folded.pop("engine")
    base = timed[False][0]
    det = {"dump_equal_rerun": first["bst"].get_dump()
           == again["bst"].get_dump(),
           "margins_bitwise_rerun": same_bits(first["margins"],
                                              again["margins"])
           and same_bits(first["test_margins"], again["test_margins"]),
           "evals_equal_rerun": first["ev"] == again["ev"],
           "dump_equal_two_shards": folded["bst"].get_dump()
           == base["bst"].get_dump(),
           "margins_bitwise_two_shards": same_bits(folded["margins"],
                                                   base["margins"]),
           "dump_equal_with_and_without_test_set": first["bst"].get_dump()
           == base["bst"].get_dump()}
    res["determinism"] = det
    check(all(det.values()), f"multiclass determinism: {det}")
    ev = first["ev"]
    ll = ev["test"]["mlogloss"]
    check(all(np.isfinite(ll)) and ll[-1] < ll[0],
          f"test mlogloss does not fall: {ll}")
    pred = first["bst"].predict(xv, output_margin=True)
    margin_err = float(np.abs(first["test_margins"] - pred).max())
    check(margin_err <= 1e-4, f"multiclass test margins differ from the "
                              f"booster's predicted margins by {margin_err}")
    res.update(
        eval_history=ev, launches=first["launches"],
        expected=multiclass_expect(rounds, depth, k, True),
        round_ms_without_test=[r["round_ms"] for r in timed[False]],
        round_ms_with_test=[r["round_ms"] for r in timed[True]],
        round_ms_median_without_test=[float(np.median(r["round_ms"]))
                                      for r in timed[False]],
        round_ms_median_with_test=[float(np.median(r["round_ms"]))
                                   for r in timed[True]],
        setup_s=[r["setup_s"] for r in timed[False] + timed[True]],
        test_margin_max_abs_diff_to_predict=margin_err)
    bst = first["bst"]
    del timed, again, folded, base

    # the softmax pass (each mode) and B4 over a round's 7 trees against
    # their plain versions on the kept run's tensors, then timed
    engine = kept.pop("engine")
    es = engine.evals[1]
    err_b4 = 0.0
    for t, forest in enumerate(engine.trees):
        got = G.predict_tree_binned(forest, es.bins, depth, 256)
        ref = G.predict_tree_binned_plain(forest, es.bins, depth, 256)
        check(got.shape == (k, COVERTYPE_TEST)
              and torch.equal(bits(got), bits(ref)),
              f"B4 over round {t}'s {k} trees differs from its plain version")
        err_b4 = max(err_b4, float((got - ref).abs().max()))
    forest = engine.trees[-1]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    sectors, visits = b4_work(forest, es.bins, depth, 256)
    heap = forest.feature.shape[1]
    _kernel_record(
        records, "B4k", lambda: G.predict_tree_binned(forest, es.bins, depth,
                                                      256),
        lambda: G.predict_tree_binned_plain(forest, es.bins, depth, 256),
        bound_ms(sectors * 32 + COVERTYPE_TEST * 4 * k + k * heap * 13,
                 visits), flush, first["launches"]["B4"], err_b4)
    records["B4k"]["mappings"] = b4_mappings(forest, es.bins, depth, flush)
    rv_test = G.predict_tree_binned(forest, es.bins, depth, 256)
    rv_train = G.predict_tree_binned(forest, engine.bins, depth, 256)
    label, weight = engine.label, engine.weight

    m_train = engine.margins.clone()
    err_t, rel_t, ulps_t = hold_softmax_update(
        m_train, rv_train, label, weight, True, "training mode")
    err_e, rel_e, _ = hold_softmax_update(es.margins, rv_test, es.label,
                                          es.weight, False, "eval mode")
    n_tr, n_te = n_train, COVERTYPE_TEST
    # bytes: margins read and written, the K row values, label and weight
    # read, the [K, N, 2] gradients written; ~64 flops a (row, class)
    _kernel_record(
        records, "SMX", lambda: O.softmax_update(m_train, rv_train, label,
                                                 weight),
        lambda: O.softmax_update_plain(m_train.clone(), rv_train, label,
                                       weight),
        bound_ms(n_tr * (12 * k + 8 + 8 * k), 64 * k * n_tr), flush,
        first["launches"]["SMX"], err_t)
    m_test = es.margins.clone()
    _kernel_record(
        records, "SMXeval", lambda: O.softmax_update(
            m_test, rv_test, es.label, es.weight, with_gh=False),
        lambda: O.softmax_update_plain(m_test.clone(), rv_test, es.label,
                                       es.weight, with_gh=False),
        bound_ms(n_te * (12 * k + 8), 40 * k * n_te), flush,
        first["launches"]["SMXeval"], err_e)
    emit({"phase": "multiclass_kernels", **{
        key: {f: records[key].get(f) for f in (
            "launches", "max_abs_err", "ms", "host_us", "device_ms",
            "device_ms_read_flush", "device_ms_l2_warm", "plain_ms",
            "bound_ms", "mappings")}
        for key in ("B4k", "SMX", "SMXeval")}})
    res["kernels"] = {"softmax_training_partials_rel": rel_t,
                      "softmax_training_gradient_ulps": ulps_t,
                      "softmax_eval_partials_rel": rel_e,
                      "b4_sectors": sectors, "b4_visits": visits,
                      "b4_visits_per_row_and_tree": visits / n_te / k}

    # a profile of two rounds with the test set: device time by kernel
    prof, wall_ms = profile_steps(engine.step, rounds, 2)
    kern, host = {}, {}
    for e in (prof.key_averages() if prof else []):
        if e.device_type != torch.autograd.DeviceType.CUDA:
            # host time by op (where a round's host time goes)
            host[e.key] = host.get(e.key, 0.0) + e.self_cpu_time_total / 2e3
            continue
        t = getattr(e, "self_device_time_total", None)
        t = e.self_cuda_time_total if t is None else t
        kern[e.key] = (kern.get(e.key, (0.0, 0))[0] + t / 1e3 / 2,
                       kern.get(e.key, (0.0, 0))[1] + e.count / 2)
    dev_round = sum(v[0] for v in kern.values())
    med_with = float(np.median(res["round_ms_median_with_test"]))
    blind = prof is None
    res["profile"] = {
        "device_ms_per_round": None if blind else dev_round,
        "cuda_launches_per_round": (
            None if blind else sum(v[1] for v in kern.values())),
        "round_ms_unprofiled": med_with,
        "device_idle_share": (
            None if blind else max(0.0, 1.0 - dev_round / med_with)),
        "wall_ms_per_round_profiled": wall_ms / 2,
        "top_kernels_ms_per_round": [
            [key[:80], v[0], v[1]] for key, v in
            sorted(kern.items(), key=lambda kv: -kv[1][0])[:16]],
        "host_ms_per_round": sum(host.values()),
        "top_host_ops_ms_per_round": [
            [key[:60], v] for key, v in
            sorted(host.items(), key=lambda kv: -kv[1])[:12]]}
    del engine, es, kept, m_train, m_test, rv_test, rv_train, label, weight
    del forest, flush
    torch.cuda.empty_cache()

    # K1 and K2 at 54 features
    phase_k1_k2_f54(n_train, records, first["launches"])

    # predict() over every row (num_actors=2), B8 and the softmax pass's
    # counters set to 0 just before and read just after
    rp = xrt.RayParams(num_actors=2)
    reset_b8_counters()
    t0 = time.perf_counter()
    values = xrt.predict(bst, xrt.RayDMatrix(x), ray_params=rp)
    value_s = time.perf_counter() - t0
    launches = b8_counters()
    chunks = predict_chunks(bst, x.shape[0], 4 * (x.shape[1] + 2 * k))
    expect = b8_expect(B8margin=chunks, SMXtransform=chunks)
    margins = bst.predict(x, output_margin=True)
    plain = O.softmax_transform_plain(torch.from_numpy(margins), True).numpy()
    row_sum_err = float(np.abs(values.astype(np.float64).sum(1) - 1).max())
    soft = xrt.RayXGBoostBooster.load_raw(bst.save_raw())
    soft.params.objective = "multi:softmax"
    classes = soft.predict(x)
    pred = {"rows": int(x.shape[0]), "trees": bst.num_trees,
            "predict_value_wall_s": value_s, "launches": launches,
            "expected": expect, "values_bitwise_plain_transform":
                same_bits(values, plain),
            "row_sum_max_abs_err": row_sum_err,
            "softmax_classes_are_argmax": bool(np.array_equal(
                classes, np.argmax(plain, axis=1).astype(np.float32)))}
    res["predict"] = pred
    check(values.shape == (x.shape[0], k), f"predict() gave {values.shape}")
    check(pred["values_bitwise_plain_transform"], "predicted values are not "
          "the plain transform of B8's margins bit for bit")
    check(row_sum_err <= 1e-6, f"probabilities sum to 1 within {row_sum_err}")
    check(pred["softmax_classes_are_argmax"], "multi:softmax classes are not "
          "the first argmax of the probabilities")
    check(launches == expect, f"predict() launches {launches}, expected "
                              f"{expect}")
    # the transform mode on every row's margins, timed (library yardstick:
    # torch.softmax, which the port never calls)
    md = torch.from_numpy(margins).cuda()
    got = O.softmax_transform(md, True)
    check(torch.equal(bits(got.cpu()), bits(torch.from_numpy(plain))),
          "softmax pass (transform mode) differs from its plain version")
    got_c = O.softmax_transform(md, False)
    check(torch.equal(got_c.cpu(), O.softmax_transform_plain(
        torch.from_numpy(margins), False)), "softmax pass (classes) differs")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    n_all = x.shape[0]
    _kernel_record(
        records, "SMXtransform", lambda: O.softmax_transform(md, True),
        lambda: O.softmax_transform_plain(md, True),
        bound_ms(n_all * 8 * k, 40 * k * n_all), flush,
        launches["SMXtransform"], 0.0,
        library=cuda_ms(lambda: torch.softmax(md, 1), iters=20))
    # the yardstick's device time, measured as the kernel's
    rbuf = torch.ones(16 << 20, dtype=torch.float32, device="cuda")
    records["SMXtransform"]["library_device_ms"] = {
        "write_flush": device_ms(lambda: (flush.zero_(), torch.softmax(md, 1)),
                                 only="softmax"),
        "read_flush": device_ms(lambda: (rbuf.sum(), torch.softmax(md, 1)),
                                only="softmax"),
        "l2_warm": device_ms(lambda: torch.softmax(md, 1), only="softmax")}
    del rbuf
    del md, got, got_c, flush, values, plain, margins, classes, soft
    torch.cuda.empty_cache()

    # a server of the model: probes bitwise, no build after warmup, a short
    # closed loop (every batch one B8 margin launch and one transform)
    handle = serve.create_server(bst, max_batch=256, max_delay_ms=2.0)
    builds0 = serve.compile_count()
    try:
        probe = _probe(handle, bst, xv[:37])
        snap, parked, slaunch, errors = _closed_loop(
            handle, xv, 8, 32, 0.5, 2.0)
        builds = serve.compile_count() - builds0
    finally:
        handle.shutdown()
    sexpect = b8_expect(B8serve=parked["batches"],
                        SMXtransform=parked["batches"])
    res["serve"] = {"probe_bitwise": probe, "builds_after_warmup": builds,
                    "client_errors": len(errors), "launches": slaunch,
                    "expected": sexpect,
                    **{kk: snap[kk] for kk in (
                        "requests", "batches", "qps", "mean_batch_rows",
                        "latency_p50_ms", "latency_p99_ms")}}
    check(all(probe.values()), f"multiclass serve probes not bitwise: {probe}")
    check(builds == 0, f"{builds} kernel builds after warmup")
    check(len(errors) == 0, f"{len(errors)} client errors: {errors[:3]}")
    check(slaunch == sexpect, f"serve launches {slaunch}, expected {sexpect}")

    # early stopping on the test mlogloss
    es_run = run(es_rounds, early_stopping_rounds=3)
    hist = es_run["ev"]["test"]["mlogloss"]
    best = es_run["bst"].best_iteration
    res["early_stopping"] = {"rounds_run": len(hist), "best_iteration": best,
                             "best_score": es_run["bst"].best_score,
                             "test_mlogloss": hist}
    check(best == int(np.argmin(hist)), f"best_iteration {best} is not the "
                                        f"argmin of the test mlogloss {hist}")
    check(len(hist) in (es_rounds, best + 4)
          and es_run["bst"].num_trees == k * len(hist),
          f"early stopping ran {len(hist)} rounds (best {best})")
    del es_run

    # a 5 + 5 warm start, twice
    half = rounds // 2
    five = run(half)
    warm = [run(rounds - half, xgb_model=five["bst"]) for _ in range(2)]
    dump = warm[0]["bst"].get_dump()
    ws = {"trees": warm[0]["bst"].num_trees,
          "init_trees_equal_uninterrupted":
              dump[:half * k] == bst.get_dump()[:half * k],
          "rerun_dump_equal": warm[1]["bst"].get_dump() == dump,
          "rerun_margins_bitwise": same_bits(warm[0]["margins"],
                                             warm[1]["margins"])
          and same_bits(warm[0]["test_margins"], warm[1]["test_margins"]),
          "margin_max_abs_diff_to_uninterrupted": float(
              np.abs(warm[0]["margins"] - first["margins"]).max())}
    res["warm_start"] = ws
    check(ws["trees"] == rounds * k, f"the warm start has {ws['trees']} trees")
    check(ws["init_trees_equal_uninterrupted"] and ws["rerun_dump_equal"]
          and ws["rerun_margins_bitwise"], f"multiclass warm start: {ws}")
    del five, warm, first
    torch.cuda.empty_cache()

    # the card against the CPU path on a cut of the rows. Phase 4's rule
    # (the first round's trees equal, per-round mlogloss within 1e-5,
    # margins within 1e-3) is held against the CPU path summing K1's
    # histograms in the card's fixed point (``build_histogram_fixed_plain``;
    # every other kernel's plain version as it is): there the whole model
    # must be the card's. The CPU path's own f32 sums (the JAX package's)
    # are recorded beside it: a rare class's trees split on gains below the
    # f32 sums' rounding, so their trees differ from the exact sums' while
    # the mlogloss stays within 1e-3.
    cmp = {}
    for device in ("cuda:0", "cpu-fixed", "cpu"):
        with _cpu_fixed_point(device == "cpu-fixed"):
            r = run(cmp_rounds, held_out=False, rows=cmp_rows,
                    device=device.replace("-fixed", ""))
        cmp[device] = (r["bst"], r["ev"]["train"]["mlogloss"], r["margins"])
    fields = ("feature", "split_bin", "default_left", "is_leaf")
    card = cmp["cuda:0"]
    res["cpu_vs_card"] = {"rows": cmp_rows, "rounds": cmp_rounds}
    for key, name in (("cpu-fixed", "cpu_fixed_point"), ("cpu", "cpu_f32")):
        bc, llc, mc = cmp[key]
        res["cpu_vs_card"][name] = {
            "first_round_trees_differ_in": [
                f for f in fields if not np.array_equal(
                    getattr(card[0].forest, f)[:k], getattr(bc.forest, f)[:k])],
            "dump_equal": card[0].get_dump() == bc.get_dump(),
            "mlogloss_max_abs_diff": float(np.max(np.abs(
                np.array(card[1]) - np.array(llc)))),
            "margin_max_abs_diff": float(np.max(np.abs(card[2] - mc))),
            "mlogloss_card": card[1], "mlogloss_cpu": llc}
    fx, f32 = res["cpu_vs_card"]["cpu_fixed_point"], res["cpu_vs_card"]["cpu_f32"]
    emit({"phase": "multiclass_cpu_vs_card", **res["cpu_vs_card"]})
    check(not fx["first_round_trees_differ_in"],
          f"the first round's trees differ between the card and the CPU "
          f"(fixed-point sums) in {fx['first_round_trees_differ_in']}")
    check(fx["mlogloss_max_abs_diff"] <= 1e-5,
          f"per-round mlogloss differs by {fx['mlogloss_max_abs_diff']}")
    check(fx["margin_max_abs_diff"] <= 1e-3,
          f"final margins differ by {fx['margin_max_abs_diff']} > 1e-3")
    check(f32["mlogloss_max_abs_diff"] <= 1e-3,
          f"per-round mlogloss of the CPU's f32 sums differs by "
          f"{f32['mlogloss_max_abs_diff']} > 1e-3")
    res["k33"] = phase_k33(xt)
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


def phase_k33(x, rows=10_000, rounds=3, depth=6, k=33):
    """``multi:softprob`` at K = 33 classes (the softmax pass's path above
    32 classes, whose class sum is the reference's window-32 tree) on the
    first ``rows`` rows of ``x``, labels a seeded score's 33 quantiles:
    ``train()`` on the card, launches checked, against the CPU path summing
    in the card's fixed point: there the whole model must be the card's
    (equal dumps, margins bitwise). Then the wide pass's four modes on the
    card run's own margins, labels and last round's row values, each
    bitwise its plain version on the same tensors (partial sums within
    1e-5 relative)."""
    import torch

    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch.distributed import _KeepEngine
    from xgboost_ray_tpu_torch.engine import (
        kernel_launches,
        reset_kernel_launches,
    )
    from xgboost_ray_tpu_torch.ops import grow as G
    from xgboost_ray_tpu_torch.ops import objectives as O

    rng = np.random.RandomState(33)
    xs = x[:rows]
    score = xs @ rng.standard_normal(xs.shape[1]).astype(np.float32) / (
        xs.std(0) + 1e-6).sum() + 0.2 * rng.standard_normal(rows)
    y = np.empty(rows, np.float32)
    y[np.argsort(score, kind="stable")] = np.arange(rows) * k // rows
    params = {"objective": "multi:softprob", "num_class": k,
              "eval_metric": ["merror", "mlogloss"], "max_depth": depth,
              "max_bin": 256}
    out, engines = {}, {}
    for device in ("cuda:0", "cpu"):
        keep, ev = _KeepEngine(), {}
        dm = xrt.RayDMatrix(xs, y)
        reset_kernel_launches()
        with _cpu_fixed_point(device == "cpu"):
            bst = xrt.train(params, dm, rounds, evals=[(dm, "train")],
                            evals_result=ev, callbacks=[keep], device=device,
                            ray_params=xrt.RayParams(num_actors=1))
        if device != "cpu":
            torch.cuda.synchronize()
        out[device] = (bst, ev["train"]["mlogloss"],
                       keep.engine.get_margins(), kernel_launches())
        engines[device] = keep.engine
    card, cpu = out["cuda:0"], out["cpu"]
    fields = ("feature", "split_bin", "default_left", "is_leaf")
    res = {"rows": rows, "classes": k, "rounds": rounds,
           "launches": card[3],
           "expected": multiclass_expect(rounds, depth, k, False),
           "first_round_trees_differ_in": [
               f for f in fields if not np.array_equal(
                   getattr(card[0].forest, f)[:k],
                   getattr(cpu[0].forest, f)[:k])],
           "dump_equal": card[0].get_dump() == cpu[0].get_dump(),
           "margins_bitwise": same_bits(card[2], cpu[2]),
           "mlogloss_card": card[1], "mlogloss_cpu_fixed_point": cpu[1],
           "mlogloss_max_abs_diff": float(np.max(np.abs(
               np.array(card[1]) - np.array(cpu[1])))),
           "margin_max_abs_diff": float(np.max(np.abs(card[2] - cpu[2])))}
    emit({"phase": "multiclass_k33", **res})
    check_launches(card[3], res["expected"], "multiclass train() at K = 33")
    check(not res["first_round_trees_differ_in"],
          f"K = 33: the first round's trees differ between the card and the "
          f"CPU (fixed-point sums) in {res['first_round_trees_differ_in']}")
    check(res["mlogloss_max_abs_diff"] <= 1e-5,
          f"K = 33: per-round mlogloss differs by "
          f"{res['mlogloss_max_abs_diff']}")
    check(res["margin_max_abs_diff"] <= 1e-3,
          f"K = 33: final margins differ by {res['margin_max_abs_diff']}")
    check(res["dump_equal"] and res["margins_bitwise"],
          "K = 33: the card's model is not the CPU path's (fixed-point "
          "sums): dumps equal "
          f"{res['dump_equal']}, margins bitwise {res['margins_bitwise']}")
    check(card[1][-1] < card[1][0], f"K = 33: mlogloss does not fall: "
                                    f"{card[1]}")

    # the wide pass on the card run's tensors: its margins plus the last
    # round's row values (B4 over its 33 trees) in training and eval mode,
    # then both transforms of the margins, each against its plain version
    eng = engines["cuda:0"]
    rv = G.predict_tree_binned(eng.trees[-1], eng.bins, depth, 256)
    wide = {}
    for with_gh, mode in ((True, "training"), (False, "eval")):
        err, rel, ulps = hold_softmax_update(
            eng.margins, rv, eng.label, eng.weight, with_gh,
            f"K = 33, {mode} mode")
        wide[mode] = {"max_abs_err": err, "partials_rel": rel,
                      "gradient_ulps": ulps}
    for prob, mode in ((True, "prob"), (False, "class")):
        got = O.softmax_transform(eng.margins, prob)
        ref = O.softmax_transform_plain(eng.margins, prob)
        check(torch.equal(bits(got), bits(ref)),
              f"softmax pass (K = 33, transform mode {mode}) differs from "
              f"its plain version")
        wide[mode] = {"bitwise": True}
    res["wide_pass"] = wide
    emit({"phase": "multiclass_k33_wide_pass", **wide})
    del engines, eng, rv
    return res


class HookRecorder:
    """A distributed callback recording ``(hook, rank)`` of every hook it
    receives (``after_round`` with the round's iteration); sent to the
    ranks of a world and returned by them."""

    def __init__(self):
        self.calls = []

    def on_init(self, actor, *args, **kwargs):
        self.calls.append(("on_init", actor.rank))

    def before_data_loading(self, actor, data, *args, **kwargs):
        self.calls.append(("before_data_loading", actor.rank))

    def after_data_loading(self, actor, data, *args, **kwargs):
        self.calls.append(("after_data_loading", actor.rank))

    def before_train(self, actor, *args, **kwargs):
        self.calls.append(("before_train", actor.rank))

    def after_round(self, actor, record, *args, **kwargs):
        self.calls.append(("after_round", actor.rank, record["iteration"]))

    def after_train(self, actor, result, *args, **kwargs):
        self.calls.append(("after_train", actor.rank))


def hook_order(rank, rounds):
    """The JAX package's hook order for one rank that loads one matrix."""
    return ([("on_init", rank), ("before_data_loading", rank),
             ("after_data_loading", rank), ("before_train", rank)]
            + [("after_round", rank, i) for i in range(rounds)]
            + [("after_train", rank)])


def custom_expect(rounds, depth, k=1, held_out=False):
    """Launches of a ``train()`` with a custom objective: the built-in
    run's tree kernels, and every round pass in its no-gradient mode (no
    set-up pass): K4 (or with K outputs the softmax pass) once a round over
    the training set, and once more over a held-out set."""
    passes = rounds * (2 if held_out else 1)
    out = {**train_expect(rounds * k, depth), "K4": 0, "K4eval": 0,
           "SMX": 0, "SMXeval": 0, "B4": rounds if held_out else 0}
    out.update({"SMX": passes, "SMXeval": passes} if k > 1
               else {"K4": passes, "K4eval": passes})
    return out


def _np_softmax(m):
    e = np.exp(m - m.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def sq_objective(y_true, y_pred):
    """A squared-error objective in numpy f32 (sklearn's convention)."""
    g = (y_pred - y_true).astype(np.float32)
    return g, np.ones_like(g)


def softmax_objective(preds, dtrain):
    """The softmax objective in numpy (``train(obj=...)``'s convention)."""
    p = _np_softmax(preds.astype(np.float64))
    y = np.eye(preds.shape[1])[dtrain.get_label().astype(np.int64)]
    return ((p - y).astype(np.float32),
            np.maximum(2.0 * p * (1.0 - p), 1e-16).astype(np.float32))


def mlogloss_metric(preds, dmat):
    """mlogloss in numpy f64 (``custom_metric``'s convention)."""
    m = preds.astype(np.float64)
    mx = m.max(axis=1, keepdims=True)
    lse = mx[:, 0] + np.log(np.exp(m - mx).sum(axis=1))
    y = dmat.get_label().astype(np.int64)
    return "my_mlogloss", float(np.mean(lse - m[np.arange(len(y)), y]))


def phase_facade(x, y, records, rounds=10, depth=6, es_rounds=30,
                 grid_rows=50_000, dev="cuda:0"):
    """Phase 10, the facade at full width: the sklearn estimators against
    ``train()`` on the HIGGS split (dumps equal, launches equal, predict /
    predict_proba / apply / feature importances from the booster, early
    stopping, the label encoding's time against the JAX module's per-row
    dict loop) and on Covertype's labels 1..7; a custom squared-error
    objective against ``reg:squarederror`` over every row (the same model
    bit for bit, no gradient-mode launch; K4's no-gradient mode at the
    training shape held against its plain version and timed); a custom
    softmax objective and mlogloss metric at Covertype's shape (the softmax
    pass's no-gradient mode held and timed); pickling; CSV (and Parquet
    where pyarrow imports) files of Covertype's test rows loaded centrally
    and by two gloo ranks, each rank's distributed callbacks' hooks in the
    JAX package's order; the tune report callback; and, where scikit-learn
    imports, ``clone`` and a ``GridSearchCV``."""
    import pickle
    import shutil
    import tempfile

    import pandas as pd
    import torch

    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch import distributed as D
    from xgboost_ray_tpu_torch import tune
    from xgboost_ray_tpu_torch.data_sources.csv import read_csv_file
    from xgboost_ray_tpu_torch.distributed import _KeepEngine
    from xgboost_ray_tpu_torch.engine import (
        kernel_launches,
        reset_kernel_launches,
    )
    from xgboost_ray_tpu_torch.ops import grow as G
    from xgboost_ray_tpu_torch.ops import objectives as O
    from xgboost_ray_tpu_torch.sklearn import (
        _SKLEARN_INSTALLED,
        RayXGBClassifier,
        RayXGBRegressor,
    )

    t_phase = time.perf_counter()
    res = {"phase": "facade", "sklearn_installed": _SKLEARN_INSTALLED,
           "rounds": rounds, "max_depth": depth}
    n_test = min(TEST_ROWS, x.shape[0] // 10)
    xt, yt, xv, yv = x[:-n_test], y[:-n_test], x[-n_test:], y[-n_test:]
    params = {"objective": "binary:logistic",
              "eval_metric": ["error", "logloss"], "max_depth": depth,
              "max_bin": 256}
    est_kw = dict(max_depth=depth, max_bin=256, device=dev)

    def counted(fn):
        """(fn(), its launches counted from 0, its wall seconds)."""
        reset_kernel_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, kernel_launches(), time.perf_counter() - t0

    def train_ref(p, xr, yr, n_rounds, evals_xy=None, **kw):
        dtrain = xrt.RayDMatrix(xr, yr)
        evals = [(dtrain, "train")]
        if evals_xy is not None:
            evals.append((xrt.RayDMatrix(*evals_xy), "test"))
        ev, extra = {}, {}
        bst = xrt.train(p, dtrain, n_rounds, evals=evals, evals_result=ev,
                        additional_results=extra, device=dev,
                        ray_params=xrt.RayParams(num_actors=1), **kw)
        return bst, ev, extra

    # 1. the binary classifier against train() with the test set
    (ref, ref_ev, ref_extra), ref_launches, ref_wall = counted(
        lambda: train_ref(params, xt, yt, rounds, (xv, yv)))
    t0 = time.perf_counter()
    classes, codes = np.unique(yt, return_inverse=True)
    unique_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loop = {c: i for i, c in enumerate(classes)}
    loop_codes = np.asarray([loop[v] for v in yt], dtype=np.float32)
    loop_s = time.perf_counter() - t0
    check(np.array_equal(codes.astype(np.float32), loop_codes),
          "np.unique's codes differ from the per-row dict loop's")
    del loop_codes
    clf = RayXGBClassifier(n_estimators=rounds,
                           eval_metric=["error", "logloss"], **est_kw)
    _, fit_launches, fit_wall = counted(
        lambda: clf.fit(xt, yt, eval_set=[(xv, yv)]))
    bst = clf.get_booster()
    check(bst.get_dump(with_stats=True) == ref.get_dump(with_stats=True),
          "RayXGBClassifier's model differs from train()'s")
    check(fit_launches == ref_launches,
          f"RayXGBClassifier.fit launched {fit_launches}, train() "
          f"{ref_launches}")
    check_launches(fit_launches, evals_expect(rounds, depth),
                   "RayXGBClassifier.fit")
    check(clf.evals_result()["validation_0"] == ref_ev["test"],
          "RayXGBClassifier's test history differs from train()'s")
    proba = clf.predict_proba(xv)
    value = bst.predict(xv, device=dev)
    check(same_bits(proba[:, 1], value),
          "predict_proba[:, 1] is not bitwise booster.predict")
    check(np.array_equal(clf.predict(xv),
                         clf.classes_[(value > 0.5).astype(int)]),
          "predict is not (p > 0.5) mapped through classes_")
    check(np.array_equal(clf.apply(xv),
                         bst.predict(xv, pred_leaf=True, device=dev)),
          "apply is not predict(pred_leaf=True)")
    score = bst.get_score(importance_type="gain")
    gains = np.array([score.get(f"f{i}", 0.0) for i in range(x.shape[1])])
    check(np.array_equal(clf.feature_importances_, gains / gains.sum()),
          "feature_importances_ is not the normalised gain")
    test_ll = clf.evals_result()["validation_0"]["logloss"]
    res["binary"] = {
        "train_rows": int(xt.shape[0]), "test_rows": int(n_test),
        "dump_equal_train": True, "launches": fit_launches,
        "fit_wall_s": fit_wall, "train_wall_s": ref_wall,
        "train_setup_s": ref_extra["setup_time_s"],
        "label_encoding_np_unique_s": unique_s,
        "label_encoding_dict_loop_s": loop_s,
        "test_logloss": test_ll}

    # 2. early stopping through the estimator
    es = RayXGBClassifier(n_estimators=es_rounds, early_stopping_rounds=3,
                          eval_metric=["error", "logloss"], **est_kw)
    es.fit(xt, yt, eval_set=[(xv, yv)])
    hist = es.evals_result()["validation_0"]["logloss"]
    best = es.best_iteration
    check(best == int(np.argmin(hist)),
          f"best_iteration {best} is not the argmin of the test logloss")
    check(len(hist) == min(es_rounds, best + 4),
          f"stopped after {len(hist)} rounds, best {best}")
    check(same_bits(es.predict_proba(xv)[:, 1], es.get_booster().predict(
        xv, iteration_range=(0, best + 1), device=dev)),
          "predict after early stopping does not use rounds [0, best + 1)")
    res["early_stopping"] = {"rounds_run": len(hist), "best_iteration": best,
                             "best_score": es.best_score}
    del es

    # 6. pickle (of step 1's estimator)
    back = pickle.loads(pickle.dumps(clf))
    check(same_bits(back.predict_proba(xv), proba),
          "an unpickled estimator predicts otherwise")
    res["pickle_bitwise"] = True
    del clf, back, bst, ref, proba, value
    torch.cuda.empty_cache()

    # 4. a custom squared-error objective over every row
    keeps = {}

    def fit_reg(objective):
        keeps[objective if isinstance(objective, str) else "custom"] = keep = (
            _KeepEngine())
        reg = RayXGBRegressor(n_estimators=rounds, base_score=0.5,
                              objective=objective, **est_kw)
        return reg.fit(x, y, callbacks=[keep])

    custom, custom_launches, custom_wall = counted(
        lambda: fit_reg(sq_objective))
    builtin, builtin_launches, builtin_wall = counted(
        lambda: fit_reg("reg:squarederror"))
    eng = keeps["custom"].engine
    margins = eng.get_margins()[:, 0]
    builtin_margins = keeps["reg:squarederror"].engine.get_margins()[:, 0]
    same_model = (custom.get_booster().get_dump(with_stats=True)
                  == builtin.get_booster().get_dump(with_stats=True))
    if not same_model:
        # the built-in gradient flushes a subnormal m - y (C5); numpy does
        # not: count the rows whose gradients differ at the final margins
        g_np = sq_objective(y, margins)[0]
        g_plain = O.grad_hess(torch.from_numpy(margins), torch.from_numpy(y),
                              torch.ones(len(y)), False)[0].numpy()
        res["custom_gradient_rows_differ"] = int(
            np.sum(g_np.view(np.int32) != g_plain.view(np.int32)))
        emit(res)
    check(same_model, "the custom squared error trains another model than "
                      "reg:squarederror")
    check(same_bits(margins, builtin_margins),
          "the custom objective's final margins are not the built-in's")
    check_launches(custom_launches, custom_expect(rounds, depth),
                   "the custom objective's fit")
    check_launches(builtin_launches, train_expect(rounds, depth),
                   "reg:squarederror's fit")
    rt_c = [r * 1e3 for r in custom.additional_results_["round_times_s"]]
    rt_b = [r * 1e3 for r in builtin.additional_results_["round_times_s"]]
    res["custom_objective"] = {
        "rows": int(x.shape[0]), "same_model_bitwise": True,
        "launches": custom_launches, "builtin_launches": builtin_launches,
        "round_ms_median": float(np.median(rt_c)),
        "builtin_round_ms_median": float(np.median(rt_b)),
        "round_ms": rt_c, "builtin_round_ms": rt_b,
        "fit_wall_s": custom_wall, "builtin_fit_wall_s": builtin_wall}
    # what a custom round adds: the margins' copy to the host, the user's
    # objective, the gradients' copy to the card (medians of 5)
    parts = {"margins_to_host_ms": [], "objective_ms": [],
             "gradients_to_card_ms": []}
    for _ in range(5):
        t0 = time.perf_counter()
        m_host = eng.get_margins()[:, 0]
        t1 = time.perf_counter()
        g, h = sq_objective(y, m_host)
        t2 = time.perf_counter()
        eng._user_gh(g, h)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[key].append(dt * 1e3)
    res["custom_objective"]["round_parts_ms"] = {
        k: float(np.median(v)) for k, v in parts.items()}
    del m_host, g, h
    # K4's no-gradient mode over the training rows, against its plain
    # version on the same card tensors
    rv = G.predict_tree_binned(eng.trees[-1], eng.bins, depth, 256)
    m0 = eng.margins.view(-1).clone()
    mk, mp = m0.clone(), m0.clone()
    gh, sk = O.round_update(mk, rv, eng.label, eng.weight, False,
                            with_gh=False)
    _, sp = O.round_update_plain(mp, rv, eng.label, eng.weight, False,
                                 with_gh=False)
    check(gh is None and torch.equal(bits(mk), bits(mp)),
          "K4's no-gradient mode at the training shape: margins differ")
    rel = float(((sk - sp).abs() / sp.abs().clamp_min(1e-30)).max())
    check(rel <= 1e-5, f"K4's no-gradient mode at the training shape: "
                       f"partials beyond 1e-5 relative ({rel})")
    n = int(m0.shape[0])
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    _kernel_record(
        records, "K4nograd",
        lambda: O.round_update(mk, rv, eng.label, eng.weight, False,
                               with_gh=False),
        lambda: O.round_update_plain(mp, rv, eng.label, eng.weight, False,
                                     with_gh=False),
        # margin, row value, label, weight read, margin written: 20 B a row
        bound_ms(n * 4 * 5, 45 * n), flush, custom_launches["K4eval"],
        float((sk - sp).abs().max()))
    records["K4nograd"]["partials_rel"] = rel
    del custom, builtin, keeps, eng, rv, m0, mk, mp, margins, builtin_margins
    torch.cuda.empty_cache()

    # 3. the multiclass classifier on Covertype's labels 1..7
    k = 7
    xc, yc = make_covertype_like(COVERTYPE_ROWS, seed=0)
    xct, yct = xc[:-COVERTYPE_TEST], yc[:-COVERTYPE_TEST]
    xcv, ycv = xc[-COVERTYPE_TEST:], yc[-COVERTYPE_TEST:]
    mc_params = {"objective": "multi:softprob", "num_class": k,
                 "max_depth": depth, "max_bin": 256}
    (mref, _, _), mref_launches, _ = counted(lambda: train_ref(
        mc_params, xct, yct, rounds))
    mclf = RayXGBClassifier(n_estimators=rounds, **est_kw)
    _, mfit_launches, mfit_wall = counted(lambda: mclf.fit(xct, yct + 1))
    check(list(mclf.classes_) == list(range(1, k + 1))
          and mclf.n_classes_ == k,
          f"classes_ {mclf.classes_}, n_classes_ {mclf.n_classes_}")
    check(mclf.get_booster().get_dump(with_stats=True)
          == mref.get_dump(with_stats=True),
          "RayXGBClassifier's multiclass model differs from train()'s")
    check(mfit_launches == mref_launches,
          f"multiclass fit launched {mfit_launches}, train() {mref_launches}")
    mproba = mclf.predict_proba(xcv)
    mpred = mclf.predict(xcv)
    check(np.array_equal(mpred, mclf.classes_[mproba.argmax(axis=1)])
          and set(np.unique(mpred)) <= set(range(1, k + 1)),
          "multiclass predict is not the classes_ of predict_proba's argmax")
    res["multiclass"] = {"rows": int(xct.shape[0]), "classes": k,
                         "launches": mfit_launches, "fit_wall_s": mfit_wall,
                         "dump_equal_train": True}
    del mref, mclf, mproba, mpred

    # 5. a custom softmax objective and mlogloss metric, Covertype's shape
    keep = _KeepEngine()
    (mc_bst, mc_ev, mc_extra), mc_launches, _ = counted(lambda: train_ref(
        dict(mc_params, eval_metric=["mlogloss"]), xct, yct, rounds,
        (xcv, ycv), obj=softmax_objective, custom_metric=mlogloss_metric,
        callbacks=[keep]))
    check_launches(mc_launches, custom_expect(rounds, depth, k, True),
                   "the custom softmax objective's train()")
    for name in ("train", "test"):
        got, want = mc_ev[name]["my_mlogloss"], mc_ev[name]["mlogloss"]
        check(np.allclose(got, want, rtol=0, atol=1e-5),
              f"custom mlogloss on {name} {got} is not the built-in {want}")
    check(mc_ev["test"]["mlogloss"][-1] < mc_ev["test"]["mlogloss"][0],
          f"the custom softmax objective did not learn: {mc_ev['test']}")
    eng = keep.engine
    rv = G.predict_tree_binned(eng.trees[-1], eng.bins, depth, 256)
    err_s, rel_s, _ = hold_softmax_update(
        eng.margins, rv, eng.label, eng.weight, False,
        "no-gradient mode over the training rows")
    m_train = eng.margins.clone()
    n_tr = int(m_train.shape[0])
    _kernel_record(
        records, "SMXnograd", lambda: O.softmax_update(
            m_train, rv, eng.label, eng.weight, with_gh=False),
        lambda: O.softmax_update_plain(m_train.clone(), rv, eng.label,
                                       eng.weight, with_gh=False),
        bound_ms(n_tr * (12 * k + 8), 40 * k * n_tr), flush,
        mc_launches["SMXeval"], err_s)
    records["SMXnograd"]["partials_rel"] = rel_s
    res["custom_multiclass"] = {
        "launches": mc_launches, "history": mc_ev,
        "round_ms_median": float(np.median(mc_extra["round_times_s"])) * 1e3}
    del keep, eng, rv, m_train, mc_bst, flush
    torch.cuda.empty_cache()

    # 7 + 8. files, the 2-rank world's hooks, the tune callback
    os.makedirs(OUT_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="facade_", dir=OUT_DIR)
    try:
        frame_cols = [f"f{i}" for i in range(xcv.shape[1])]
        paths = []
        for i, part in enumerate(np.array_split(np.arange(COVERTYPE_TEST), 4)):
            df = pd.DataFrame(xcv[part], columns=frame_cols)
            df["label"] = ycv[part]
            paths.append(os.path.join(tmp, f"part{i}.csv"))
            df.to_csv(paths[-1], index=False, float_format="%.9g")
        file_params = dict(mc_params, eval_metric=["mlogloss"])
        (np_bst, _, _), _, _ = counted(lambda: train_ref(
            file_params, xcv, ycv, rounds))
        read_csv_file.reads.update(native=0, pandas=0)
        sess = tune.init_session(os.path.join(tmp, "trial"))
        try:
            central = xrt.RayDMatrix(paths, label="label", distributed=False)
            c_bst = xrt.train(file_params, central, rounds,
                              evals=[(central, "train")], device=dev,
                              ray_params=xrt.RayParams(num_actors=1))
        finally:
            tune.shutdown_session()
        reads = dict(read_csv_file.reads)
        check(reads == {"native": 4, "pandas": 0},
              f"the central CSV load's parsers: {reads}")
        check(c_bst.get_dump() == np_bst.get_dump(),
              "the central CSV model differs from the numpy-input model")
        check([r["training_iteration"] for r in sess.results]
              == list(range(1, rounds + 1))
              and all("train-mlogloss" in r for r in sess.results),
              f"the tune callback reported {sess.results}")
        t0 = time.perf_counter()
        out = D.launch_world(
            D._train_rank, 2, "cuda", {"source": paths, "label": "label"},
            file_params, rounds, {"distributed_callbacks": [HookRecorder()]})
        world_s = time.perf_counter() - t0
        for r, o in enumerate(out):
            check(xrt.RayXGBoostBooster.load_raw(o["model"]).get_dump()
                  == np_bst.get_dump(),
                  f"rank {r}'s distributed CSV model differs from the "
                  f"numpy-input model")
            check(o["csv_reads"] == {"native": 2, "pandas": 0},
                  f"rank {r} read its CSV files with {o['csv_reads']}")
            calls = o["distributed_callbacks"][0].calls
            check(calls == hook_order(r, rounds),
                  f"rank {r}'s hooks: {calls}")
            check(o["additional_results"]["world_size"] == 2
                  and o["additional_results"]["backend"] == "gloo",
                  f"rank {r}: {o['additional_results']['backend']}")
        res["files"] = {
            "csv_files": 4, "rows": int(COVERTYPE_TEST),
            "features": int(xcv.shape[1]), "central_reads": reads,
            "rank_reads": [o["csv_reads"] for o in out],
            "world_wall_s": world_s, "hooks_in_order": True,
            "tune_reports": len(sess.results)}
        try:
            import pyarrow  # noqa: F401
        except ImportError:
            emit({"parquet": "not installed"})
            res["files"]["parquet"] = "not installed"
        else:
            pq = []
            for i, src in enumerate(paths):
                pq.append(os.path.join(tmp, f"part{i}.parquet"))
                pd.read_csv(src).to_parquet(pq[-1])
            p_bst = xrt.train(file_params, xrt.RayDMatrix(pq, label="label"),
                              rounds, device=dev,
                              ray_params=xrt.RayParams(num_actors=1))
            check(p_bst.get_dump() == np_bst.get_dump(),
                  "the Parquet model differs from the numpy-input model")
            res["files"]["parquet"] = "equal"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    if _SKLEARN_INSTALLED:
        from sklearn.base import clone
        from sklearn.model_selection import GridSearchCV

        est = RayXGBClassifier(n_estimators=3, device=dev)
        check(clone(est).get_params()["device"] == dev,
              "clone lost the device")
        gs = GridSearchCV(est, {"max_depth": [2, 3]}, cv=2,
                          error_score="raise")
        gs.fit(x[:grid_rows], y[:grid_rows])
        res["grid_search"] = {"rows": grid_rows,
                              "best_params": gs.best_params_,
                              "best_score": float(gs.best_score_)}
    res["phase_wall_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase 11: SHAP on the card (B15)
# ---------------------------------------------------------------------------

#: rows of each SHAP path of phase 11
SHAP_ROWS = 1 << 20  # HIGGS contributions, exact and Saabas (122 MB out)
SHAP_INTER_ROWS = 1 << 16  # HIGGS interactions (220 MB out)
SHAP_COV_INTER_ROWS = 4096  # Covertype interactions
SHAP_PLAIN_ROWS = 4096  # each entry point against its plain version
#: rounds of the forest the plain interactions run over (its D^2 loops of
#: PyTorch calls take minutes over all 500 trees)
SHAP_PLAIN_INTER_ROUNDS = 50
F32_EPS = float(np.finfo(np.float32).eps)


def shap_counters():
    from xgboost_ray_tpu_torch.ops import shap as SH

    return dict(SH.LAUNCHES_BY_MODE)


def shap_sum_bound(bst, sf, m, n_feat, interactions=False):
    """The f32 bound a row's contributions must sum to its margin within:
    each of a tree's SHAP values is at most twice its largest |leaf value|
    B_t (a Shapley value averages differences of expectations over leaves),
    so the terms summed over the T trees and F + 1 columns are at most
    sum_t 2 D_t B_t, with D_t the tree's split features ((D_t + 1)^2 cells
    of interaction values, a diagonal cell a row's remainder: 2 (D_t + 1)^2
    B_t); every add rounds once (relative eps) and an output takes at most
    T + C adds (C its columns: F + 2, or (F + 1)^2 + 1), plus the margin's
    own T adds, so |sum phi - m| <= eps (2 T + C) (terms + |m|)."""
    fo = bst.forest
    big = np.where(fo.is_leaf, np.abs(fo.value), 0.0).max(axis=1)
    d_t = sf.n_feats.cpu().numpy().astype(np.float64)
    scale = 1.0 if bst.tree_weights is None else np.abs(bst.tree_weights)
    per_tree = 2 * (d_t + 1) ** 2 if interactions else 2 * d_t
    terms = float((per_tree * big * scale).sum())
    cols = (n_feat + 1) ** 2 + 1 if interactions else n_feat + 2
    return F32_EPS * (2 * bst.num_trees + cols) * (terms + np.abs(m))


def _shap_record(records, key, fn, plain, bound, launches, err, fn4096):
    """B15's row of the kernel table: events and device time (L2 flushed
    by a write and by a read, and warm) at the main path's shape, the
    kernel and its plain version at ``SHAP_PLAIN_ROWS`` rows."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    # one call a reading: a launch takes seconds at the main path's shapes
    records[key].update(
        launches=launches, max_abs_err=err, ms=cuda_ms(fn, iters=1,
                                                      warmup=0),
        device_ms=profiled_ms(lambda: (flush.zero_(), fn()), iters=1),
        device_ms_read_flush=read_flushed_ms(fn, iters=1),
        device_ms_l2_warm=profiled_ms(fn, iters=1),
        ms_plain_rows=cuda_ms(fn4096, iters=2, warmup=1),
        plain_ms=cuda_ms(plain, iters=1, warmup=0), plain_rows=SHAP_PLAIN_ROWS,
        bound_ms=bound[0], bound_by=bound[1], library_ms=None)


def train_covertype_model(rounds=10, depth=6):
    """Phase 9's Covertype model (``multi:softprob``, K = 7, 70 trees,
    F = 54) and its 116,202 test rows."""
    import xgboost_ray_tpu_torch as xrt

    x, y = make_covertype_like(COVERTYPE_ROWS, seed=0)
    xt, yt = x[:-COVERTYPE_TEST], y[:-COVERTYPE_TEST]
    bst = xrt.train({"objective": "multi:softprob", "num_class": 7,
                     "max_depth": depth, "max_bin": 256},
                    xrt.RayDMatrix(xt, yt), rounds,
                    ray_params=xrt.RayParams(num_actors=1))
    check(bst.num_trees == 7 * rounds, "wrong Covertype forest")
    return bst, x[-COVERTYPE_TEST:]


def phase_shap(bst, x, records):
    """Phase 11: SHAP through ``predict()`` and the booster on the card with
    B15, each path with B15's counters set to 0 just before it and read
    just after; every entry point against its plain version; reruns and
    row independence bitwise; sums to B8's margins within the f32 bound."""
    import torch

    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch.ops import shap as SH

    t_phase = time.perf_counter()
    n = SHAP_ROWS
    xs = np.ascontiguousarray(x[:n])
    f = xs.shape[1]
    rp = xrt.RayParams(num_actors=2)
    res = {"phase": "shap", "trees": bst.num_trees, "rows": n,
           "interaction_rows": SHAP_INTER_ROWS}
    t0 = time.perf_counter()
    sf = bst.shap_forest("cuda")
    res["tables_s"] = time.perf_counter() - t0
    res["leaves"] = int(sf.n_leaves.sum())
    res["max_leaves"] = sf.max_leaves
    res["max_tree_features"] = sf.max_feats
    margin = bst.predict(xs, output_margin=True)
    chunks = {mode: predict_chunks(
        bst, n, 4 * (f + int(np.prod(SH.out_shape(1, f, 1, mode)[1:]))
                     + SH.scratch_floats(sf, f, 1, mode)))
        for mode in ("exact", "saabas")}

    # the main paths: predict() over 1M rows, exact then Saabas, then the
    # interaction values over 65,536 rows
    SH.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exact = xrt.predict(bst, xrt.RayDMatrix(xs), ray_params=rp,
                        pred_contribs=True)
    res["exact_wall_s"] = time.perf_counter() - t0
    got = shap_counters()
    check(got == {"saabas": 0, "exact": chunks["exact"], "interactions": 0},
          f"B15 launches of predict(pred_contribs): {got}, expected "
          f"{chunks['exact']} exact (one a chunk)")
    main_launches = dict(got)
    SH.reset_launches()
    t0 = time.perf_counter()
    approx = xrt.predict(bst, xrt.RayDMatrix(xs), ray_params=rp,
                         pred_contribs=True, approx_contribs=True)
    res["saabas_wall_s"] = time.perf_counter() - t0
    got = shap_counters()
    check(got == {"saabas": chunks["saabas"], "exact": 0, "interactions": 0},
          f"B15 launches of approx_contribs: {got}")
    main_launches["saabas"] = got["saabas"]
    ni = SHAP_INTER_ROWS
    SH.reset_launches()
    t0 = time.perf_counter()
    inter = xrt.predict(bst, xrt.RayDMatrix(xs[:ni]), ray_params=rp,
                        pred_interactions=True)
    res["interactions_wall_s"] = time.perf_counter() - t0
    got = shap_counters()
    check(got == {"saabas": 0, "exact": 0, "interactions": 1},
          f"B15 launches of pred_interactions: {got}")
    main_launches["interactions"] = 1
    check(exact.shape == (n, f + 1) and approx.shape == (n, f + 1)
          and inter.shape == (ni, f + 1, f + 1), "SHAP outputs' shapes")
    check(all(bool(np.isfinite(a).all()) for a in (exact, approx, inter)),
          "non-finite SHAP values")
    res["output_mb"] = {"exact": exact.nbytes / 1e6,
                        "interactions": inter.nbytes / 1e6}

    # rows sum to B8's margin within the stated f32 bound
    bound = shap_sum_bound(bst, sf, margin, f)
    bound_i = shap_sum_bound(bst, sf, margin[:ni], f, interactions=True)
    sums = {"exact": np.abs(exact.sum(1, dtype=np.float64) - margin),
            "saabas": np.abs(approx.sum(1, dtype=np.float64) - margin),
            "interactions": np.abs(inter.sum((1, 2), dtype=np.float64)
                                   - margin[:ni])}
    res["sum_err_max"] = {k: float(v.max()) for k, v in sums.items()}
    res["sum_bound_min"] = [float(bound.min()), float(bound_i.min())]
    for k, v in sums.items():
        b = bound_i if k == "interactions" else bound
        check(bool((v <= b).all()), f"{k} rows do not sum to the margin: "
                                    f"{float(v.max())} > bound")
    rows_err = np.abs(inter.sum(2, dtype=np.float64) - exact[:ni]).max(1)
    res["interaction_rows_vs_exact_max"] = float(rows_err.max())
    check(bool((rows_err <= bound_i).all()),
          "interaction rows do not sum to the exact contributions")

    # the booster's own call, reruns, and rows at other batch sizes
    same = {"booster_exact": np.array_equal(
        bst.predict(xs, pred_contribs=True), exact)}
    same["rerun_exact"] = np.array_equal(
        xrt.predict(bst, xrt.RayDMatrix(xs), ray_params=rp,
                    pred_contribs=True), exact)
    same["rerun_interactions"] = np.array_equal(
        bst.predict(xs[:ni], pred_interactions=True), inter)
    for b in (8, 256):
        same[f"exact_batch_{b}"] = np.array_equal(
            bst.predict(xs[77:77 + b], pred_contribs=True),
            exact[77:77 + b])
        same[f"saabas_batch_{b}"] = np.array_equal(
            bst.predict(xs[77:77 + b], pred_contribs=True,
                        approx_contribs=True), approx[77:77 + b])
        same[f"interactions_batch_{b}"] = np.array_equal(
            bst.predict(xs[77:77 + b], pred_interactions=True),
            inter[77:77 + b])
    res["bitwise"] = same
    check(all(same.values()), f"B15 reruns / row independence: {same}")

    # each entry point against its plain version on the card (bitwise: the
    # kernel runs the plain version's f32 operations in its order, both
    # unfused); the plain interactions over the first 50 rounds
    sc = bst.tree_scales(sf)
    sc50 = bst.tree_scales(sf, ntree_limit=SHAP_PLAIN_INTER_ROUNDS)
    xp = torch.from_numpy(xs[:SHAP_PLAIN_ROWS]).cuda()
    cases = {"saabas": (SH.predict_contribs, SH.predict_contribs_plain, sc),
             "exact": (SH.predict_contribs_exact,
                       SH.predict_contribs_exact_plain, sc),
             "interactions": (SH.predict_interactions,
                              SH.predict_interactions_plain, sc50)}
    errs = {}
    for mode, (kern, plain, scm) in cases.items():
        a = kern(sf, xp, scm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = plain(sf, xp, scm)
        torch.cuda.synchronize()
        res[f"plain_{mode}_s"] = time.perf_counter() - t0
        errs[mode] = float((a - b).abs().max())
        check(torch.equal(a, b), f"B15 {mode} differs from its plain "
                                 f"version: max |d| {errs[mode]}")
    res["plain_trees"] = {"saabas": bst.num_trees, "exact": bst.num_trees,
                          "interactions": SHAP_PLAIN_INTER_ROUNDS}

    # Covertype (multi:softprob, K = 7, F = 54): exact over the test rows,
    # interactions over 4,096
    t0 = time.perf_counter()
    cov, xv = train_covertype_model()
    res["covertype_train_s"] = time.perf_counter() - t0
    sfc = cov.shap_forest("cuda")
    mc = cov.predict(xv, output_margin=True)
    SH.reset_launches()
    cexact = cov.predict(xv, pred_contribs=True)
    cinter = cov.predict(xv[:SHAP_COV_INTER_ROWS], pred_interactions=True)
    got = shap_counters()
    check(got == {"saabas": 0, "exact": 1, "interactions": 1},
          f"B15 launches of the Covertype paths: {got}")
    check(cexact.shape == (COVERTYPE_TEST, 7, 55)
          and cinter.shape == (SHAP_COV_INTER_ROWS, 7, 55, 55),
          "Covertype SHAP shapes")
    cb = shap_sum_bound(cov, sfc, np.abs(mc).max(1), 54)[:, None]
    cbi = shap_sum_bound(cov, sfc, np.abs(mc[:SHAP_COV_INTER_ROWS]).max(1),
                         54, interactions=True)[:, None]
    ce = np.abs(cexact.sum(2, dtype=np.float64) - mc)
    ci = np.abs(cinter.sum((2, 3), dtype=np.float64)
                - mc[:SHAP_COV_INTER_ROWS])
    res["covertype"] = {"exact_rows": COVERTYPE_TEST,
                        "interaction_rows": SHAP_COV_INTER_ROWS,
                        "exact_mb": cexact.nbytes / 1e6,
                        "sum_err_max": [float(ce.max()), float(ci.max())]}
    check(bool((ce <= cb).all() and (ci <= cbi).all()),
          f"Covertype contributions do not sum to the margins: "
          f"{float(ce.max())}, {float(ci.max())}")
    xcp = torch.from_numpy(np.ascontiguousarray(xv[:SHAP_PLAIN_ROWS])).cuda()
    scc = cov.tree_scales(sfc)
    a = SH.predict_contribs_exact(sfc, xcp, scc)
    check(torch.equal(a, SH.predict_contribs_exact_plain(sfc, xcp, scc)),
          "B15 exact differs from its plain version at K = 7, F = 54")

    # times at the main path's shapes, bounds from this forest's leaves
    xd = torch.from_numpy(xs).cuda()
    xi = xd[:ni].contiguous()
    outs = {"exact": (torch.empty((n, 1, f + 1), device="cuda"),
                      torch.empty((SH.scratch_floats(sf, f, 1, "exact") * n,),
                                  device="cuda"), xd),
            "saabas": (torch.empty((n, 1, f + 1), device="cuda"),
                       torch.empty((SH.scratch_floats(sf, f, 1, "saabas")
                                    * n,), device="cuda"), xd),
            "interactions": (
                torch.empty((ni, 1, f + 1, f + 1), device="cuda"),
                torch.empty((SH.scratch_floats(sf, f, 1, "interactions")
                             * ni,), device="cuda"), xi)}
    for mode, (kern, plain, scm) in cases.items():
        out, scratch, xin = outs[mode]
        rows = xin.shape[0]
        nbytes = xin.numel() * 4 + out.numel() * 4
        ops = SH.leaf_ops(sf, mode) * rows
        key = {"saabas": "B15saabas", "exact": "B15exact",
               "interactions": "B15interactions"}[mode]
        _shap_record(
            records, key,
            lambda: kern(sf, xin, sc, out=out, scratch=scratch),
            lambda: plain(sf, xp, scm),
            bound_ms(nbytes, ops), main_launches[mode], errs[mode],
            lambda: kern(sf, xp, scm))
        records[key]["rows"] = rows
        records[key]["ops_per_row"] = SH.leaf_ops(sf, mode)
        records[key]["plain_trees"] = res["plain_trees"][mode]
    res["kernels"] = {k: records[k] for k in SHAP_KERNELS}
    del xd, xi, outs
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase 12: the replica pool, autoscaler, canary and xgboost JSON
# ---------------------------------------------------------------------------


def _probe_kinds(handle, bst, q, kinds):
    """Each of ``kinds`` served for ``q`` against ``booster.predict`` on the
    card and on the CPU, bitwise; and B15's launches for the served
    requests alone (read before the references launch it again)."""
    ok = {}
    refs = {"value": {}, "margin": {"output_margin": True},
            "leaf": {"pred_leaf": True}, "contribs": {"pred_contribs": True}}
    served = {kind: _post_json(handle.url + "/predict",
                               {"data": q.tolist(), "kind": kind})
              for kind in kinds}
    ok["b15_launches"] = shap_counters()["exact"]
    for kind in kinds:
        r = served[kind]
        for where, dev in (("card", None), ("cpu", "cpu")):
            ref = bst.predict(q, device=dev, **refs[kind])
            got = np.asarray(r["predictions"], ref.dtype)
            ok[f"{kind}_{where}"] = bool(got.shape == ref.shape
                                         and np.array_equal(got, ref))
    return ok


def _serve_window(bst, x, n_replicas, warm_s, duration_s, mid=None):
    """A closed loop of 16 clients against ``create_server(bst,
    n_replicas=...)``; ``mid`` is called half-way through the window."""
    from xgboost_ray_tpu_torch import serve
    from xgboost_ray_tpu_torch.ops import shap as SH

    builds0 = serve.compile_count()
    handle = serve.create_server(bst, max_batch=256, max_delay_ms=2.0,
                                 n_replicas=n_replicas)
    warm_builds = serve.compile_count() - builds0
    after_warm = serve.compile_count()
    try:
        SH.reset_launches()
        probe = _probe_kinds(handle, bst, x[:37],
                             ("value", "margin", "leaf", "contribs"))
        contribs_launches = probe.pop("b15_launches")
        snap, parked, launches, errors = _closed_loop(
            handle, x, 16, 32, warm_s, duration_s, mid=(
                None if mid is None else lambda: mid(handle)))
        probe_after = _probe_kinds(handle, bst, x[37:74],
                                   ("value", "contribs"))
        probe_after.pop("b15_launches")
        builds = serve.compile_count() - after_warm
        replicas = handle.metrics.snapshot().get("replicas", 1)
    finally:
        handle.shutdown()
    out = {"n_replicas": n_replicas, "client_errors": len(errors),
           "errors_sample": errors[:3], "probe_bitwise": probe,
           "probe_bitwise_after_load": probe_after,
           "builds_at_start": warm_builds, "builds_after_warmup": builds,
           "contribs_probe_launches": contribs_launches,
           "b8_value_launches": launches["B8value"],
           "batches_once_parked": parked["batches"], "replicas": replicas,
           **{k: snap[k] for k in ("requests", "qps", "batches",
                                   "mean_batch_rows", "latency_p50_ms",
                                   "latency_p95_ms", "latency_p99_ms")}}
    check(len(errors) == 0, f"{len(errors)} client errors at n_replicas="
                            f"{n_replicas}: {errors[:3]}")
    check(all(probe.values()) and all(probe_after.values()),
          f"served probes not bitwise booster.predict: {probe} "
          f"{probe_after}")
    check(builds == 0, f"{builds} kernel builds after warmup")
    # one probe per kind: contribs is one B15 exact launch per batch
    check(contribs_launches == 1, f"contribs probe launched B15 "
                                  f"{contribs_launches} times")
    check(launches["B8value"] == parked["batches"],
          f"B8 value launches {launches['B8value']} != batches "
          f"{parked['batches']}")
    return out


def phase_serve_pool(bst, x, y):
    """Phase 12: the replica pool on the one card (1 and 4 replicas under
    the closed loop, a replica killed under load and rejoined), the
    autoscaler's cycle read back from the trace, the canary (rollback of a
    shuffled-label model, promotion of a ``refresh``-ed one) and the
    xgboost-JSON round trip with a ``POST /models`` hot swap."""
    import torch

    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch import obs, serve

    t_phase = time.perf_counter()
    res = {"phase": "serve_pool", "trees": bst.num_trees}
    tracer = obs.Tracer(capacity=1 << 16, enabled=True, trace_dir="", rank=0)
    obs.set_default_tracer(tracer)
    try:
        res["one"] = _serve_window(bst, x, 1, 1.0, 3.0)
        res["four"] = _serve_window(bst, x, 4, 1.0, 3.0)

        killed = {}

        def kill_and_rejoin(handle):
            router = handle.batcher
            victim = router.replica_slots()[0]
            router.kill(victim)
            time.sleep(1.0)
            killed["victim"] = victim
            killed["live_after_kill"] = router.live_replicas()
            killed["rejoined"] = router.rejoin()
            killed["live_after_rejoin"] = router.live_replicas()

        res["kill"] = _serve_window(bst, x, 4, 0.5, 3.0, mid=kill_and_rejoin)
        res["kill"].update(killed)
        check(killed.get("live_after_kill") == 3
              and killed.get("live_after_rejoin") == 4,
              f"replica kill / rejoin: {killed}")
        recs = tracer.records()
        down = [r["attrs"] for r in recs if r["name"] == "serve.replica_down"
                and r["attrs"].get("reason") == "killed"]
        check(len(down) == 1 and down[0]["replica"] == killed["victim"],
              "the kill is not on the trace")

        # the autoscaler: one up / down cycle, read back from the trace
        metrics = serve.ServeMetrics(recompile_count_fn=serve.compile_count)
        reg = serve.ModelRegistry(metrics=metrics, warm_kinds=("value",))
        reg.load(bst)
        seq0 = max((r["seq"] for r in tracer.records()), default=0)
        router = serve.Router(reg, n_replicas=1, metrics=metrics)
        scaler = serve.AutoScaler(router, metrics, min_replicas=1,
                                  max_replicas=2, p99_high_ms=50.0,
                                  p99_low_ms=5.0, up_after=2, down_after=3)
        try:
            ticks = []
            for _ in range(10):
                metrics.observe_request(0.2, 1)
            ticks += [scaler.tick(), scaler.tick()]
            metrics.reset()
            for _ in range(10):
                metrics.observe_request(0.0005, 1)
            ticks += [scaler.tick(), scaler.tick(), scaler.tick()]
        finally:
            router.shutdown()
        recs = [r for r in tracer.records() if r["seq"] > seq0]
        scale = [r["attrs"] for r in recs if r["name"] == "serve.scale"]
        live, replay = 0, []
        for r in recs:
            if r["name"] == "serve.replica_up":
                live += 1
            elif r["name"] == "serve.replica_down":
                live -= 1
            if r["name"] in ("serve.replica_up", "serve.replica_down"):
                replay.append(live == r["attrs"]["live"])
        res["autoscaler"] = {"ticks": ticks, "scale_events": scale,
                             "membership_replayed": all(replay)}
        check(ticks == [0, 1, 0, 0, -1] and [e["direction"] for e in scale]
              == ["up", "down"] and scale[0]["to_replicas"] == 2
              and scale[1]["to_replicas"] == 1 and all(replay) and live == 0,
              f"autoscaler cycle not on the trace: {res['autoscaler']}")

        # the canary: a shuffled-label model rolls back, a refreshed one
        # (trained on the card, warm-started with xgb_model) is promoted
        h = serve.create_server(bst, max_batch=256, n_replicas=2)
        try:
            ctl = serve.CanaryController(h.registry, metrics=h.metrics)
            xc, yc = x[:200_000], y[:200_000]
            rng = np.random.RandomState(7)
            params = {"objective": "binary:logistic", "max_depth": 6,
                      "max_bin": 256}
            t0 = time.perf_counter()
            bad = xrt.train(params, xrt.RayDMatrix(x[:1_000_000],
                                                   rng.permutation(
                                                       y[:1_000_000])),
                            20, ray_params=xrt.RayParams(num_actors=1))
            v_bad = ctl.publish(bad, xc, yc, shadow_x=x[:4096])
            good = serve.refresh(bst, params,
                                 xrt.RayDMatrix(x[:1_000_000],
                                                y[:1_000_000]),
                                 5, ray_params=xrt.RayParams(num_actors=1))
            v_good = ctl.publish(good, xc, yc)
            res["canary_s"] = time.perf_counter() - t0
            r = _post_json(h.url + "/predict", {"data": x[:9].tolist()})
            served_good = (r["model_version"] == 2 and np.array_equal(
                np.asarray(r["predictions"], np.float32),
                good.predict(x[:9])))
            snap = h.metrics.snapshot()
        finally:
            h.shutdown()
        res["canary"] = {
            "rollback": {k: v_bad[k] for k in (
                "promoted", "reason", "version", "live_metric",
                "candidate_metric", "shadow_mean_abs_delta")},
            "promote": {k: v_good[k] for k in (
                "promoted", "reason", "version", "live_metric",
                "candidate_metric")},
            "refreshed_trees": good.num_trees, "served_refreshed": served_good,
            "metrics": {k: snap[k] for k in ("canary_promotions",
                                             "canary_rollbacks")}}
        names = [r["name"] for r in tracer.records()]
        check(v_bad["promoted"] is False and v_good["promoted"] is True
              and good.num_trees == bst.num_trees + 5 and served_good
              and snap["canary_rollbacks"] == 1
              and snap["canary_promotions"] == 1
              and "serve.rollback" in names and "serve.promote" in names,
              f"canary: {res['canary']}")

        # xgboost JSON: export, import bitwise, POST /models hot swap
        os.makedirs(OUT_DIR, exist_ok=True)
        path = os.path.abspath(os.path.join(OUT_DIR, "served.xgb.json"))
        t0 = time.perf_counter()
        bst.export_xgboost_json(path)
        back = xrt.RayXGBoostBooster.import_xgboost_json(path)
        res_x = {"export_import_s": time.perf_counter() - t0,
                 "file_mb": os.path.getsize(path) / 1e6}
        xs = x[:1_000_000]
        res_x["margin_bitwise"] = bool(np.array_equal(
            back.predict(xs, output_margin=True),
            bst.predict(xs, output_margin=True)))
        res_x["value_bitwise"] = bool(np.array_equal(back.predict(xs),
                                                     bst.predict(xs)))
        res_x["contribs_bitwise"] = bool(np.array_equal(
            back.predict(xs[:4096], pred_contribs=True),
            bst.predict(xs[:4096], pred_contribs=True)))
        h = serve.create_server(bad, max_batch=256, n_replicas=2)
        try:
            r = _post_json(h.url + "/models", {"path": path}, timeout=300.0)
            q = _post_json(h.url + "/predict",
                           {"data": x[:9].tolist(), "kind": "margin"})
            res_x["hot_swap_version"] = r["model_version"]
            res_x["hot_swap_bitwise"] = bool(
                q["model_version"] == 2 and np.array_equal(
                    np.asarray(q["predictions"], np.float32),
                    bst.predict(x[:9], output_margin=True)))
        finally:
            h.shutdown()
        os.remove(path)
        res["xgboost_json"] = res_x
        check(all(res_x[k] for k in ("margin_bitwise", "value_bitwise",
                                     "contribs_bitwise", "hot_swap_bitwise")),
              f"xgboost JSON round trip: {res_x}")
        problems = obs.validate_trace_records(tracer.records(),
                                              known_names=obs.TRACE_NAMES)
        res["trace_records"] = len(tracer.records())
        check(not problems, f"trace records invalid: {problems[:3]}")
    finally:
        obs.set_default_tracer(None)
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


def profiled_ms(fn, iters=10):
    """``device_ms`` where ``torch.profiler`` records the kernel, None where
    it records no device time (``PERF.md`` §7)."""
    try:
        return device_ms(fn, iters=iters, blind="raise")
    except SmokeFailure:
        return None


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
    "K4": dict(name="K4 margin update + metric partials + gradients "
               "(11,000,000 rows)", route="cuda",
               source="xgboost_ray_tpu_torch/csrc/objective.cu",
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
    "B4": dict(name="B4 binned tree walk: one depth-6 tree over the 500,000 "
               "test rows (int16 bins, 28 features)", route="cuda",
               source="xgboost_ray_tpu_torch/csrc/walk.cu",
               replaces="xgboost_ray_tpu/ops/grow.py:786"),
    "K4eval": dict(name="K4 eval mode: margin update + metric partials, no "
                   "gradients (500,000 test rows)", route="cuda",
                   source="xgboost_ray_tpu_torch/csrc/objective.cu",
                   replaces="xgboost_ray_tpu/engine.py:1427"),
    "SMX": dict(name="softmax pass, training mode: margins += a round's 7 "
                "row values, mlogloss / merror / weight partials, [K, N, 2] "
                "gradients (464,810 Covertype rows x 7 classes)",
                route="cuda",
                source="xgboost_ray_tpu_torch/csrc/softmax.cu",
                replaces="xgboost_ray_tpu/ops/objectives.py:107"),
    "SMXeval": dict(name="softmax pass, eval mode: margins += the round's "
                    "row values, partials, no gradients (116,202 test rows "
                    "x 7 classes)", route="cuda",
                    source="xgboost_ray_tpu_torch/csrc/softmax.cu",
                    replaces="xgboost_ray_tpu/ops/metrics.py:55"),
    "SMXtransform": dict(name="softmax pass, transform mode: probabilities "
                         "from B8's margins (every one of 581,012 rows x 7 "
                         "classes)", route="cuda",
                         source="xgboost_ray_tpu_torch/csrc/softmax.cu",
                         replaces="xgboost_ray_tpu/ops/objectives.py:115"),
    "B4k": dict(name="B4 binned tree walk: a round's 7 depth-6 trees in one "
                "launch over the 116,202 test rows (int16 bins, 54 features)",
                route="cuda", source="xgboost_ray_tpu_torch/csrc/walk.cu",
                replaces="xgboost_ray_tpu/ops/grow.py:786"),
    "K1f54": dict(name="K1 histogram build + node totals, int64 fixed point, "
                  "at 54 features (two tiles of 27; level 5: 32 nodes, "
                  "464,810 rows)", route="cuda",
                  source="xgboost_ray_tpu_torch/csrc/histogram.cu",
                  replaces="46abde5^:xgboost_ray_tpu/ops/hist_pallas.py:105"),
    "K2levelf54": dict(name="K2 level step at 54 features (level 5: 16 "
                       "parents, 32 nodes)", route="cuda",
                       source="xgboost_ray_tpu_torch/csrc/split.cu",
                       replaces="xgboost_ray_tpu/ops/grow.py:570"),
    "K4nograd": dict(name="K4 eval mode over the training rows: margin "
                     "update + metric partials, no gradients (a custom "
                     "objective's round pass, 11,000,000 rows)",
                     route="cuda",
                     source="xgboost_ray_tpu_torch/csrc/objective.cu",
                     replaces="xgboost_ray_tpu/engine.py:1427"),
    "SMXnograd": dict(name="softmax pass, eval mode over the training rows: "
                      "margins += the round's row values, partials, no "
                      "gradients (a custom objective's round pass, 464,810 "
                      "Covertype rows x 7 classes)", route="cuda",
                      source="xgboost_ray_tpu_torch/csrc/softmax.cu",
                      replaces="xgboost_ray_tpu/ops/metrics.py:55"),
    "B15exact": dict(name="B15 exact TreeSHAP: contributions [N, 1, 29] "
                     "(predict(pred_contribs=True) over 1,048,576 HIGGS "
                     "rows, 500 trees)", route="cuda",
                     source="xgboost_ray_tpu_torch/csrc/shap.cu",
                     replaces="xgboost_ray_tpu/ops/predict.py:299"),
    "B15saabas": dict(name="B15 Saabas contributions (approx_contribs over "
                      "1,048,576 HIGGS rows, 500 trees)", route="cuda",
                      source="xgboost_ray_tpu_torch/csrc/shap.cu",
                      replaces="xgboost_ray_tpu/ops/predict.py:82"),
    "B15interactions": dict(name="B15 SHAP interaction values [N, 1, 29, "
                            "29] (pred_interactions over 65,536 HIGGS rows, "
                            "500 trees)", route="cuda",
                            source="xgboost_ray_tpu_torch/csrc/shap.cu",
                            replaces="xgboost_ray_tpu/ops/predict.py:449"),
    **{f"B8serve{m}": dict(
        name=f"B8 forest walk: margins, heap layout, a serve batch of {m} "
             f"rows (windows mapping; launches: every batch of the heap "
             f"server, all buckets together)",
        route="cuda", source="xgboost_ray_tpu_torch/csrc/predict.cu",
        replaces="xgboost_ray_tpu/ops/predict.py:52") for m in SERVE_ROWS},
}

#: the kernel table's rows of phase 9
MULTICLASS_KERNELS = ("SMX", "SMXeval", "SMXtransform", "B4k", "K1f54",
                      "K2levelf54")

#: the kernel table's rows of phase 10
FACADE_KERNELS = ("K4nograd", "SMXnograd")

#: the kernel table's rows of phase 11
SHAP_KERNELS = ("B15exact", "B15saabas", "B15interactions")

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
    # K4's first launch in each mode (in a tree from before the CUDA K4,
    # Triton's compile of each variant and its launch)
    t1 = time.perf_counter()
    z = torch.zeros(4, device="cuda")
    O.round_update(z, z.clone(), z.clone(), torch.ones(4, device="cuda"), True)
    torch.cuda.synchronize()
    build = {"phase": "build", "nvcc_seconds": cuda_build_s,
             "k4_first_launch_seconds": time.perf_counter() - t1,
             "k4_route": "cuda" if hasattr(O, "k4_plan") else "triton"}
    if hasattr(O.round_update, "eval_launches"):  # not in an older tree
        t1 = time.perf_counter()
        O.round_update(z, z.clone(), z.clone(), torch.ones(4, device="cuda"),
                       True, with_gh=False)
        torch.cuda.synchronize()
        build["k4_eval_mode_first_launch_seconds"] = (
            time.perf_counter() - t1)
    if hasattr(O, "softmax_update"):  # not in an older tree
        # the CUDA pass's first training and transform launches (in a
        # tree from before it, the Triton pass's compile and launch)
        t1 = time.perf_counter()
        m7 = torch.zeros(4, 7, device="cuda")
        O.softmax_update(m7, torch.zeros(7, 4, device="cuda"), z.clone(),
                         torch.ones(4, device="cuda"))
        O.softmax_transform(m7, True)
        torch.cuda.synchronize()
        build["softmax_first_launches_seconds"] = time.perf_counter() - t1
        build["softmax_route"] = ("cuda" if hasattr(O, "softmax_plan")
                                  else "triton")
    emit(build)
    if args.k1_time:
        phase_k1_time(args.rows, args.rounds)
        return
    if args.multiclass_only:
        records = {k: dict(v) for k, v in KERNELS.items()}
        phase_multiclass(records)
        emit({"multiclass_kernels": {k: records[k] for k in MULTICLASS_KERNELS}})
        return
    if args.kernels_only:
        records = {k: dict(v) for k, v in KERNELS.items()}
        phase_kernels(args.rows, {k: records[k] for k in TRAIN_KERNELS})
        emit({"phase2_kernels": {k: records[k] for k in TRAIN_KERNELS}})
        return
    if args.evals_only:
        records = {k: dict(v) for k, v in KERNELS.items()}
        x, y = make_higgs_like(args.rows, 28, seed=0)
        phase_evals(x, y, records)
        emit({"evals_kernels": {k: records[k] for k in ("B4", "K4eval")}})
        return
    if args.k4_variants:
        phase_k4_variants()
        return
    if args.facade_only:
        records = {k: dict(v) for k, v in KERNELS.items()}
        x, y = make_higgs_like(args.rows, 28, seed=0)
        phase_facade(x, y, records)
        emit({"facade_kernels": {k: records[k] for k in FACADE_KERNELS}})
        return
    if args.ranks_only:
        x, y = make_higgs_like(args.rows, 28, seed=0)
        bst, _, _, margins = phase_main(x, y, args.rounds, 6, 1)
        phase_ranks(x, y, args.rounds, 6, bst, margins)
        return
    if args.shap_only or args.pool_only:
        records = {k: dict(v) for k, v in KERNELS.items()}
        x, y = make_higgs_like(args.rows, 28, seed=0)
        served, _, _ = phase_train_model(x, y, args.predict_rounds)
        if args.shap_only:
            phase_shap(served, x, records)
            emit({"shap_kernels": {k: records[k] for k in SHAP_KERNELS}})
        else:
            phase_serve_pool(served, x, y)
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
    results = {"evals": phase_evals(x, y, records),
               "multiclass": phase_multiclass(records)}
    torch.cuda.empty_cache()
    results["facade"] = phase_facade(x, y, records)
    torch.cuda.empty_cache()

    if args.rows < 11_000_000:
        emit({"phase": "main_path_cut", "rows": args.rows,
              "reason": "--rows below the 11,000,000-row HIGGS protocol"})
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
        # walks the heap); it is held and timed in phase 7; the softmax
        # transform runs on phase 9's paths (a K-output model), not these
        check(v > 0 or k in ("B8other", "B8margin_na", "SMXtransform"),
              f"{k} never launched on the predict/serve path")
    for k in ("B8margin", "B8margin_na", "B8leaf"):
        records[k]["launches"] = b8_launches[k]
    for m in SERVE_ROWS:  # the windows kernel of the heap server's batches
        records[f"B8serve{m}"]["launches"] = b8_launches["B8serve"]
    results["late_profile"] = phase_late_profile(served, x)
    # phase 11: SHAP (B15), each path with B15's counters set to 0 just
    # before it and read just after; phase 12: the replica pool,
    # autoscaler, canary and xgboost JSON
    results["shap"] = phase_shap(served, x, records)
    results["serve_pool"] = phase_serve_pool(served, x, y)
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
    ap.add_argument("--multiclass-only", action="store_true",
                    help="only the build and phase 9 (multiclass at "
                         "Covertype's width); prints no result line")
    ap.add_argument("--evals-only", action="store_true",
                    help="only the build and phase 8 (held-out eval sets at "
                         "the HIGGS split; works on an older tree of the "
                         "package too); prints no result line")
    ap.add_argument("--kernels-only", action="store_true",
                    help="only the build and phase 2 (every training kernel "
                         "against its plain version, timed; works on an "
                         "older tree of the package too); prints no result "
                         "line")
    ap.add_argument("--k4-variants", action="store_true",
                    help="only the build and K4 as built against edits of "
                         "its source (no last-CTA sum, streaming loads, "
                         "streaming stores), timed in turns; prints no "
                         "result line")
    ap.add_argument("--ranks-only", action="store_true",
                    help="only the 1-rank main path and the ranks phase (on "
                         "a host of two or more cards: the NCCL path); "
                         "prints no result line")
    ap.add_argument("--shap-only", action="store_true",
                    help="only the build, phase 6's model and phase 11 (SHAP "
                         "with B15); prints no result line")
    ap.add_argument("--pool-only", action="store_true",
                    help="only the build, phase 6's model and phase 12 (the "
                         "replica pool, autoscaler, canary and xgboost "
                         "JSON); prints no result line")
    ap.add_argument("--facade-only", action="store_true",
                    help="only the build and phase 10 (the sklearn "
                         "estimators, custom objectives and metrics, files, "
                         "callbacks); prints no result line")
    args = ap.parse_args()
    try:
        run(args)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()

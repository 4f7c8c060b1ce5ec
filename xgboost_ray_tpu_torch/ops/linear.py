"""B16, the coordinate-descent round of ``booster="gblinear"``.

Port of ``xgboost_ray_tpu/linear.py:460-525`` (``_build_round_fn``): after
the round's margins and gradients, the bias step (``CoordinateDeltaBias``)
and then, feature by feature, ``sg = sum g x_j``, ``sh = sum h (x_j x_j)``
(summed over the world), ``dw = eta coordinate_delta(sg, sh, w_j)``,
``w_j += dw`` and ``g += (h x_j) dw``.

Every sum over rows takes one order, fixed by the row count alone
(``blocked_sum``: chunks of ``CHUNK_ROWS`` rows, each thread of a
256-thread chunk adding its 4 rows in turn, the 256 sums halved in a tree;
the chunk sums the same way), which is the order of the kernel in
``csrc/linear.cu``: on the card it equals this plain version bit for bit.
The JAX package's sums are XLA's row reduces, in their own order, so the
two packages' weights agree within the f32 summation bound (the tests state
it), not bitwise.

The margins a round starts from are ``linear_margins``: ``x @ w`` as a
sum over features in order (one elementwise product and add a feature, on
the card as on the CPU, so both give the same bits), then ``+ b``, ``+``
the user's margin, ``+`` the base margin, in the reference's order.
"""

import ctypes
import functools
from typing import Callable, Optional, Tuple

import torch

from xgboost_ray_tpu_torch.ops import _build

#: rows a chunk of the fixed summation order (``kChunk`` of
#: ``csrc/linear.cu``: 256 threads x 4 rows)
CHUNK_ROWS = 1024
_THREADS = 256
#: the most outputs (K) B16 takes (``kMaxOutputs``)
MAX_OUTPUTS = 64
#: B16's modes (``csrc/linear.cu``)
_ROUND, _SUMS, _STEP = 0, 1, 2


def _tree256(s: torch.Tensor) -> torch.Tensor:
    """[m, 256, ...] -> [m, ...]: the kernel's halving tree over dim 1."""
    stride = _THREADS // 2
    while stride:
        s = s[:, :stride] + s[:, stride:2 * stride]
        stride //= 2
    return s[:, 0]


def blocked_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 of ``v`` [n, ...] f32 in B16's order: rows in chunks
    of 1,024 (zero-padded), thread t of a chunk adding rows t, t + 256,
    t + 512, t + 768 in turn from +0, the 256 thread sums halved in a tree;
    then the chunk sums: thread t adding chunks t, t + 256, ... in turn,
    and the tree."""
    n = v.shape[0]
    rest = v.shape[1:]
    n_chunks = max(1, -(-n // CHUNK_ROWS))
    pad = torch.zeros((n_chunks * CHUNK_ROWS - n,) + rest, dtype=v.dtype,
                      device=v.device)
    x = torch.cat([v, pad]).view((n_chunks, 4, _THREADS) + rest)
    s = torch.zeros((n_chunks, _THREADS) + rest, dtype=v.dtype,
                    device=v.device)
    for i in range(4):
        s = s + x[:, i]
    part = _tree256(s)  # [n_chunks, ...]
    m = -(-n_chunks // _THREADS)
    pad = torch.zeros((m * _THREADS - n_chunks,) + rest, dtype=v.dtype,
                      device=v.device)
    p = torch.cat([part, pad]).view((m, _THREADS) + rest)
    t = torch.zeros((_THREADS,) + rest, dtype=v.dtype, device=v.device)
    for i in range(m):
        t = t + p[i]
    return _tree256(t[None])[0]


def coordinate_delta(sg: torch.Tensor, sh: torch.Tensor, w: torch.Tensor,
                     lam: float, alp: float) -> torch.Tensor:
    """xgboost's ``CoordinateDelta`` (elastic net; ``linear.py:471-479``) in
    f32, operation by operation as B16 computes it; 0 where ``sh < 1e-5``."""
    lam_t = torch.tensor(lam, dtype=torch.float32, device=sg.device)
    alp_t = torch.tensor(alp, dtype=torch.float32, device=sg.device)
    tiny = torch.tensor(1e-38, dtype=torch.float32, device=sg.device)
    sg_l2 = sg + lam_t * w
    sh_l2 = torch.maximum(sh + lam_t, tiny)
    tmp = w - sg_l2 / sh_l2
    pos = torch.maximum(-(sg_l2 + alp_t) / sh_l2, -w)
    neg = torch.minimum(-(sg_l2 - alp_t) / sh_l2, -w)
    d = torch.where(tmp >= 0, pos, neg)
    return torch.where(sh < 1e-5, torch.zeros_like(d), d)


def bias_delta(sg: torch.Tensor, sh: torch.Tensor) -> torch.Tensor:
    """``CoordinateDeltaBias``: ``-sg / sh`` where ``sh > 1e-5``, else 0."""
    tiny = torch.tensor(1e-38, dtype=torch.float32, device=sg.device)
    return torch.where(sh > 1e-5, -sg / torch.maximum(sh, tiny),
                       torch.zeros_like(sg))


def linear_margins(xt: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   user_margin: Optional[torch.Tensor],
                   base_margin0: float) -> torch.Tensor:
    """[n, K] margins ``((x @ w + b) + user_margin) + base_margin0`` of
    feature-major rows ``xt`` [F, n] (NaN as 0), ``x @ w`` summed over the
    features in order from +0, each term rounded; the same bits on any
    device."""
    n = xt.shape[1]
    acc = torch.zeros((n, w.shape[1]), dtype=torch.float32, device=xt.device)
    for j in range(xt.shape[0]):
        acc = acc + xt[j][:, None] * w[j][None, :]
    m = acc + b[None, :]
    if user_margin is not None:
        m = m + user_margin
    return m + torch.tensor(base_margin0, dtype=torch.float32,
                            device=xt.device)


def linear_round_plain(xt: torch.Tensor, gh: torch.Tensor, w: torch.Tensor,
                       b: torch.Tensor, eta: float, lam: float, alp: float,
                       allreduce: Optional[Callable] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain B16: the bias step, then each feature in turn; ``gh`` [K, n,
    2] f32 (g updated in place), ``w`` [F, K], ``b`` [K]; returns the new
    (w, b). ``allreduce`` merges each coordinate's [2K] sums over the
    world (None: world 1)."""
    eta_t = torch.tensor(eta, dtype=torch.float32, device=gh.device)
    g, h = gh[..., 0].T, gh[..., 1].T  # [n, K] views

    def merged(sg, sh):
        sums = torch.stack([sg, sh], dim=1).reshape(-1)  # [2K]: (sg, sh) a k
        if allreduce is not None:
            sums = allreduce(sums)
        sums = sums.view(-1, 2)
        return sums[:, 0], sums[:, 1]

    sg, sh = merged(blocked_sum(g), blocked_sum(h))
    db = eta_t * bias_delta(sg, sh)
    b_new = b + db
    g.copy_(g + h * db[None, :])
    w_new = w.clone()
    for j in range(xt.shape[0]):
        xj = xt[j][:, None]
        sg, sh = merged(blocked_sum(g * xj), blocked_sum(h * (xj * xj)))
        dw = eta_t * coordinate_delta(sg, sh, w[j], lam, alp)
        w_new[j] = w[j] + dw
        g.copy_(g + (h * xj) * dw[None, :])
    return w_new, b_new


@functools.lru_cache(maxsize=None)
def _grid(device_index: int) -> int:
    """B16's cooperative grid on this card: every CTA resident."""
    grid = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        code = _build.library("linear").xrt_linear_ctas(ctypes.byref(grid))
    _build.check(code, "B16's grid")
    if grid.value < 1:
        raise RuntimeError("B16: no CTA fits")
    return grid.value


@functools.lru_cache(maxsize=None)
def _barrier(device_index: int, stream: int) -> torch.Tensor:
    """B16's grid barrier words on one stream of one card (zero between
    launches: every launch leaves its counter at zero)."""
    return torch.zeros(2, dtype=torch.int32,
                       device=torch.device("cuda", device_index))


def _launch(a, dev, what: str) -> None:
    with torch.cuda.device(dev):
        code = _build.library("linear").xrt_linear(ctypes.byref(a),
                                                   _build.stream_ptr(dev))
    _build.check(code, what)
    linear_round.launches += 1


def linear_round(xt: torch.Tensor, gh: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor, eta: float, lam: float, alp: float,
                 allreduce: Optional[Callable] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B16 wrapper: one coordinate-descent round (``linear_round_plain``'s
    contract). CPU tensors take the plain version; CUDA tensors launch the
    kernel of ``csrc/linear.cu``: once for the round at world 1
    (``allreduce`` None), else once for the bias's sums and once a
    coordinate (its update fused with the next one's sums), each
    coordinate's [2K] sums merged by ``allreduce`` between launches: F + 2
    launches. ``linear_round.launches`` counts them."""
    if not gh.is_cuda:
        return linear_round_plain(xt, gh, w, b, eta, lam, alp, allreduce)
    dev = gh.device
    n_feat, n = xt.shape
    k = w.shape[1]
    if not (gh.dtype == torch.float32 and gh.shape == (k, n, 2)
            and gh.is_contiguous() and xt.dtype == torch.float32
            and xt.is_contiguous() and xt.device == dev
            and w.shape == (n_feat, k) and b.shape == (k,)
            and w.dtype == b.dtype == torch.float32
            and w.device == b.device == dev and 1 <= k <= MAX_OUTPUTS
            and n >= 1):
        raise ValueError("linear_round: xt [F, n], gh [K, n, 2], w [F, K] "
                         "and b [K] must be contiguous float32 on one card, "
                         f"1 <= K <= {MAX_OUTPUTS}, n >= 1")
    n_chunks = -(-n // CHUNK_ROWS)
    w, b = w.contiguous(), b.contiguous()
    w_out, b_out = torch.empty_like(w), torch.empty_like(b)
    part = torch.empty(2 * n_chunks * 2 * k, dtype=torch.float32, device=dev)
    sums = torch.empty(2 * k, dtype=torch.float32, device=dev)
    a = _build.LinearArgs()
    a.x, a.gh = (xt.data_ptr() if n_feat else None), gh.data_ptr()
    a.w, a.b = (w.data_ptr() if n_feat else None), b.data_ptr()
    a.w_out = w_out.data_ptr() if n_feat else None
    a.b_out = b_out.data_ptr()
    a.part, a.sums = part.data_ptr(), sums.data_ptr()
    a.bar = _barrier(dev.index, _build.stream_ptr(dev)).data_ptr()
    a.n, a.n_features, a.k, a.n_chunks = n, n_feat, k, n_chunks
    a.eta, a.lam, a.alp = eta, lam, alp
    a.grid = _grid(dev.index)
    if allreduce is None:
        a.mode = _ROUND
        _launch(a, dev, "B16 round")
        return w_out, b_out
    a.mode = _SUMS
    _launch(a, dev, "B16 sums")
    for c in range(-1, n_feat):
        sums.copy_(allreduce(sums))
        a.mode, a.coord = _STEP, c
        _launch(a, dev, "B16 step")
    return w_out, b_out


linear_round.launches = 0

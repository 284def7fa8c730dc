"""BPR's negative stream, worked out again from the seed: plain PyTorch.

The trainer draws each epoch's negatives in its native host prep: for
epoch ``e`` of a fit with ``seed`` the stream seed is ``seed * 1_000_003
+ e``; step ``t`` seeds its own ``std::mt19937_64`` with SplitMix64's
output for ``stream_seed + 0x9e3779b97f4a7c15 * (t + 1)`` and draws its
``B`` negatives with ``std::uniform_int_distribution<int64_t>(0, I - 1)``,
which libstdc++ (GCC 11 and later) takes as the high 64 bits of
``x * I`` and redraws when the low 64 bits fall under ``2**64 mod I``.

Here the same arithmetic runs on int64 tensors, all steps of an epoch at
once: wrapping products, shifts made logical by a mask.
"""

from __future__ import annotations

import torch

_N, _M = 312, 156


def _c(x: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >> 63 else x


_MATRIX_A = _c(0xB5026F5AA96619E9)
_UPPER = _c(0xFFFFFFFF80000000)
_LOWER = 0x7FFFFFFF
_F = _c(6364136223846793005)
_D = _c(0x5555555555555555)
_B = _c(0x71D67FFFEDA60000)
_CT = _c(0xFFF7EEE000000000)
_GOLDEN = _c(0x9E3779B97F4A7C15)
_SM1 = _c(0xBF58476D1CE4E5B9)
_SM2 = _c(0x94D049BB133111EB)


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _splitmix(z: torch.Tensor) -> torch.Tensor:
    z = (z ^ _shr(z, 30)) * _SM1
    z = (z ^ _shr(z, 27)) * _SM2
    return z ^ _shr(z, 31)


def _mt_init(seeds: torch.Tensor) -> torch.Tensor:
    """``std::mt19937_64(seed)``'s state for each seed, ``[S, 312]``."""
    st = torch.empty((seeds.shape[0], _N), dtype=torch.int64,
                     device=seeds.device)
    st[:, 0] = seeds
    for i in range(1, _N):
        prev = st[:, i - 1]
        st[:, i] = _F * (prev ^ _shr(prev, 62)) + i
    return st


def _twist(mt: torch.Tensor) -> torch.Tensor:
    """The next 312 words of every state (the generation step)."""
    def mix(cur, nxt, far):
        x = (cur & _UPPER) | (nxt & _LOWER)
        xa = _shr(x, 1) ^ torch.where((x & 1).bool(),
                                       torch.full_like(x, _MATRIX_A),
                                       torch.zeros_like(x))
        return far ^ xa

    new = torch.empty_like(mt)
    # words 0..155 read only the old state; 156..310 read new 0..154;
    # 311 reads the old 311, the new 0 and the new 155
    new[:, :_M] = mix(mt[:, :_M], mt[:, 1:_M + 1], mt[:, _M:])
    new[:, _M:_N - 1] = mix(mt[:, _M:_N - 1], mt[:, _M + 1:],
                            new[:, :_N - 1 - _M])
    new[:, _N - 1] = mix(mt[:, _N - 1], new[:, 0], new[:, _M - 1])
    return new


def _temper(y: torch.Tensor) -> torch.Tensor:
    y = y ^ (_shr(y, 29) & _D)
    y = y ^ ((y << 17) & _B)
    y = y ^ ((y << 37) & _CT)
    return y ^ _shr(y, 43)


def mt19937_64(seeds: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` outputs of ``std::mt19937_64`` for each seed,
    ``[S, n]`` int64 (the bits of the unsigned outputs)."""
    mt = _mt_init(seeds)
    blocks, have = [], 0
    while have < n:
        mt = _twist(mt)
        blocks.append(_temper(mt))
        have += _N
    return torch.cat(blocks, dim=1)[:, :n]


def _uniform(x: torch.Tensor, I: int):
    """``(value, rejected)`` of libstdc++'s draw from one 64-bit word."""
    hi, lo = _shr(x, 32), x & 0xFFFFFFFF
    mid = lo * I                      # < 2**47
    high = _shr(hi * I + _shr(mid, 32), 32)
    low = x * I                       # the low 64 bits, wrapping
    threshold = (1 << 64) % I
    # unsigned low < threshold (< 2**63): a non-negative int64 below it
    rejected = (low >= 0) & (low < threshold)
    return high, rejected


def negatives(fit_seed: int, epochs, S: int, B: int, I: int,
              device) -> torch.Tensor:
    """int32 ``[len(epochs), S, B]``: the native prep's negatives of the
    given epochs, every step of every epoch generated at once."""
    streams = torch.tensor([_c((int(fit_seed) * 1_000_003 + int(e))
                               & ((1 << 64) - 1)) for e in epochs],
                           dtype=torch.int64, device=device)
    t = torch.arange(1, S + 1, dtype=torch.int64, device=device)
    z = (streams[:, None] + _GOLDEN * t[None, :]).reshape(-1)
    extra = 8
    words = mt19937_64(_splitmix(z), B + extra)
    vals, rej = _uniform(words, I)
    if bool(rej[:, :B].any()):
        # a redraw shifts the rest of that step's stream by one word
        out = torch.empty((len(z), B), dtype=torch.int64, device=device)
        for s in range(len(z)):
            keep = vals[s][~rej[s]]
            if keep.numel() < B:
                raise RuntimeError("negative stream: too many redraws")
            out[s] = keep[:B]
        vals = out
    return vals[:, :B].to(torch.int32).reshape(len(epochs), S, B)


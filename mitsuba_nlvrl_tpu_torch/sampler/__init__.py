"""Film-position sample generators: independent, stratified, multijitter,
ldsampler and orthogonal.

Port of ``mitsuba_nlvrl_tpu/sampler/__init__.py``: the bounce-loop
dimensions come from the counter-based stream of ``core/rng.py``; the
film jitter of each pass, where stratification matters most, comes from
the scene's sampler. Every generator gives the reference's offsets bit
for bit.

The reference computes in uint32. Torch has no full uint32 arithmetic on
the card, so the hashes run on int64 tensors masked to 32 bits after
every step, and a product of two 32-bit values (which can reach 2^64) is
formed from 16-bit halves of one factor (``_mul32``). The per-lane
regeneration jitter (``lane_jitter``, ``lane_uniform2``) is a pure
function of each lane's (pass, pixel) pair, equal in bits to the
reference's.
"""
from __future__ import annotations

import math

import torch

from ..core import math as m
from ..core import rng
from ..core import sync

_MASK = 0xFFFFFFFF


def _mul32(a, b):
    """``(a * b) mod 2**32`` of uint32 values held in int64 (``b`` a
    tensor or a python int): the product of ``a`` with the low and the
    high 16 bits of ``b`` stays below 2**48."""
    lo = b & 0xFFFF
    hi = b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK


def _hash_u32(x, seed: int):
    """Wang-style integer hash, uint32."""
    x = x ^ (seed & _MASK)
    x = (x ^ 61) ^ (x >> 16)
    x = (x * 9) & _MASK
    x = x ^ (x >> 4)
    x = _mul32(x, 0x27d4eb2d)
    return x ^ (x >> 15)


def _vdc_u32(i: int) -> int:
    """Van der Corput radical inverse base 2 (bit reverse) of a pass."""
    i &= _MASK
    i = ((i & 0x55555555) << 1) | ((i & 0xAAAAAAAA) >> 1)
    i = ((i & 0x33333333) << 2) | ((i & 0xCCCCCCCC) >> 2)
    i = ((i & 0x0F0F0F0F) << 4) | ((i & 0xF0F0F0F0) >> 4)
    i = ((i & 0x00FF00FF) << 8) | ((i & 0xFF00FF00) >> 8)
    return ((i << 16) | (i >> 16)) & _MASK


def _sobol2_u32(i: int) -> int:
    """Second dimension of the (0,2)-sequence of a pass."""
    i &= _MASK
    v, r = 1 << 31, 0
    for _ in range(32):
        if i & 1:
            r ^= v
        i, v = i >> 1, v ^ (v >> 1)
    return r


def _cmj_permute(i, l: int, p):
    """Kensler's hash permutation over [0, l): a bijective masked-xorshift
    and odd-multiply mix on the power-of-two superset domain, cycle-walked
    until every value lands in range: the reference's ``while_loop``, one
    counted host read a round. A power-of-two ``l`` is the whole domain,
    so its values land in range at once and nothing is read."""
    l = int(l)
    if l <= 1:
        return torch.zeros_like(i)
    w = l - 1
    for s in (1, 2, 4, 8, 16):
        w |= w >> s

    def mix(x):
        x = x ^ p
        x = _mul32(x, 0xe170893d)
        x = x ^ (p >> 16)
        x = x ^ ((x & w) >> 4)
        x = x ^ (p >> 8)
        x = _mul32(x, 0x0929eb3f)
        x = x ^ (p >> 23)
        x = x ^ ((x & w) >> 1)
        x = (x * (1 | (p >> 27))) & _MASK
        x = _mul32(x, 0x6935fa69)
        x = x ^ ((x & w) >> 11)
        x = _mul32(x, 0x74dcb303)
        x = x ^ ((x & w) >> 2)
        x = _mul32(x, 0x9e501cc3)
        x = x ^ ((x & w) >> 2)
        x = _mul32(x, 0xc860a3df)
        x = x & w
        return x ^ (x >> 5)

    x = mix(i)
    while w + 1 > l and sync.any_on_host(x >= l):
        x = torch.where(x >= l, mix(x), x)
    return ((x + p) & _MASK) % l


def _cmj_randbits(i, p):
    """The jitter bits of Kensler's multi-jitter (its float is
    ``bits * (1 / 4294967808)``)."""
    x = i ^ p
    x = x ^ (x >> 17)
    x = x ^ (x >> 10)
    x = _mul32(x, 0xb36534e5)
    x = x ^ (x >> 12)
    x = x ^ (x >> 21)
    x = _mul32(x, 0x93fc4795)
    x = x ^ 0xdf6e307f
    x = x ^ (x >> 17)
    return (x * (1 | (p >> 18))) & _MASK


_RANDFLOAT_SCALE = 1.0 / 4294967808.0


def _square_factor(spp: int) -> int:
    """The largest divisor of spp not above its square root."""
    a = int(math.sqrt(spp))
    while spp % a:
        a -= 1
    return a


def _is_prime(x: int) -> bool:
    return x >= 2 and all(x % k for k in range(2, int(x ** 0.5) + 1))


def film_jitter(sampler_type: str, key, pass_idx: int, spp: int, N: int,
                device=None):
    """Per-pixel 2D sample offset in [0,1)^2 for pass ``pass_idx`` of
    ``spp`` (pixel index = lane)."""
    if sampler_type == 'independent' or spp <= 1:
        return rng.uniform(key, (N, 2), device)
    lanes = torch.arange(N, dtype=torch.int64, device=device)
    pass_u = int(pass_idx) & _MASK

    if sampler_type == 'ldsampler':
        # scrambled (0,2)-sequence: van der Corput and Sobol' dimension 2
        # over the pass index, XOR-scrambled per pixel
        x = (_vdc_u32(pass_u) ^ _hash_u32(lanes, 0x1234567)).to(
            torch.float32) / 4294967296.0
        y = (_sobol2_u32(pass_u) ^ _hash_u32(lanes, 0x89abcdf)).to(
            torch.float32) / 4294967296.0
        return torch.stack([x, y], dim=-1)

    if sampler_type == 'stratified':
        # a square-ish strata grid; per-pixel permuted stratum index
        a = _square_factor(spp)
        b = spp // a
        s = ((pass_u + _hash_u32(lanes, 977 + 13)) & _MASK) % spp
        u = rng.uniform(key, (N, 2), device)
        sx = torch.remainder(s, a).to(torch.float32)
        sy = torch.div(s, a, rounding_mode='floor').to(torch.float32)
        return torch.stack([(sx + u[:, 0]) * m.rcp32(a),
                            (sy + u[:, 1]) * m.rcp32(b)], dim=-1)

    if sampler_type == 'orthogonal':
        # Bose orthogonal-array strata: r the smallest prime with r^2 >=
        # spp, the sample index permuted over r^2 and mapped to its
        # (a_i0, a_i1) grid cell; each dimension takes its strata from one
        # coordinate and its sub-strata from the other
        r = 2
        while r * r < spp or not _is_prime(r):
            r += 1
        n2 = r * r
        p = _hash_u32(lanes, 0x51633e2d)
        i = _cmj_permute(torch.full_like(lanes, pass_u % n2), n2, p)
        a0 = torch.div(i, r, rounding_mode='floor')
        a1 = torch.remainder(i, r)
        u = rng.uniform(key, (N, 2), device)

        def bose(a_ij, a_ik, j, jit):
            st = _cmj_permute(a_ij, r, _mul32(p, ((j + 1) * 0x51633e2d)
                                              & _MASK))
            sub = _cmj_permute(a_ik, r, _mul32(p, ((j + 1) * 0x68bc21eb)
                                               & _MASK))
            return m.fma(sub.to(torch.float32) + jit, m.rcp32(r),
                         st.to(torch.float32)) * m.rcp32(r)
        return torch.stack([bose(a0, a1, 0, u[:, 0]),
                            bose(a1, a0, 1, u[:, 1])], dim=-1)

    if sampler_type == 'multijitter':
        # Kensler's correlated multi-jitter
        mm = _square_factor(spp)
        nn = spp // mm
        p = _hash_u32(lanes, 0x51633e2d)
        s = _cmj_permute(torch.full_like(lanes, pass_u % spp), spp,
                         _mul32(p, 0x51633e2d))
        s_lo = torch.remainder(s, mm)
        s_hi = torch.div(s, mm, rounding_mode='floor')
        sx = _cmj_permute(s_lo, mm, _mul32(p, 0x68bc21eb))
        sy = _cmj_permute(s_hi, nn, _mul32(p, 0x02e5be93))
        jx = _cmj_randbits(s, _mul32(p, 0x967a889b)).to(torch.float32)
        jy = _cmj_randbits(s, _mul32(p, 0x368cc8b7)).to(torch.float32)
        # ((s % mm) + (sy + jx) / nn) / mm, as the compiled reference
        # rounds it
        x = m.fma(m.fma(jx, _RANDFLOAT_SCALE, sy.to(torch.float32)),
                  m.rcp32(nn), s_lo.to(torch.float32)) * m.rcp32(mm)
        if mm > 1:
            y = m.fma(m.fma(jy, _RANDFLOAT_SCALE, sx.to(torch.float32)),
                      m.rcp32(mm), s_hi.to(torch.float32)) * m.rcp32(nn)
        else:
            # sx is 0 and the division by 1 folds away, so the jitter's
            # product fuses with the sum into s_hi
            y = m.fma(jy, _RANDFLOAT_SCALE, s_hi.to(torch.float32)) \
                * m.rcp32(nn)
        return torch.stack([torch.remainder(x, 1.0),
                            torch.remainder(y, 1.0)], dim=-1)

    # other names draw independent jitter, as the reference does
    return rng.uniform(key, (N, 2), device)


# the samplers whose jitter decomposes into a function of (pass, pixel):
# the regeneration scheduler needs one (integrators/regen.py)
REGEN_SAMPLERS = ('independent', 'ldsampler')


def _vdc_lanes(i):
    """``_vdc_u32`` of every lane of an int64 tensor."""
    i = i & _MASK
    i = ((i & 0x55555555) << 1) | ((i & 0xAAAAAAAA) >> 1)
    i = ((i & 0x33333333) << 2) | ((i & 0xCCCCCCCC) >> 2)
    i = ((i & 0x0F0F0F0F) << 4) | ((i & 0xF0F0F0F0) >> 4)
    i = ((i & 0x00FF00FF) << 8) | ((i & 0xFF00FF00) >> 8)
    return ((i << 16) | (i >> 16)) & _MASK


def _sobol2_lanes(i):
    """``_sobol2_u32`` of every lane of an int64 tensor."""
    i = i & _MASK
    r = torch.zeros_like(i)
    v = 1 << 31
    for _ in range(32):
        r = torch.where((i & 1) > 0, r ^ v, r)
        i, v = i >> 1, v ^ (v >> 1)
    return r


def _u32_to_unit(x):
    return x.to(torch.float32) / 4294967296.0


def lane_jitter(sampler_type: str, pass_lane, pix_lane):
    """The film jitter of the regeneration scheduler: each lane carries
    its own (pass, pixel) pair, and the jitter is a function of both
    alone, so the refill's camera ray and the splat's reconstruction
    compute the same offsets. ``ldsampler``: the scrambled (0,2)-sequence
    of ``film_jitter`` with the global pixel index as the scramble lane;
    ``independent``: counter-hash uniforms of (pass, pixel)."""
    pl = pass_lane.to(torch.int64) & _MASK
    px = pix_lane.to(torch.int64) & _MASK
    if sampler_type == 'ldsampler':
        x = _u32_to_unit(_vdc_lanes(pl) ^ _hash_u32(px, 0x1234567))
        y = _u32_to_unit(_sobol2_lanes(pl) ^ _hash_u32(px, 0x89abcdf))
        return torch.stack([x, y], dim=-1)
    h = _hash_u32(px ^ _mul32(pl, 0x9e3779b9), 0x51ed2701)
    x = _u32_to_unit(_hash_u32(h, 0x68bc21eb))
    y = _u32_to_unit(_hash_u32(h, 0x02e5be93))
    return torch.stack([x, y], dim=-1)


def lane_uniform2(pass_lane, pix_lane, salt: int):
    """Two more uniforms a lane (the aperture's) on the same (pass,
    pixel) stream, independent of ``lane_jitter``."""
    pl = pass_lane.to(torch.int64) & _MASK
    px = pix_lane.to(torch.int64) & _MASK
    h = _hash_u32(px ^ _mul32(pl, 0x9e3779b9), salt)
    x = _u32_to_unit(_hash_u32(h, 0x7feb352d))
    y = _u32_to_unit(_hash_u32(h, 0x846ca68b))
    return torch.stack([x, y], dim=-1)

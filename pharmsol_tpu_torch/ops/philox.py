"""Philox4x32-10 and Box-Muller normals in plain PyTorch, and the counter
layout that the fused SDE kernel shares with its twin.

The fused SDE psi kernel (``csrc/fused_sde.cu``) draws its noise from a
counter-based generator, Philox4x32 with 10 rounds (Salmon et al., "Parallel
random numbers: as easy as 1, 2, 3", SC 2011; the Random123 constants). Every
draw is a pure function of (seed, row, support, segment, trial, draw slot,
particle), so the kernel and its plain twin
(:func:`~.fused_sde.psi_sde_plain`) see the same normals and uniforms, and
nothing depends on the order in which the card runs its blocks.

Counter layout (four 32-bit words) and key (two words):

- ``c0 = particle + (segment << 16)``
- ``c1 = trial + (slot << 17) + (group << 20)``
- ``c2 = support``, ``c3 = row``
- ``key = (seed mod 2^32, (seed >> 32) mod 2^32)``

Field widths: particle < 2^16 (the kernel takes at most 4096), segment <
2^16 (checked by the wrapper), trial < 2^17 (a march stops after 100 000
trials; the passes of a lagged segment share the field), slot < 2^3, group < 2^12.

``trial`` counts the Euler-Maruyama trials of one segment from 0. With lag
(kernel K3b) a segment's march splits at the fire times into passes, each
with its controller restarted; the count runs on across the passes of the
segment, so no two trials of a segment share a counter and kernel and twin
number them alike. ``slot``
names the draw: 0, 1, 2 are the full step and the two half steps
(``em_control='independent'``) or 0, 1 the two half-step increments
(``'coupled'``); :data:`SLOT_RESAMPLE` is the stratified-resampling uniform of
an observation (trial 0, group 0). One Philox call gives the normals of one
group of states: four in float32 (24-bit uniforms, two Box-Muller pairs), two
in float64 (53-bit uniforms from two words each, one pair). Uniforms lie in
(0, 1], so the logarithm of Box-Muller stays finite.

torch has no unsigned 32-bit multiply-high, and a 32 x 32-bit product does not
fit in int64, so :func:`_mulhilo` splits the multiplier into 16-bit halves:
every intermediate stays below 2^49.
"""

from __future__ import annotations

import math

import torch

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
ROUNDS = 10
MASK32 = 0xFFFFFFFF

SLOT_RESAMPLE = 3
MAX_SEGMENTS = 1 << 16

TWO_PI = 2.0 * math.pi


def normals_per_call(dtype: torch.dtype) -> int:
    """Normals one Philox call gives: 4 in float32, 2 in float64."""
    return 4 if dtype == torch.float32 else 2


def seed_key(seed: int) -> tuple:
    """The Philox key of a model seed."""
    seed = int(seed) % (1 << 64)
    return seed & MASK32, (seed >> 32) & MASK32


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product m * x, for a constant
    m < 2^32 and int64 words 0 <= x < 2^32."""
    ml, mh = m & 0xFFFF, m >> 16
    a = x * ml  # < 2^48
    b = x * mh  # < 2^48
    t = a + ((b & 0xFFFF) << 16)  # < 2^49
    return (b >> 16) + (t >> 32), t & MASK32


def philox4x32(c0, c1, c2, c3, key: tuple):
    """Philox4x32-10 of the counter words (int64 tensors or ints in
    [0, 2^32), broadcast together) under ``key`` (two ints). Returns the four
    output words as int64 tensors."""
    def as_t(v):
        return v if isinstance(v, torch.Tensor) else torch.tensor(v, dtype=torch.int64)

    c0, c1, c2, c3 = (as_t(v) for v in (c0, c1, c2, c3))
    k0, k1 = key
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def counter_words(particle, segment: int, trial, slot, group, support, row):
    """The four counter words of the layout above (ints or int64 tensors
    that broadcast together)."""
    return (particle + (segment << 16), trial + (slot << 17) + (group << 20),
            support, row)


def uniforms_from_words(words, dtype: torch.dtype):
    """Uniforms in (0, 1] from Philox output words: one per word in float32
    (24 bits), one per word pair in float64 (53 bits)."""
    if dtype == torch.float32:
        return [((w >> 8) + 1).to(torch.float32) * (2.0 ** -24) for w in words]
    out = []
    for hi, lo in zip(words[0::2], words[1::2]):
        v = ((hi >> 5) << 26) + (lo >> 6) + 1  # <= 2^53, exact in float64
        out.append(v.to(torch.float64) * (2.0 ** -53))
    return out


def box_muller(uniforms):
    """Standard normals from uniforms in (0, 1], pairwise:
    ``r = sqrt(-2 log u_a)``, ``(r cos 2 pi u_b, r sin 2 pi u_b)``."""
    out = []
    for ua, ub in zip(uniforms[0::2], uniforms[1::2]):
        r = torch.sqrt(-2.0 * torch.log(ua))
        th = TWO_PI * ub
        out += [r * torch.cos(th), r * torch.sin(th)]
    return out


def normals(dtype: torch.dtype, *, particle, segment: int, trial, slot,
            group, support, row, key: tuple):
    """The normals of one Philox call per counter (4 in float32, 2 in
    float64), as a list of tensors broadcast over the counter fields."""
    words = philox4x32(*counter_words(particle, segment, trial, slot, group,
                                      support, row), key)
    return box_muller(uniforms_from_words(words, dtype))


def resample_uniform(dtype: torch.dtype, *, particle, segment: int, support,
                     row, key: tuple):
    """The stratified-resampling uniform of each particle at an observation
    in ``segment`` (slot :data:`SLOT_RESAMPLE`, trial 0, group 0)."""
    words = philox4x32(*counter_words(particle, segment, 0, SLOT_RESAMPLE, 0,
                                      support, row), key)
    return uniforms_from_words(words, dtype)[0]

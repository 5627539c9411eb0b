"""Padded, hash-shuffled, Owen-scrambled Sobol (0,2)-sequence sampling (port
of optixpathtracer_tpu/core/sobol.py, bit-exact).

Construction (Burley, "Practical Hash-based Owen Scrambling", JCGT 2020):
the first two Sobol dimensions form a (0,2)-sequence; each (pixel,
dimension pair) gets its own copy by a nested uniform scramble of the index
(aligned blocks map to aligned blocks, so prefix stratification survives)
and of each output dimension. Every 2D pair along a path uses the same two
dimensions with independent seeds.

uint32 words live in int64 tensors holding values in [0, 2**32), as in
core/rng.py. The one product (`_laine_karras`) would overflow int64, so it
goes through `mul32`. Bit reversal and the second dimension are linear
over GF(2) per byte, so each is taken as four 256-entry table lookups
(`reverse_bits32`, `_sobol_dim2`): the same bits as the reference's
shift-and-mask ladder and 32-step XOR, in far fewer eager launches.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .rng import M32, mul32, u32

Tensor = torch.Tensor


def _dim2_directions() -> np.ndarray:
    """Direction numbers for Sobol dimension 2 (primitive polynomial x+1):
    m_1 = 1, m_k = 2 m_{k-1} xor m_{k-1}; v_k = m_k << (32-k)."""
    m = [1]
    for _ in range(31):
        m.append((2 * m[-1]) ^ m[-1])
    return np.array([mk << (32 - k - 1) for k, mk in enumerate(m)], np.uint32)


_V2 = _dim2_directions()  # (32,) uint32


def _byte_tables() -> np.ndarray:
    """(2, 4, 256) int64: [0] bit reversal of byte k placed in the output's
    byte 3-k; [1] the XOR of the dimension-2 direction numbers of byte k's
    set bits."""
    b = np.arange(256)
    rev = np.array([int(f"{v:08b}"[::-1], 2) for v in b], np.int64)
    out = np.zeros((2, 4, 256), np.int64)
    for k in range(4):
        out[0, k] = rev << (8 * (3 - k))
        for j in range(8):
            out[1, k] ^= np.where((b >> j) & 1, np.int64(_V2[8 * k + j]), 0)
    return out


_TABLES = _byte_tables()


@functools.lru_cache(maxsize=None)
def _tables_on(device: torch.device) -> Tensor:
    return torch.as_tensor(_TABLES, device=device)


def _bytewise(x: Tensor, table: int) -> Tensor:
    """XOR of the four byte lookups of x in one of `_TABLES`."""
    t = _tables_on(x.device)[table]
    out = t[0][x & 0xFF]
    for k in range(1, 4):
        out = out ^ t[k][(x >> (8 * k)) & 0xFF]
    return out


def reverse_bits32(x: Tensor) -> Tensor:
    return _bytewise(u32(x), 0)


def _laine_karras(x: Tensor, seed) -> Tensor:
    """Laine-Karras style hash: a random bit-b flip may depend only on bits
    below b, which after the surrounding bit reversals realises a nested
    uniform (Owen) scramble. Constants from Burley JCGT 2020."""
    x = (x + seed) & M32
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ mul32(x, c)
    return x


def nested_uniform_scramble(x: Tensor, seed) -> Tensor:
    """Hash-based Owen scramble of a uint32 (binary-tree subtree swaps keyed
    on the path from the MSB). Aligned dyadic blocks map to aligned blocks."""
    return reverse_bits32(_laine_karras(reverse_bits32(x), seed))


def _sobol_dim2(index: Tensor) -> Tensor:
    """Second Sobol dimension: XOR of direction numbers over set index bits."""
    return _bytewise(u32(index), 1)


def _u32_to_unit(bits: Tensor) -> Tensor:
    """uint32 -> [0, 1) float32: rounded to the nearest f32, times 2**-32,
    clamped at 0.999999 (the engine's clamp convention)."""
    return torch.clamp(bits.to(torch.float32) * (1.0 / 4294967296.0), max=0.999999)


def sobol02_bits(index: Tensor, shuffle_seed, seed_x, seed_y) -> tuple[Tensor, Tensor]:
    """Shuffled + scrambled (0,2)-point for `index`, as raw uint32 bits."""
    i = nested_uniform_scramble(index, u32(shuffle_seed))
    x = reverse_bits32(i)  # Sobol dim 1 == van der Corput
    y = _sobol_dim2(i)
    return nested_uniform_scramble(x, u32(seed_x)), nested_uniform_scramble(y, u32(seed_y))


def sobol02_point(index: Tensor, shuffle_seed, seed_x, seed_y) -> tuple[Tensor, Tensor]:
    """Shuffled + scrambled (0,2)-point in [0,1)^2."""
    x, y = sobol02_bits(index, shuffle_seed, seed_x, seed_y)
    return _u32_to_unit(x), _u32_to_unit(y)

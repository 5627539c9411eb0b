"""Counter-based per-ray RNG: tea seeding + the two-word xorshift stream.

Port of optixpathtracer_tpu/core/rng.py, bit-exact. PyTorch has few uint32
ops, so every uint32 word lives in an int64 tensor holding a value in
[0, 2**32), masked back into range after each operation. The one product
(`s1 * s2` in `rand_bits`) would overflow int64, so it is taken in 16-bit
halves that keep the low 32 bits exact.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

M32 = 0xFFFFFFFF
_INV_U32 = float(np.float32(1.0 / 4294967295.0))


def u32(x):
    """Integer tensor (or Python int) -> its low 32 bits (int64 tensor)."""
    if isinstance(x, int):
        return x & M32
    return x.to(torch.int64) & M32


def as_i32_bits(x: Tensor) -> Tensor:
    """int64 tensor of uint32 values -> int32 tensor of the same bit pattern."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def mul32(a: Tensor, b: Tensor) -> Tensor:
    """(a * b) mod 2**32 for int64 tensors holding uint32 values."""
    return ((a & 0xFFFF) * b + (((a >> 16) * (b & 0xFFFF)) << 16)) & M32


def lcg(prev: Tensor) -> Tuple[Tensor, Tensor]:
    """LCG step (cuda/random.h:53-59): (new state, its low-24-bit value).
    The product of a uint32 and 1664525 stays below 2**53, so int64 holds
    it exactly before the 24-bit mask."""
    nxt = (u32(prev) * 1664525 + 1013904223) & 0x00FFFFFF
    return nxt, nxt


def rnd_step(seed: Tensor) -> Tuple[Tensor, Tensor]:
    """cuda/random.h rnd(): uniform in [0, 1) from an LCG, advancing the seed."""
    nxt, bits = lcg(seed)
    return nxt, bits.to(torch.float32) / float(1 << 24)  # a power of two: exact on every device


def tea(val0: Tensor, val1: Tensor, rounds: int = 4) -> Tensor:
    """TEA hash of two uint32 streams (cuda/random.h:34-49 semantics)."""
    v0 = u32(val0)
    v1 = u32(val1)
    s = 0
    for _ in range(rounds):
        s = (s + 0x9E3779B9) & M32
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) & M32) ^ ((v1 + s) & M32)
                    ^ (((v1 >> 5) + 0xC8013EA4) & M32))) & M32
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) & M32) ^ ((v0 + s) & M32)
                    ^ (((v0 >> 5) + 0x7E95761E) & M32))) & M32
    return v0


class RngState(NamedTuple):
    """Two-seed xorshift/rotate generator state (maths.h Random, :170-225);
    each word an int64 tensor holding a uint32."""

    s1: Tensor
    s2: Tensor

    @staticmethod
    def seed(seed: Tensor) -> "RngState":
        """Random(seed) ctor: s1 = 315645664 + seed, s2 = s1 ^ 0x13ab45fe."""
        s1 = (u32(seed) + 315645664) & M32
        return RngState(s1, s1 ^ 0x13AB45FE)

    @staticmethod
    def for_pixels(pixel_index: Tensor, subframe) -> "RngState":
        """Per-pixel stream: Random(tea4(pixel_index, subframe))."""
        sub = torch.broadcast_to(u32(torch.as_tensor(subframe, device=pixel_index.device)),
                                 pixel_index.shape)
        return RngState.seed(tea(u32(pixel_index), sub))


def _rotl(x: Tensor, k: int) -> Tensor:
    return ((x << k) & M32) | (x >> (32 - k))


def rand_bits(state: RngState) -> Tuple[RngState, Tensor]:
    """One generator step; returns (next_state, uint32 bits). maths.h Rand()."""
    s1, s2 = state
    s1n = (s2 ^ _rotl(s1, 5)) ^ mul32(s1, s2)
    s2n = s1n ^ _rotl(s2, 12)
    return RngState(s1n, s2n), s1n


def randf(state: RngState) -> Tuple[RngState, Tensor]:
    """Uniform float32 in [0, 0.999999] (maths.h Randf clamps the top)."""
    state, bits = rand_bits(state)
    u = bits.to(torch.float32) * _INV_U32
    return state, torch.clamp(u, 0.0, 0.999999)


def randf2(state: RngState) -> Tuple[RngState, Tensor, Tensor]:
    """Two uniforms — the reference's Sample2D with USE_RANDOM=1."""
    state, u1 = randf(state)
    state, u2 = randf(state)
    return state, u1, u2

"""Disney/principled material model as a structure-of-arrays table (port of
optixpathtracer_tpu/core/materials.py). Same fields, defaults and the same
(M, 24) wide-row packing: `take` is one row gather per hit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .math import Vec3

Tensor = torch.Tensor

MATERIAL_FLAG_SHADOW_CATCHER = 1 << 0

_VEC3_FIELDS = ("color", "emission", "absorption")  # packed at 0/3/6
_SCALAR_FIELDS = (  # packed at 9..22
    "eta", "metallic", "subsurface", "specular", "roughness",
    "specular_tint", "anisotropic", "sheen", "sheen_tint", "clearcoat",
    "clearcoat_gloss", "transmission", "flags", "texture_id",
)
_INT_FIELDS = ("flags", "texture_id")


class MaterialTable(NamedTuple):
    """One row per material; every field shape (M,) (Vec3 fields are SoA)."""

    color: Vec3
    emission: Vec3
    absorption: Vec3
    eta: Tensor
    metallic: Tensor
    subsurface: Tensor
    specular: Tensor
    roughness: Tensor
    specular_tint: Tensor
    anisotropic: Tensor
    sheen: Tensor
    sheen_tint: Tensor
    clearcoat: Tensor
    clearcoat_gloss: Tensor
    transmission: Tensor
    flags: Tensor  # int32 bitfield
    texture_id: Tensor  # int32, -1 = untextured
    rows: Tensor | None = None  # (M, 24) f32 packed copy of every field

    def take(self, idx: Tensor) -> "MaterialTable":
        """Gather per-hit material rows (the SBT-record fetch equivalent)."""
        return _unpack_rows(self.rows[idx])

    def index_of_refraction(self) -> Tensor:
        """Material.h GetIndexOfRefraction: eta==0 infers IoR from specular."""
        inferred = 2.0 / (1.0 - torch.sqrt(0.08 * self.specular)) - 1.0
        return torch.where(self.eta == 0.0, inferred, self.eta)


def _unpack_rows(r: Tensor, packed: Tensor | None = None) -> MaterialTable:
    fields = {}
    for j, name in enumerate(_VEC3_FIELDS):
        fields[name] = Vec3(r[..., 3 * j], r[..., 3 * j + 1], r[..., 3 * j + 2])
    for j, name in enumerate(_SCALAR_FIELDS):
        col = r[..., 9 + j]
        fields[name] = col.to(torch.int32) if name in _INT_FIELDS else col
    return MaterialTable(rows=packed, **fields)


_DEFAULTS = dict(
    color=(0.6, 0.6, 0.6),
    emission=(0.0, 0.0, 0.0),
    absorption=(0.0, 0.0, 0.0),
    eta=0.0,
    metallic=0.0,
    subsurface=0.0,
    specular=0.5,
    roughness=1.0,
    specular_tint=0.0,
    anisotropic=0.0,
    sheen=0.0,
    sheen_tint=0.0,
    clearcoat=0.0,
    clearcoat_gloss=1.0,
    transmission=0.0,
    flags=0,
    texture_id=-1,
)


def make_material(**overrides) -> dict:
    """A single material spec as a plain dict with reference defaults."""
    mat = dict(_DEFAULTS)
    for k, v in overrides.items():
        if k not in mat:
            raise KeyError(f"unknown material field: {k}")
        mat[k] = v
    return mat


def pack_rows(materials: list[dict]) -> np.ndarray:
    """(M, 24) float32 rows: color|emission|absorption at 0/3/6, then the
    scalar fields in `_SCALAR_FIELDS` order (ints ride as exact floats)."""
    packed = np.zeros((len(materials), 24), np.float32)
    for j, name in enumerate(_VEC3_FIELDS):
        packed[:, 3 * j : 3 * j + 3] = np.array([m[name] for m in materials], np.float32)
    for j, name in enumerate(_SCALAR_FIELDS):
        packed[:, 9 + j] = np.array([m[name] for m in materials], np.float32)
    return packed


def table_from_rows(packed: np.ndarray, device) -> MaterialTable:
    """MaterialTable on `device` from packed (M, 24) rows."""
    rows = torch.as_tensor(np.array(packed, np.float32), device=device)
    return _unpack_rows(rows, packed=rows)


def build_table(materials: list[dict], device) -> MaterialTable:
    """Pack a list of material dicts into a SoA table on `device`."""
    return table_from_rows(pack_rows(materials or [make_material()]), device)

"""The wavefront path-trace engine (port of
optixpathtracer_tpu/engine/wavefront.py).

One SoA wavefront per launch: raygen with jittered AA, then per bounce an
optional coherence sort of the path state, one closest-hit sweep, hit
geometry, probe next-event estimation with balance-heuristic MIS and its
any-hit shadow sweep, and a Disney BSDF continuation. The RNG is the
reference's counter-based tea/xorshift stream (core/rng.py), so every lane
draws the same numbers as the JAX engine. `sampling=` "stratified", "blue"
and "sobol" replace the AA, NEE and BSDF pairs with low-discrepancy ones
(`_ld_bases`, `_sobol_pair`) after the stream has drawn them, so the
stream advances alike under every strategy.

The options not ported yet raise NotImplementedError naming the ROADMAP
item that ports them (see `_check_supported`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..builder import CompiledScene
from ..core.materials import MATERIAL_FLAG_SHADOW_CATCHER
from ..core.math import (
    Vec3,
    basis_from_vector,
    cross,
    dot,
    faceforward,
    luminance,
    normalize,
    where,
)
from ..core.rng import M32, RngState, as_i32_bits, randf, randf2, tea
from ..core.sampling import projective_blue_noise
from ..core.sobol import _u32_to_unit, sobol02_point
from ..lights.lights import QuadLight, sample_parallelogram
from ..lights.probe import Probe, dir_to_uv, probe_eval, probe_sample
from ..ops.traverse_cluster import any_hit_cluster, closest_hit_cluster
from ..shade import disney

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Launch knobs; the same fields and defaults as the JAX RenderConfig.
    The port implements traversal="cluster" only."""

    width: int = 1200
    height: int = 1024
    samples_per_launch: int = 32
    max_depth: int = 8
    t_min: float = 1e-3
    t_max: float = 1e16
    shadow_t_min: float = 0.01
    probe_samples: float = 1.0
    bsdf_samples: float = 1.0
    use_shading_normals: bool = False
    antialias: bool = True
    clamp_radiance: float = 10.0
    traversal: str = "lockstep"
    bfs_cap_factor: int = 4
    dispatch_tiles: int = 1  # sequential pixel chunks per launch
    batch_spp: bool = False  # all samples in ONE expanded wavefront
    fused_shadows: bool = False
    env_via_bsdf: bool = False
    emission_all_bounces: bool = False
    unroll: bool = False  # no effect here: loops are Python loops
    nee_final_bounce: bool = True  # False peels the last bounce without NEE
    nee_rr: float = 0.0
    sampling: str = "random"
    sampling_strata: int = 64
    russian_roulette: bool = False
    rr_start_depth: int = 2
    rr_min_prob: float = 0.05
    sort_rays: bool = False  # coherence-sort the path state every bounce


def _check_supported(cfg: RenderConfig, **extras) -> None:
    """Raise for options whose port is a later ROADMAP item."""
    off = {
        "fused_shadows": (cfg.fused_shadows, "A.5"),
        "env_via_bsdf": (cfg.env_via_bsdf, "A.5"),
        "nee_rr": (cfg.nee_rr > 0.0, "A.5"),
        f"traversal={cfg.traversal!r}": (cfg.traversal != "cluster", "A 'not to port'"),
        "demand_pool": (extras.get("demand_pool") is not None, "A.11"),
    }
    for name, (on, item) in off.items():
        if on:
            raise NotImplementedError(f"{name} is not ported yet (ROADMAP {item})")


class CameraParams(NamedTuple):
    """Raygen uniforms: 0-dim float32 tensors on the render device."""

    eye: Vec3
    u: Vec3
    v: Vec3
    w: Vec3

    @staticmethod
    def from_camera(cam, device) -> "CameraParams":
        uu, vv, ww = cam.uvw_frame()
        return CameraParams(*(
            Vec3.of(*(float(np.float32(c)) for c in vec), device=device)
            for vec in (cam.eye, uu, vv, ww)
        ))


class SampleOutput(NamedTuple):
    """Per-pixel sums over samples_per_launch (all shapes (N,))."""

    color: Vec3  # backplate-composited radiance sum (pre 1/spp)
    alpha: Vec3
    normal: Vec3  # first-bounce AOV mean
    albedo: Vec3
    depth: Tensor
    rays_traced: Tensor  # int64 scalar: radiance + shadow rays traced
    bfs_overflow: Tensor  # scalar, always 0 (the cluster backend is exact)


def _hit_geometry(cs: CompiledScene, rec, ray_dir: Vec3, use_shading: bool):
    """Per-hit normal, material and albedo (the SBT-record stage): the
    albedo is the bilinear texture fetch at the hit's interpolated uv where
    the material has a texture, else its color."""
    if cs.clusters is not None and cs.clusters.instanced:
        raise NotImplementedError("instanced scenes are ROADMAP A.9")
    scene = cs.scene
    tri = torch.clamp(rec.tri, min=0).to(torch.int64)
    v0, v1, v2, sn0, sn1, sn2, uv6, mat_id, has = scene.take_shade(tri)
    n_geom = normalize(cross(v1 - v0, v2 - v0))
    if use_shading:
        w0 = 1.0 - rec.u - rec.v
        ns = sn0 * w0 + sn1 * rec.u + sn2 * rec.v
        n = normalize(where(has, ns, n_geom))
    else:
        n = n_geom
    # faceforward against the incoming ray (deviceProgram.cu:492)
    n = faceforward(n, -ray_dir, n)
    mat = scene.materials.take(mat_id.to(torch.int64))
    if not scene.textured:
        return n, mat, mat.color
    uv0u, uv0v, uv1u, uv1v, uv2u, uv2v = uv6
    w0 = 1.0 - rec.u - rec.v
    tu = uv0u * w0 + uv1u * rec.u + uv2u * rec.v
    tv = uv0v * w0 + uv1v * rec.u + uv2v * rec.v
    tex = scene.textures.sample_bilinear(mat.texture_id, tu, tv)
    return n, mat, where(mat.texture_id >= 0, tex, mat.color)


def _spread3(x: Tensor) -> Tensor:
    """Spread the low 10 bits of x so consecutive bits land 3 apart."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _coherence_key(o: Vec3, d: Vec3, done: Tensor, aabb: Tensor) -> Tensor:
    """Spatial sort key (uint32 value held in int64, ascending = good block
    order): dead(1) | direction octant(3) | origin Morton 18 | direction
    magnitude Morton (top 10). Dead rays set bit 31; the key is a
    non-negative int64, so they sort last."""

    def q6(a, lo, hi):
        s = 64.0 / torch.clamp(hi - lo, min=1e-6)
        return torch.clamp((a - lo) * s, 0.0, 63.0).to(torch.int64)

    om = (
        _spread3(q6(o.x, aabb[0], aabb[3]))
        | (_spread3(q6(o.y, aabb[1], aabb[4])) << 1)
        | (_spread3(q6(o.z, aabb[2], aabb[5])) << 2)
    )
    oct_ = (d.x < 0).to(torch.int64) * 4 + (d.y < 0).to(torch.int64) * 2 + (d.z < 0).to(torch.int64)

    def qd(a):
        return torch.clamp(a.abs() * 16.0, 0.0, 15.0).to(torch.int64)

    dm = _spread3(qd(d.x)) | (_spread3(qd(d.y)) << 1) | (_spread3(qd(d.z)) << 2)
    return (done.to(torch.int64) << 31) | (oct_ << 28) | (om << 10) | (dm >> 2)


def _stable_argsort(key: Tensor) -> Tensor:
    """Permutation sorting `key` ascending, ties in lane order (lax.sort)."""
    return torch.sort(key, stable=True).indices


def _pack_i32(leaves: list[Tensor]) -> Tensor:
    """Bit-pack same-length (N,) leaves into one (N, F) int32 matrix: bools
    widen, int32 moves as is, float32 as its bit pattern, int64 as the low
    32 bits (the RNG words are uint32 values held in int64)."""
    cols = []
    for x in leaves:
        if x.dtype == torch.bool or x.dtype == torch.int32:
            cols.append(x.to(torch.int32))
        elif x.dtype == torch.int64:
            cols.append(as_i32_bits(x))
        elif x.dtype == torch.float32:
            cols.append(x.view(torch.int32))
        else:
            raise TypeError(f"cannot pack {x.dtype}")
    return torch.stack(cols, dim=1)


def _unpack_i32(packed: Tensor, protos: list[Tensor]) -> list[Tensor]:
    out = []
    for i, p in enumerate(protos):
        col = packed[:, i].contiguous()
        if p.dtype == torch.bool:
            out.append(col != 0)
        elif p.dtype == torch.int32:
            out.append(col)
        elif p.dtype == torch.int64:
            out.append(col.to(torch.int64) & M32)
        else:
            out.append(col.view(torch.float32))
    return out


def permute_packed(leaves: list[Tensor], perm: Tensor) -> list[Tensor]:
    """Apply one permutation to many (N,) tensors with one (N, F) int32
    row gather of their bit-packed columns (bit-exact for every dtype)."""
    return _unpack_i32(_pack_i32(leaves)[perm], leaves)


def _flatten_path(path: dict):
    """(names, leaves) of the per-lane tensors of a path dict."""
    names, leaves = [], []
    for k in sorted(path):
        v = path[k]
        if isinstance(v, tuple):  # Vec3 / RngState
            for j, c in enumerate(v):
                names.append((k, j))
                leaves.append(c)
        elif isinstance(v, Tensor) and v.dim() == 1:
            names.append((k, None))
            leaves.append(v)
    return names, leaves


def _sort_path(path: dict, key: Tensor) -> dict:
    """Reorder every per-lane leaf of the path state by ascending key."""
    names, leaves = _flatten_path(path)
    moved = permute_packed(leaves, _stable_argsort(key))
    out = dict(path)
    groups: dict = {}
    for (k, j), v in zip(names, moved):
        if j is None:
            out[k] = v
        else:
            groups.setdefault(k, []).append(v)
    for k, comps in groups.items():
        out[k] = type(path[k])(*comps)
    return out


# distinct salts decorrelate the dimension pairs (AA / NEE / BSDF) per pixel
_LD_SALT_AA = 0x51ED270B
_LD_SALT_NEE = 0x85EBCA6B
_LD_SALT_BSDF = 0xC2B2AE35


@functools.lru_cache(maxsize=4)
def _blue_noise_table(m: int) -> np.ndarray:
    """(m, 2) float32 blue-noise table of `sampling="blue"`; the dart
    throwing is a Python loop of m rounds, so it is built once per m."""
    return projective_blue_noise(m, dim=2, candidates=24, seed=7)


def _sobol_pair(pix: Tensor, ctr: Tensor, depth: int, salt: int) -> tuple[Tensor, Tensor]:
    """One padded Owen-Sobol dimension pair for sample `ctr` of each pixel
    at bounce `depth` (`sampling="sobol"`): each (pixel, depth, salt) keys
    an independently shuffled and scrambled copy of the (0,2)-sequence, and
    `ctr` indexes into it (core/sobol.py). `depth * 0x9E3779B9` wraps as
    uint32."""
    s0 = tea(pix, ((depth * 0x9E3779B9) & M32) ^ salt)
    return sobol02_point(ctr, s0, tea(s0, 0x68BC21EB), tea(s0, 0x02E5BE93))


def _ld_bases(cfg: RenderConfig, pix_index: Tensor, ctr: Tensor, salt: int):
    """Deterministic low-discrepancy stratum base for sample `ctr` of each
    pixel, for one dimension pair. Returns (b1, b2, scale): the consumer
    draws jitter (j1, j2) from the RNG stream and uses b + j * scale.

    stratified: base = stratum corner, scale = 1/sqrt(m), strata visited in
    a per-pixel rotated order. blue: base = a blue-noise point under a fresh
    per-(pixel, m-sample epoch) Cranley-Patterson rotation, scale = 0.
    `ctr + off` wraps as uint32 before the modulo and the division."""
    m = cfg.sampling_strata
    off = tea(pix_index, salt)
    wrapped = (ctr + off) & M32
    idx = wrapped % m
    if cfg.sampling == "stratified":
        dx = int(round(m ** 0.5))
        if dx * dx != m:
            raise ValueError(f"sampling_strata={m} must be a perfect square")
        # a device divisor: CUDA takes x / (Python float) as x * (1 / float)
        d = torch.tensor(float(dx), dtype=torch.float32, device=idx.device)
        return (idx % dx).to(torch.float32) / d, (idx // dx).to(torch.float32) / d, 1.0 / dx
    if cfg.sampling == "blue":
        table = torch.as_tensor(_blue_noise_table(m), device=pix_index.device)
        epoch = wrapped // m
        r1 = _u32_to_unit(tea(pix_index ^ salt, epoch * 2))
        r2 = _u32_to_unit(tea(pix_index ^ salt, epoch * 2 + 1))
        pt = table[idx]
        return torch.remainder(pt[:, 0] + r1, 1.0), torch.remainder(pt[:, 1] + r2, 1.0), 0.0
    raise ValueError(f"unknown sampling strategy {cfg.sampling!r}")


def _nee_sample(probe, cfg, n, wo, mat, albedo, eta_i, eta_o, state, u12=None):
    """Draw the probe NEE sample and its MIS-weighted contribution without
    tracing visibility (SampleLights math, deviceProgram.cu:252-292). u12:
    optional low-discrepancy pair for the probe draw (`cfg.sampling`)."""
    state, wi, sky_color, sky_pdf = probe_sample(probe, state, u12=u12)
    b_pdf = disney.bsdf_pdf(mat, eta_i, eta_o, n, wo, wi)
    f = disney.bsdf_eval(mat, albedo, eta_i, eta_o, n, wo, wi)

    n_total = cfg.probe_samples + cfg.bsdf_samples
    c_bsdf = cfg.bsdf_samples / n_total
    c_sky = cfg.probe_samples / n_total
    weight = c_sky * sky_pdf / torch.clamp(c_bsdf * b_pdf + c_sky * sky_pdf, min=1e-12)

    valid = (b_pdf > 0.0) & (weight > 0.0) & (sky_pdf > 0.0)
    scale = weight * dot(wi, n).abs() / torch.clamp(sky_pdf, min=1e-12) / cfg.probe_samples
    contrib = sky_color * f * scale
    return state, wi, contrib, valid


def _any_hit_sorted(cs: CompiledScene, cfg: RenderConfig, o: Vec3, d: Vec3, t_min, t_max: Tensor):
    """Occlusion sweep with its own coherence sort (shadow rays inherit the
    radiance order but point anywhere), scattered back to lane order.
    Results are identical to the unsorted sweep (occlusion is per ray)."""
    if not cfg.sort_rays:
        return any_hit_cluster(cs.clusters, o, d, t_min, t_max)
    n = o.x.shape[0]
    dead = t_max <= t_min
    perm = _stable_argsort(_coherence_key(o, d, dead, cs.clusters.scene_aabb))
    sx, sy, sz, sdx, sdy, sdz, stm = permute_packed([*o, *d, t_max], perm)
    occ, ovf = any_hit_cluster(cs.clusters, Vec3(sx, sy, sz), Vec3(sdx, sdy, sdz), t_min, stm)
    occ_u = torch.empty((n,), dtype=torch.bool, device=occ.device)
    occ_u[perm] = occ  # boolean scatter back to lane order (perm is unique)
    return occ_u, ovf


def _nee(cs, probe, cfg, p, n, wo, mat, albedo, eta_i, eta_o, active, state, u12=None):
    """NEE with immediate visibility. Returns (state, lit, shadowed, traced):
    every shaded hit traces its shadow ray, even an invalid sample
    (deviceProgram.cu:264-277 traces before checking pdfs)."""
    state, wi, contrib, valid = _nee_sample(probe, cfg, n, wo, mat, albedo, eta_i, eta_o, state,
                                            u12=u12)
    t_max = torch.where(active, cfg.t_max, 0.0)
    occluded, _ = _any_hit_sorted(cs, cfg, p, wi, cfg.shadow_t_min, t_max)
    zero = Vec3(*(torch.zeros_like(valid, dtype=torch.float32),) * 3)
    lit = where(valid & ~occluded, contrib, zero)
    shadowed = where(valid & occluded, contrib, zero)
    return state, lit, shadowed, active


def _quad_nee(cs, cfg, light: QuadLight, p, n, wo, mat, albedo, eta_i, eta_o, active, state):
    """Area-light NEE against the single parallelogram light, with
    balance-heuristic MIS against the BSDF (a two-sided emitter). Returns
    (state, contribution where visible, traced): `traced` marks the lanes
    that trace a shadow ray, which `rays_traced` leaves out, as the
    reference does."""
    state, q, ln, _area = sample_parallelogram(light.corner, light.v1, light.v2, state)
    to_q = q - p
    dist2 = torch.clamp(dot(to_q, to_q), min=1e-12)
    dist = torch.sqrt(dist2)
    wi = to_q / dist
    cos_l = (-dot(wi, ln)).abs()
    # the host's float32 area, as the reference uses it (not `_area`)
    pdf_sa = dist2 / torch.clamp(light.area * cos_l, min=1e-9)

    b_pdf = disney.bsdf_pdf(mat, eta_i, eta_o, n, wo, wi)
    f = disney.bsdf_eval(mat, albedo, eta_i, eta_o, n, wo, wi)
    weight = pdf_sa / torch.clamp(pdf_sa + b_pdf, min=1e-12)
    valid = (b_pdf > 0.0) & (cos_l > 1e-6) & active

    t_max = torch.where(valid, dist - 1e-3, 0.0)
    occluded, _ = _any_hit_sorted(cs, cfg, p, wi, cfg.shadow_t_min, t_max)
    contrib = light.emission * f * (weight * dot(wi, n).abs() / pdf_sa)
    zero = Vec3(*(torch.zeros_like(dist),) * 3)
    return state, where(valid & ~occluded, contrib, zero), valid


def quad_light_pdf(light: QuadLight, p: Vec3, d: Vec3, t_hit: Tensor) -> Tensor:
    """Solid-angle pdf of having NEE-sampled the point hit by (p, d, t)."""
    cos_l = dot(d, light.normal).abs()
    dist2 = t_hit * t_hit
    return dist2 / torch.clamp(light.area * cos_l, min=1e-9)


def _quad_emission_weight(light: QuadLight, path: dict, t_hit: Tensor, p_hit: Vec3) -> Tensor:
    """MIS weight of an emissive hit against the quad NEE: only hits on the
    quad compete with it (within the reference's slacks), and after a delta
    (SPECULAR) bounce `bsdf_pdf` is a discrete probability, so the weight
    is 1 there."""
    q_pdf = quad_light_pdf(light, path["o"], path["d"], t_hit)
    l1, l2, ln = light.v1, light.v2, light.normal
    rel = p_hit - light.corner
    s1 = dot(rel, l1) / torch.clamp(dot(l1, l1), min=1e-12)
    s2 = dot(rel, l2) / torch.clamp(dot(l2, l2), min=1e-12)
    on_quad = (
        (dot(rel, ln).abs() <= 1e-3 * torch.sqrt(light.area))
        & (s1 >= -1e-4) & (s1 <= 1.0 + 1e-4)
        & (s2 >= -1e-4) & (s2 <= 1.0 + 1e-4)
    )
    return torch.where(
        path["secondary"] & on_quad & ~path["prev_delta"],
        path["bsdf_pdf"] / torch.clamp(path["bsdf_pdf"] + q_pdf, min=1e-12),
        1.0,
    )


def _raygen(cfg: RenderConfig, cam: CameraParams, pixel_x: Tensor, pixel_y: Tensor,
            pix_index: Tensor, seed_ctr: Tensor):
    """Seed each lane's stream with tea(pixel, sample counter) and shoot its
    jittered camera ray; the low-discrepancy strategies replace the jitter
    after the stream has drawn it. Returns (state, o, d)."""
    dev = pixel_x.device
    state = RngState.seed(tea(pix_index, seed_ctr))
    if cfg.antialias:
        state, jx = randf(state)
        state, jy = randf(state)
        if cfg.sampling == "sobol":
            jx, jy = _sobol_pair(pix_index, seed_ctr, 0, _LD_SALT_AA)
        elif cfg.sampling != "random":
            a1, a2, scale = _ld_bases(cfg, pix_index, seed_ctr, _LD_SALT_AA)
            jx = a1 + jx * scale
            jy = a2 + jy * scale
    else:
        jx = torch.full(pixel_x.shape, 0.5, dtype=torch.float32, device=dev)
        jy = jx
    w = torch.tensor(float(cfg.width), dtype=torch.float32, device=dev)
    h = torch.tensor(float(cfg.height), dtype=torch.float32, device=dev)
    dx = 2.0 * (pixel_x.to(torch.float32) + jx) / w - 1.0
    dy = 2.0 * (pixel_y.to(torch.float32) + jy) / h - 1.0
    d = normalize(cam.u * dx + cam.v * dy + cam.w * 1.0)
    zf = torch.zeros(pixel_x.shape, dtype=torch.float32, device=dev)
    return state, Vec3(cam.eye.x + zf, cam.eye.y + zf, cam.eye.z + zf), d


def first_bounce_rays(cfg: RenderConfig, cam: CameraParams, pixel_x: Tensor, pixel_y: Tensor,
                      subframe: int = 0):
    """(o, d) of a launch's first sweep: the camera rays of sample 0, or of
    every sample when batch_spp expands the wavefront."""
    spp = cfg.samples_per_launch
    s = 0
    if cfg.batch_spp and spp > 1:
        s = torch.arange(spp, dtype=torch.int64, device=pixel_x.device).repeat_interleave(
            pixel_x.shape[0])
        pixel_x, pixel_y = pixel_x.repeat(spp), pixel_y.repeat(spp)
    pix_index = (pixel_y.to(torch.int64) * cfg.width + pixel_x.to(torch.int64)) & M32
    ctr = torch.full_like(pix_index, subframe * spp) + s
    _, o, d = _raygen(cfg, cam, pixel_x, pixel_y, pix_index, ctr & M32)
    return o, d


def trace_wavefront(
    cs: CompiledScene,
    probe: Probe,
    cfg: RenderConfig,
    cam: CameraParams,
    pixel_x: Tensor,
    pixel_y: Tensor,
    subframe: int,
    active_mask: Tensor | None = None,
    area_light=None,
    sample_lanes: Tensor | None = None,
    demand_pool=None,
) -> SampleOutput:
    """Render cfg.samples_per_launch paths for each pixel in the wavefront.

    pixel_x/pixel_y: (N,) int32 pixel coordinates on the render device.
    area_light (optional `QuadLight` on the render device) adds its NEE
    after the probe's, and MIS-weights emissive hits on it.
    active_mask (optional (N,) bool) culls lanes up front (the foveation
    annulus test): culled lanes trace nothing, add no rays to
    `rays_traced`, and output the backplate alone.

    sample_lanes (optional (N,) int64 holding uint32 values) is each lane's
    RNG sample counter, replacing `subframe * spp + sample`: each lane is
    ONE sample the caller expanded itself (the fused foveation launch), so
    there is no spp loop and no fold, outputs are per lane (composited at
    spp 1), and the caller folds lanes back to pixels."""
    _check_supported(cfg, area_light=area_light, demand_pool=demand_pool)
    dev = pixel_x.device
    n_pix = pixel_x.shape[0]
    spp = cfg.samples_per_launch
    fused_lanes = sample_lanes is not None
    batch = cfg.batch_spp and spp > 1 and not fused_lanes
    if batch:
        pixel_x = pixel_x.repeat(spp)
        pixel_y = pixel_y.repeat(spp)
        if active_mask is not None:
            active_mask = active_mask.repeat(spp)
        s_lanes = torch.arange(spp, dtype=torch.int64, device=dev).repeat_interleave(n_pix)
        loop_spp = 1
    else:
        s_lanes = None
        loop_spp = 1 if fused_lanes else spp

    n = pixel_x.shape[0]
    pix_index = (pixel_y.to(torch.int64) * cfg.width + pixel_x.to(torch.int64)) & M32
    zf = torch.zeros((n,), dtype=torch.float32, device=dev)
    zero = Vec3(zf, zf, zf)
    no = torch.zeros((n,), dtype=torch.bool, device=dev)
    sorting = cfg.sort_rays and cs.clusters is not None
    sobol = cfg.sampling == "sobol"
    ld = cfg.sampling != "random"
    ld_scale = 0.0  # jitter scale of the stratified / blue bases

    def ld_pair(depth: int, path: dict, state: RngState, keys: tuple[str, str], salt: int):
        """This bounce's low-discrepancy pair. The stream draws its pair
        first whatever the strategy, so every later draw stays aligned.
        sobol: a fresh pair at every depth; stratified / blue: the stratum
        base plus the stream's jitter at depth 0, the stream's pair deeper."""
        state, j1, j2 = randf2(state)
        if sobol:
            return state, _sobol_pair(path["ld_pix"], path["ld_ctr"], depth, salt)
        if depth == 0:
            return state, (path[keys[0]] + j1 * ld_scale, path[keys[1]] + j2 * ld_scale)
        return state, (j1, j2)

    def bounce_body(depth: int, path: dict, skip_nee: bool = False) -> dict:
        if sorting:
            key = _coherence_key(path["o"], path["d"], path["done"], cs.clusters.scene_aabb)
            path = _sort_path(path, key)
        active = ~path["done"]  # depth <= max_depth on every iteration here
        t_max = torch.where(active, cfg.t_max, 0.0)
        rec = closest_hit_cluster(cs.clusters, path["o"], path["d"], cfg.t_min, t_max)
        hit = rec.hit & active

        n_hit, mat, albedo = _hit_geometry(cs, rec, path["d"], cfg.use_shading_normals)
        p_hit = path["o"] + path["d"] * rec.t

        is_catcher = (mat.flags & MATERIAL_FLAG_SHADOW_CATCHER) != 0
        catcher_pass = hit & is_catcher & path["secondary"]
        shaded = hit & ~catcher_pass

        # first-bounce AOVs (deviceProgram.cu:424-427; miss zeroes them)
        if depth == 0:
            normal_aov = where(active, where(hit, n_hit, zero), path["normal"])
            albedo_aov = where(active, where(hit, albedo, zero), path["albedo"])
            depth_aov = torch.where(active, torch.where(hit, rec.t, 0.0), path["depth_aov"])
        else:
            normal_aov, albedo_aov, depth_aov = path["normal"], path["albedo"], path["depth_aov"]

        # ---- NEE ----
        eta_o = torch.where(path["eta"] == 1.0, mat.index_of_refraction(), 1.0)
        wo = -path["d"]
        plain = shaded & ~is_catcher
        catcher_primary = shaded & is_catcher
        ones = Vec3(*(torch.ones_like(zf),) * 3)
        if skip_nee:
            # peeled final bounce (nee_final_bounce=False): the reference
            # discards this sweep's NEE anyway, so neither sample nor trace
            state = path["state"]
            shadow_traced = no
            radiance = path["radiance"]
            alpha = where(plain, ones, path["alpha"])
        else:
            state, u12 = path["state"], None
            if ld:
                state, u12 = ld_pair(depth, path, state, ("ld_n1", "ld_n2"), _LD_SALT_NEE)
            state, lit, shadowed, shadow_traced = _nee(
                cs, probe, cfg, p_hit, n_hit, wo, mat, albedo,
                path["eta"], eta_o, shaded, state, u12=u12,
            )
            radiance = path["radiance"] + where(plain, path["throughput"] * lit, zero)
            alpha = where(plain, ones, path["alpha"])
            alpha = alpha + where(catcher_primary, path["throughput"] * shadowed, zero)

        # emission on primary hits (:558-560), or on every bounce; with an
        # area light, MIS-weighted against its NEE
        if cfg.emission_all_bounces and area_light is not None:
            w_emit = _quad_emission_weight(area_light, path, rec.t, p_hit)
            radiance = radiance + where(plain, path["throughput"] * mat.emission * w_emit, zero)
        elif cfg.emission_all_bounces:
            radiance = radiance + where(plain, path["throughput"] * mat.emission, zero)
        else:
            radiance = radiance + where(plain & ~path["secondary"], mat.emission, zero)

        # the parallelogram light's NEE, on the plain hits of non-emitters
        if area_light is not None and not skip_nee:
            dark = mat.emission.x + mat.emission.y + mat.emission.z == 0.0
            state, quad_contrib, _ = _quad_nee(
                cs, cfg, area_light, p_hit, n_hit, wo, mat, albedo, path["eta"], eta_o,
                plain & dark, state,
            )
            radiance = radiance + where(plain, path["throughput"] * quad_contrib, zero)

        rays = path["rays"] + active.sum() + shadow_traced.sum()
        if skip_nee:
            # the continuation state is never consumed again
            return dict(path, radiance=radiance, alpha=alpha, normal=normal_aov,
                        albedo=albedo_aov, depth_aov=depth_aov, state=state, rays=rays)

        # ---- BSDF continuation ----
        tb, bb = basis_from_vector(n_hit)
        u12 = None
        if ld:
            state, u12 = ld_pair(depth, path, state, ("ld_b1", "ld_b2"), _LD_SALT_BSDF)
        state, res = disney.bsdf_sample(mat, path["eta"], eta_o, tb, bb, n_hit, wo, state, u12=u12)
        f = disney.bsdf_eval(mat, albedo, path["eta"], eta_o, n_hit, wo, res.light)
        cos_term = dot(n_hit, res.light).abs()
        new_tp = path["throughput"] * f * (cos_term / torch.clamp(res.pdf, min=1e-12))
        transmit = dot(res.light, n_hit) <= 0.0
        new_eta = torch.where(transmit, eta_o, path["eta"])

        bsdf_dead = shaded & (res.pdf <= 0.0)
        cont = shaded & ~bsdf_dead

        rr_kill = no
        if cfg.russian_roulette:
            # the draw is unconditional so the stream stays lane-uniform
            state, u_rr = randf(state)
            p_surv = torch.clamp(luminance(new_tp), cfg.rr_min_prob, 1.0)
            do_rr = cont & (depth >= cfg.rr_start_depth)
            rr_kill = do_rr & (u_rr >= p_surv)
            boost = torch.where(do_rr & ~rr_kill, 1.0 / p_surv, 1.0)
            new_tp = new_tp * boost
            cont = cont & ~rr_kill

        # shadow-catcher passthrough: continue straight through (:503-508)
        return dict(
            path,
            o=where(catcher_pass, p_hit, where(cont, p_hit, path["o"])),
            d=where(cont, res.light, path["d"]),
            throughput=where(cont, new_tp, path["throughput"]),
            eta=torch.where(cont, new_eta, path["eta"]),
            radiance=radiance,
            alpha=alpha,
            normal=normal_aov,
            albedo=albedo_aov,
            depth_aov=depth_aov,
            done=path["done"] | (active & ~rec.hit) | bsdf_dead | rr_kill,
            secondary=path["secondary"] | cont,
            state=state,
            rays=rays,
            bsdf_pdf=torch.where(cont, res.pdf, path["bsdf_pdf"]),
            prev_delta=torch.where(cont, res.event == disney.SPECULAR, path["prev_delta"]),
        )

    acc = None
    rays_total = torch.zeros((), dtype=torch.int64, device=dev)
    backplate = zero
    for s in range(loop_spp):
        if fused_lanes:
            seed_ctr = sample_lanes & M32
        else:
            s_eff = s_lanes if s_lanes is not None else s
            seed_ctr = (torch.full_like(pix_index, subframe * spp) + s_eff) & M32
        state, o, d = _raygen(cfg, cam, pixel_x, pixel_y, pix_index, seed_ctr)
        # the strategies' per-lane leaves ride the path sorts: Sobol redraws
        # from (pixel, counter) at every bounce, the bases are drawn here
        if sobol:
            ld_leaves = dict(ld_pix=pix_index, ld_ctr=seed_ctr)
        elif ld:
            n1, n2, ld_scale = _ld_bases(cfg, pix_index, seed_ctr, _LD_SALT_NEE)
            b1, b2, _ = _ld_bases(cfg, pix_index, seed_ctr, _LD_SALT_BSDF)
            ld_leaves = dict(ld_n1=n1, ld_n2=n2, ld_b1=b1, ld_b2=b2)
        else:
            ld_leaves = {}
        backplate = probe_eval(probe, *dir_to_uv(d))

        path = dict(
            o=o, d=d, throughput=Vec3(zf + 1.0, zf + 1.0, zf + 1.0), eta=zf + 1.0,
            radiance=zero, alpha=zero, normal=zero, albedo=zero,
            done=no if active_mask is None else ~active_mask, secondary=no, state=state,
            rays=torch.zeros((), dtype=torch.int64, device=dev),
            depth_aov=zf, bsdf_pdf=zf + 1.0, prev_delta=no, **ld_leaves,
        )
        if sorting:
            # original lane, to restore caller order after the bounce sorts
            path["idx"] = torch.arange(n, dtype=torch.int64, device=dev)

        if cfg.nee_final_bounce:
            for depth in range(cfg.max_depth + 1):
                path = bounce_body(depth, path)
        else:
            for depth in range(cfg.max_depth):
                path = bounce_body(depth, path)
            path = bounce_body(cfg.max_depth, path, skip_nee=True)

        if sorting:
            outs = [*path["radiance"], *path["alpha"], *path["normal"], *path["albedo"],
                    path["depth_aov"]]
            r = permute_packed(outs, _stable_argsort(path["idx"]))
            path = dict(path, radiance=Vec3(*r[0:3]), alpha=Vec3(*r[3:6]),
                        normal=Vec3(*r[6:9]), albedo=Vec3(*r[9:12]), depth_aov=r[12])

        cur = (path["radiance"], path["alpha"], path["normal"], path["albedo"], path["depth_aov"])
        acc = cur if acc is None else tuple(a + c for a, c in zip(acc, cur))
        rays_total = rays_total + path["rays"]

    color, alpha, normal, albedo, depth = acc
    if batch:
        def fold(a: Tensor, mean: bool = False) -> Tensor:
            r = a.reshape(spp, n_pix)
            return r.mean(0) if mean else r.sum(0)

        color = Vec3(*(fold(c) for c in color))
        alpha = Vec3(*(fold(c) for c in alpha))
        normal = Vec3(*(fold(c) for c in normal))
        albedo = Vec3(*(fold(c) for c in albedo))
        depth = fold(depth)
        backplate = Vec3(*(fold(c, mean=True) for c in backplate))

    # fused-lane launches are per-lane single samples: no spp normalisation
    sppf = 1.0 if fused_lanes else float(spp)
    alpha = alpha / sppf
    normal = normal / sppf
    albedo = albedo / sppf
    depth = depth / sppf
    # composite over the backplate (deviceProgram.cu:454)
    color = backplate * sppf * (1.0 - alpha) + color
    return SampleOutput(
        color=color, alpha=alpha, normal=normal, albedo=albedo, depth=depth,
        rays_traced=rays_total,
        bfs_overflow=torch.zeros((), dtype=torch.float32, device=dev),
    )


def accumulate(prev: Vec3, new_color: Vec3, subframe: int, spp: int, clamp_val: float) -> Vec3:
    """Progressive accumulation (deviceProgram.cu:458-467):
    accum = lerp(prev, clamp(new/spp, 0, clamp), 1/(subframe+1))."""
    cur = new_color * (1.0 / spp)
    if subframe == 0:
        return cur
    cur_clamped = Vec3(*(torch.clamp(c, 0.0, clamp_val) for c in cur))
    a = float(np.float32(1.0) / (np.float32(subframe) + np.float32(1.0)))
    return prev + (cur_clamped - prev) * a

"""Whitted-style renderer: spheres + curves + triangles, recursive
reflect/refract, per-light shadow rays, GGX direct lighting (port of
optixpathtracer_tpu/engine/whitted.py).

Reference config: "cuda/whitted.cu: Whitted spheres — recursive reflect/refract
+ shadow rays" (BASELINE.json config 2). Shading matches the vendored
whitted.cu closest-hit (GGX metallic-roughness direct lighting over
params.lights with occlusion rays, :114-198); raygen/accumulation matches
__raygen__pinhole (:44-103, center-jittered progressive accumulation);
misses return params.miss_color (:106-109). Recursion is a ray tree that
doubles per level: every branch of a level (slot k -> reflection k,
refraction k + m) is one concatenated sweep, and each ray's pixel stays
j % n, so a level's radiance folds back with one reshape-sum.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..builder import CompiledScene
from ..core.math import Vec3, dot, faceforward, normalize, reflect, refract, where
from ..core.rng import M32, RngState, randf, tea
from ..lights.lights import LIGHT_AMBIENT, LIGHT_POINT, LightTable
from ..ops.curve_intersect import CurveScene, any_hit_curves, closest_hit_curves
from ..ops.dispatch import trace_closest, trace_occluded
from ..ops.spheres import SphereScene, closest_hit_spheres
from ..shade import pbr
from ..shade.disney import fresnel_dielectric
from .wavefront import CameraParams

Tensor = torch.Tensor

BIG_T = 1e30


@dataclasses.dataclass(frozen=True)
class WhittedConfig:
    width: int = 768
    height: int = 576
    max_depth: int = 3  # reflection/refraction recursion depth
    t_min: float = 1e-3
    shadow_t_min: float = 1e-3
    miss_color: tuple = (0.34, 0.55, 0.85)
    antialias: bool = True


class _Hit(NamedTuple):
    t: Tensor
    n: Vec3
    mat_id: Tensor  # row into the sphere material table (-1 = not a sphere hit)
    tri: Tensor  # triangle id (-1 = not a triangle hit)
    cmat: Tensor  # row into the curve material table (-1 = not a curve hit)
    hit: Tensor


def _full(like: Tensor, value, dtype=torch.float32) -> Tensor:
    return torch.full(like.shape, value, dtype=dtype, device=like.device)


def _closest(ss: SphereScene | None, cs: CompiledScene | None, o: Vec3, d: Vec3, t_min, t_max,
             curves: CurveScene | None = None) -> _Hit:
    """Combined closest hit over spheres, curves and the triangle scene, in
    that order, each taking over only where strictly nearer."""
    zero = o.x * 0.0
    best = _Hit(t=_full(o.x, BIG_T) + zero, n=Vec3(zero, zero, zero),
                mat_id=_full(o.x, -1, torch.int32), tri=_full(o.x, -1, torch.int32),
                cmat=_full(o.x, -1, torch.int32), hit=_full(o.x, False, torch.bool))
    if ss is not None:
        sh = closest_hit_spheres(ss, o, d, t_min, t_max)
        better = sh.t < best.t
        sid = torch.clamp(sh.sphere, min=0).to(torch.int64)
        best = _Hit(t=torch.where(better, sh.t, best.t),
                    n=where(better, Vec3(sh.nx, sh.ny, sh.nz), best.n),
                    mat_id=torch.where(better, ss.material_id[sid], best.mat_id),
                    tri=best.tri, cmat=best.cmat, hit=best.hit | (better & sh.hit))
    if curves is not None:
        ch = closest_hit_curves(curves, o, d, t_min, 1e16)
        better = ch.hit & (ch.t < best.t) & (ch.t < t_max)
        seg = torch.clamp(ch.seg, min=0).to(torch.int64)
        best = _Hit(t=torch.where(better, ch.t, best.t), n=where(better, ch.normal, best.n),
                    mat_id=torch.where(better, -1, best.mat_id), tri=best.tri,
                    cmat=torch.where(better, curves.material_id[seg], best.cmat),
                    hit=best.hit | better)
    if cs is not None:
        th = trace_closest(cs, o, d, t_min, t_max)
        tn = cs.scene.geometric_normal(torch.clamp(th.tri, min=0).to(torch.int64))
        tn = faceforward(tn, -d, tn)
        better = th.hit & (th.t < best.t)
        best = _Hit(t=torch.where(better, th.t, best.t), n=where(better, tn, best.n),
                    mat_id=torch.where(better, -1, best.mat_id),
                    tri=torch.where(better, th.tri, best.tri),
                    cmat=torch.where(better, -1, best.cmat), hit=best.hit | better)
    return best


def _occluded(ss, cs, o: Vec3, d: Vec3, t_min, t_max, curves: CurveScene | None = None) -> Tensor:
    occ = torch.zeros(o.x.shape, dtype=torch.bool, device=o.x.device)
    if ss is not None:
        occ = occ | closest_hit_spheres(ss, o, d, t_min, t_max).hit
    if cs is not None:
        occ = occ | trace_occluded(cs, o, d, t_min, t_max)
    if curves is not None:
        occ = occ | any_hit_curves(curves, o, d, t_min, t_max)
    return occ


def light_kinds(lights: LightTable) -> tuple[int, ...]:
    """Host-side light-kind tuple (the lighting loop's structure)."""
    return tuple(int(k) for k in lights.kind.tolist())


def _shade_direct(ss, cs, lights: LightTable, kinds, cfg: WhittedConfig, p: Vec3, nrm: Vec3,
                  v: Vec3, base_color: Vec3, metallic, roughness, hit, curves=None) -> Vec3:
    """Direct lighting loop over the light table (whitted.cu:158-195)."""
    zero = p.x * 0.0
    out = Vec3(zero, zero, zero)
    zeros = Vec3(torch.zeros_like(zero), torch.zeros_like(zero), torch.zeros_like(zero))
    for li, kind in enumerate(kinds):
        lcol = Vec3(lights.color.x[li] * lights.intensity[li],
                    lights.color.y[li] * lights.intensity[li],
                    lights.color.z[li] * lights.intensity[li])
        if kind == LIGHT_AMBIENT:
            out = out + where(hit, lcol * base_color, zeros)
        elif kind == LIGHT_POINT:
            to_l = Vec3(lights.position.x[li] - p.x, lights.position.y[li] - p.y,
                        lights.position.z[li] - p.z)
            dist = torch.sqrt(torch.clamp(dot(to_l, to_l), min=1e-20))
            l = to_l / dist
            t_max = torch.where(hit, dist - 1e-3, 0.0)
            occ = _occluded(ss, cs, p, l, cfg.shadow_t_min, t_max, curves)
            contrib = pbr.direct_light(base_color, metallic, roughness, nrm, v, l, lcol, ~occ & hit)
            # inverse-square falloff (Light.h point lights carry intensity)
            out = out + contrib * (1.0 / torch.clamp(dist * dist, min=1e-6))
    return out


def render_whitted(ss: SphereScene | None, cs: CompiledScene | None, lights: LightTable,
                   cfg: WhittedConfig, cam: CameraParams, pixel_x: Tensor, pixel_y: Tensor,
                   subframe: int, kinds: tuple[int, ...] | None = None,
                   curves: CurveScene | None = None) -> Vec3:
    """One whitted sample per pixel; returns linear radiance (N,). Level k
    of the ray tree traces 2^k x N rays in one sweep; the pixel of ray j is
    j % N."""
    if kinds is None:
        kinds = light_kinds(lights)
    n = pixel_x.shape[0]
    dev = pixel_x.device
    w = torch.tensor(float(cfg.width), dtype=torch.float32, device=dev)
    h = torch.tensor(float(cfg.height), dtype=torch.float32, device=dev)
    pix = (pixel_y.to(torch.int64) * cfg.width + pixel_x.to(torch.int64)) & M32
    state = RngState.seed(tea(pix, torch.full_like(pix, int(subframe) & M32)))

    if cfg.antialias:
        state, jx = randf(state)
        state, jy = randf(state)
        if int(subframe) == 0:  # the first subframe uses pixel centers (whitted.cu:60-62)
            jx = torch.full_like(jx, 0.5)
            jy = jx
    else:
        jx = jy = torch.full((n,), 0.5, dtype=torch.float32, device=dev)

    dx = 2.0 * (pixel_x.to(torch.float32) + jx) / w - 1.0
    dy = 2.0 * (pixel_y.to(torch.float32) + jy) / h - 1.0
    zf = dx * 0.0
    d = normalize(cam.u * dx + cam.v * dy + cam.w * 1.0)
    o = Vec3(cam.eye.x + zf, cam.eye.y + zf, cam.eye.z + zf)

    def cat3(a: Vec3, b: Vec3) -> Vec3:
        return Vec3(*(torch.cat([p, q]) for p, q in zip(a, b)))

    def fold(v: Vec3) -> Vec3:  # (k*n,) per ray -> (n,) per pixel
        return Vec3(*(c.reshape(-1, n).sum(0) for c in v))

    one_n = torch.ones_like(zf)
    tp = Vec3(one_n, one_n, one_n)
    eta = torch.ones_like(zf)
    live = zf < 1.0
    radiance = Vec3(zf, zf, zf)

    for level in range(cfg.max_depth + 1):
        zm = o.x * 0.0
        zeros_m = Vec3(zm, zm, zm)
        miss = Vec3(*(torch.full_like(zm, c) for c in cfg.miss_color))
        t_max = torch.where(live, BIG_T, 0.0)
        hitrec = _closest(ss, cs, o, d, cfg.t_min, t_max, curves)
        hit = hitrec.hit & live
        # miss -> constant radiance (whitted.cu __miss__constant_radiance)
        radiance = radiance + fold(where(live & ~hitrec.hit, tp * miss, zeros_m))

        # material fetch
        if ss is not None:
            mats = ss.materials.take(torch.clamp(hitrec.mat_id, min=0).to(torch.int64))
            base = mats.color
            metallic = mats.metallic
            rough = mats.roughness
            transmission = mats.transmission
            ior = mats.index_of_refraction()
        else:
            base = Vec3(*(torch.full_like(zm, 0.7),) * 3)
            metallic = t_max * 0.0
            rough = t_max * 0.0 + 0.5
            transmission = t_max * 0.0
            ior = t_max * 0.0 + 1.5
        if cs is not None:
            tri = torch.clamp(hitrec.tri, min=0).to(torch.int64)
            tri_mat = cs.scene.materials.take(cs.scene.material_id[tri].to(torch.int64))
            is_tri = hitrec.mat_id < 0
            base = where(is_tri, tri_mat.color, base)
            metallic = torch.where(is_tri, tri_mat.metallic, metallic)
            rough = torch.where(is_tri, tri_mat.roughness, rough)
            transmission = torch.where(is_tri, tri_mat.transmission, transmission)
            ior = torch.where(is_tri, tri_mat.index_of_refraction(), ior)
        if curves is not None:
            cv_mat = curves.materials.take(torch.clamp(hitrec.cmat, min=0).to(torch.int64))
            is_cv = hitrec.cmat >= 0
            base = where(is_cv, cv_mat.color, base)
            metallic = torch.where(is_cv, cv_mat.metallic, metallic)
            rough = torch.where(is_cv, cv_mat.roughness, rough)
            transmission = torch.where(is_cv, cv_mat.transmission, transmission)
            ior = torch.where(is_cv, cv_mat.index_of_refraction(), ior)

        p = o + d * hitrec.t
        nrm = faceforward(hitrec.n, -d, hitrec.n)
        v = -d

        # transmissive surfaces carry (almost) no diffuse term
        direct = _shade_direct(ss, cs, lights, kinds, cfg, p, nrm, v, base * (1.0 - transmission),
                               metallic, rough, hit, curves)
        radiance = radiance + fold(where(hit, tp * direct, zeros_m))

        if level == cfg.max_depth:
            break

        # Fresnel split (entering vs exiting by the unflipped normal)
        entering = dot(hitrec.n, v) > 0.0
        eta_o = torch.where(entering, ior, 1.0)
        fr = fresnel_dielectric(dot(nrm, v).abs(), eta, eta_o)

        # reflection branch: mirror weight = fresnel * (metallic or glass)
        refl_w = torch.where(transmission > 0.0, fr, metallic)
        r_dir = normalize(reflect(d, nrm))
        one = Vec3(*(torch.ones_like(zm),) * 3)
        refl_tint = one + (base - one) * metallic  # metals tint mirrors

        # refraction branch
        t_dir, ok = refract(v, nrm, eta / eta_o)
        refr_w = torch.where(ok, (1.0 - fr) * transmission, 0.0)

        o = cat3(p, p)
        d = cat3(r_dir, normalize(t_dir))
        tp = cat3(tp * refl_tint * refl_w, tp * refr_w)
        eta = torch.cat([eta, eta_o])
        live = torch.cat([hit & (refl_w > 1e-3), hit & (refr_w > 1e-3)])

    return radiance

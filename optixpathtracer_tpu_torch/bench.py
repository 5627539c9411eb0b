"""Benchmark: incoherent-ray throughput of the Disney wavefront path tracer
(port of the repository's bench.py; it imports only this package).

    python -m optixpathtracer_tpu_torch.bench [--small] [--cpu]
        [--scene city|loft|hostile|big] [--no-fullres] [--no-big] [--no-4k]
    python -m optixpathtracer_tpu_torch bench [--small] [--cpu]

Prints JSON lines on stdout, the headline first: {"metric", "value",
"unit", "vs_baseline"}, Mrays/s of `disney_pt` (depth 4, the bench's
flags) on the 150k-triangle city at 1200x800 x 2 spp, counting every traced
ray as the wavefront counts it on the device. vs_baseline is against a
100 Mrays/s target. On the city at full size (no --small, not --cpu) the
tracks follow, in bench.py's order: time to sqrt-space RMSE <= 0.03 at
600x400 and 1200x800 (`quality_track`, against scenes/ref_city_*.npz), the
demand-textured loft (`demand_textures_line`), one line per other preset
(`per_config_lines`), the 1.35M-triangle scaling line (`big_scene_line`,
unless --no-big), the interactive foveated loop (`interactive_line`)
and the sv4 4K quality row (`fovea4k_track`, unless --no-4k). The `metric`
strings are bench.py's letter for letter: they name the rows (so under
--small the headline still says 1200x800; the detail records the size
that ran). One detail line goes to stderr.

It runs on the card (cuda:0) unless --cpu is given; without --cpu and
without a CUDA device it raises. Where bench.py describes a TPU, the port
does the card's own thing:
- `measure_utilization` states its fractions against the card's FP32 peak
  (SMs x 128 lanes x the SM clock's maximum, 45 FP32 operations per
  ray-triangle pair, `traverse_cluster.MT_OPS`) under `fp32_ops_est`,
  `fp32_peak_frac` and `exec_fp32_peak_frac`; `collective_model` is the
  H100's NVLink data-sheet rate, a model and not a measurement.
- `member_evals_per_block` counts the flat cull's scheduled members, as in
  bench.py; the sweeps take the walk `hier=None` routes to (`walk`: the
  city's 74 entries take the node walk), and `exec_*` count that walk's
  executed pairs (`closest_hit_cluster_exec_stats`).
- Every timed region ends in `torch.cuda.synchronize()`. The warm-up (CUDA
  context, the kernels' nvcc build at first use: `nvcc_s`, the host
  builders) runs outside `bvh_build_s` and `first_frame_incl_compile_s`.
- With more than one card the headline renders strips over
  `parallel/tiles.DistributedRenderer`, one NCCL rank a card.
- `main` returns 1 when a row errored or failed its gate (the headline's
  exactness gate, the big scene's oracle gate, a demand frame shading a
  page not resident, a preset frame not finite or constant) and prints
  which; bench.py prints such rows and exits 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from . import scenes
from .builder import compile_scene
from .core.math import Vec3
from .engine.renderer import Renderer
from .engine.wavefront import RenderConfig, _coherence_key
from .lights.probe import build_probe
from .ops import traverse_cluster as tc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ("city", "loft", "hostile", "big")
BUILD = dict(leaf_size=8, wide_width=8, build_wide_bvh=False, cluster_size=256)
UTIL_RAYS = 131072  # each of measure_utilization's two ray sets
SM_FP32_LANES = 128  # FP32 lanes of one Hopper SM, one un-fused op each per clock
NVLINK_BYTES_PER_S = 450e9  # H100 SXM NVLink 4: 900 GB/s both ways per card (data sheet)
TARGET_MRAYS = 100.0  # the headline's vs_baseline target
QUALITY_TARGET = 0.03  # sqrt-space RMSE of the quality rows


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def v3(a: np.ndarray, device) -> Vec3:
    """(n, 3) numpy -> Vec3 of contiguous f32 tensors on device."""
    return Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, i], np.float32), device=device)
                  for i in range(3)))


def fp32_ops_per_s() -> float:
    """The card's FP32 instruction rate without FMA (the kernels are built with
    --fmad=false, so every mul and add is one instruction): SMs x 128 lanes
    x the SM clock's maximum as nvidia-smi prints it."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * SM_FP32_LANES * mhz * 1e6


def nvidia_smi() -> str | None:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def walk_of(cl) -> str:
    """The walk `hier=None` takes on a cluster set: "node" or "flat"."""
    return "node" if cl.num_entries >= tc.HIER_MIN_ENTRIES else "flat"


# --------------------------------------------------------------------------
# The exactness gate (bench.py:1302-1340)
# --------------------------------------------------------------------------

def mixed_rays(cs, hs, cam, n, seed, device):
    """bench.py's gate rays: half camera rays, half scene-interior rays."""
    rng = np.random.default_rng(seed)
    half = n // 2
    uu, vv, ww = cam.uvw_frame()
    sx = rng.uniform(-1, 1, (half, 1))
    sy = rng.uniform(-1, 1, (half, 1))
    dcam = sx * uu[None] + sy * vv[None] + ww[None]
    ocam = np.broadcast_to(np.asarray(cam.eye, np.float32), (half, 3))
    all_v = np.concatenate([m.vertices for m in hs.meshes])
    lo, hi = all_v.min(0), all_v.max(0)
    c, half_ext = (lo + hi) / 2, (hi - lo) / 2
    obnc = c + rng.uniform(-0.85, 0.85, (half, 3)) * half_ext
    dbnc = rng.normal(0, 1, (half, 3))
    og = np.concatenate([ocam, obnc]).astype(np.float32)
    dg = np.concatenate([dcam, dbnc]).astype(np.float32)
    dg /= np.linalg.norm(dg, axis=1, keepdims=True)
    return v3(og, device), v3(dg, device)


def exactness_gate(cs, hs, cam, device, n=8192) -> dict:
    """bench.py:1302-1340: the winning triangle of n mixed rays (seed 42)
    through the scene's own walk (hier=None) and through the other walk,
    against `reference_closest`. `mismatch` is the headline's gate
    (bench.py's `gate_mismatch_rays`); `flat_vs_hier_mismatch` counts the
    rays the two walks resolve apart."""
    cl = cs.clusters
    og, dg = mixed_rays(cs, hs, cam, n, 42, device)
    fast = tc.closest_hit_cluster(cl, og, dg, 1e-3, 1e16)
    other = tc.closest_hit_cluster(cl, og, dg, 1e-3, 1e16, hier=walk_of(cl) == "flat")
    exact = tc.reference_closest(cl, og, dg, 1e-3, 1e16)
    return dict(rays=n, walk=walk_of(cl), entries=cl.num_entries,
                mismatch=int((fast.tri != exact.tri).sum()),
                flat_vs_hier_mismatch=int((fast.tri != other.tri).sum()),
                hits=int((exact.tri >= 0).sum()))


# --------------------------------------------------------------------------
# Sweep utilisation (bench.py:226-391)
# --------------------------------------------------------------------------

def _tile_camera_rays(cam, n):
    """n camera rays in the renderer's 16x8 tile order over a 512x256 grid:
    (origins, directions), (n, 3) f32 each."""
    uu, vv, ww = cam.uvw_frame()
    w_t, h_t = 512, 256
    xs, ys = np.meshgrid(np.arange(w_t), np.arange(h_t))
    order = np.lexsort([
        xs.ravel() % 16 + 16 * (ys.ravel() % 8),
        xs.ravel() // 16 + (ys.ravel() // 8) * (w_t // 16),
    ])
    px = (xs.ravel()[order] + 0.5) / w_t * 2 - 1
    py = (ys.ravel()[order] + 0.5) / h_t * 2 - 1
    dcam = px[:n, None] * uu[None] + py[:n, None] * vv[None] + ww[None]
    dcam = (dcam / np.linalg.norm(dcam, axis=1, keepdims=True)).astype(np.float32)
    ocam = np.broadcast_to(np.asarray(cam.eye, np.float32), dcam.shape).copy()
    return ocam, dcam


def _coherence_sorted(aabb, ob, db):
    """ob, db reordered by the wavefront's coherence key (stable sort)."""
    dev = aabb.device
    key = _coherence_key(v3(ob, dev), v3(db, dev),
                         torch.zeros((ob.shape[0],), dtype=torch.bool, device=dev), aabb)
    sorder = np.argsort(key.cpu().numpy(), kind="stable")
    return ob[sorder], db[sorder]


def utilization_rays(cl, cam, n=UTIL_RAYS):
    """measure_utilization's two ray sets, numpy (n, 3) f32: camera rays in
    tile order (ocam, dcam), and bounce-like interior rays sorted by the
    wavefront's coherence key (ob, db)."""
    rng = np.random.default_rng(7)
    ocam, dcam = _tile_camera_rays(cam, n)
    ob = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    ob[:, 1] = rng.uniform(0.2, 8, n).astype(np.float32)
    db = rng.normal(0, 1, (n, 3)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    ob, db = _coherence_sorted(cl.scene_aabb, ob, db)
    return ocam, dcam, ob, db


def member_evals_per_block(bits_lo: np.ndarray, bits_hi: np.ndarray) -> float:
    """Mean over ray blocks of the members the flat cull schedules: per
    (block, entry), the members any of its 8 sub-blocks runs."""
    lo, hi = bits_lo, bits_hi
    u = (lo | (lo >> 8) | (lo >> 16) | (lo >> 24) | hi | (hi >> 8) | (hi >> 16) | (hi >> 24)) & 0xFF
    evals = sum(((u >> k) & 1).astype(np.int64).sum(axis=1) for k in range(8))
    return float(evals.mean())


def measure_utilization(cs, cam):
    """Cull selectivity and sweep throughput for the two ray regimes that
    bound the frame (camera tiles, engine-sorted bounce rays), with the
    pair-evaluation rates against the card's FP32 peak.

    `fp32_peak_frac`: the scheduled pair evaluations (the flat cull's
    member bits) x MT_OPS over wall time x peak; `exec_fp32_peak_frac` the
    same for the executed pairs of the walk taken (`walk`), counted by the
    kernels' visit counters. `scale8` measures the bounce sweep at 131k rays
    (one card's share of an 8-card strip split) and at 1M, and models the
    frame's all-gather over NVLink."""
    cl = cs.clusters
    c_size = cl.cluster_size
    dev = cl.rows.device
    peak = fp32_ops_per_s()
    n = UTIL_RAYS
    walk = walk_of(cl)
    ocam, dcam, ob, db = utilization_rays(cl, cam)

    def sweep_s(ov, dv):
        """Seconds of one closest-hit sweep, after a warm-up sweep."""
        float(tc.closest_hit_cluster(cl, ov, dv, 1e-3, 1e16).t.sum())
        _sync(dev)
        t0 = time.perf_counter()
        float(tc.closest_hit_cluster(cl, ov, dv, 1e-3, 1e16).t.sum())
        _sync(dev)
        return time.perf_counter() - t0

    out = {}
    for name, o, d in (("camera", ocam, dcam), ("bounce_sorted", ob, db)):
        ov, dv = v3(o, dev), v3(d, dev)
        cull = tc.block_cull(cl, ov, dv, 1e-3, 1e16)
        evals_per_block = member_evals_per_block(cull.bits_lo.cpu().numpy(), cull.bits_hi.cpu().numpy())
        del cull
        dt = sweep_s(ov, dv)
        _, exec_pairs = tc.closest_hit_cluster_exec_stats(cl, ov, dv, 1e-3, 1e16)
        pair_evals = evals_per_block * (n / 128) * 128 * c_size
        ops = pair_evals * tc.MT_OPS
        out[name] = {
            "walk": walk,
            "member_evals_per_block": evals_per_block,
            "sweep_s": dt,
            "mrays_per_s_sweep": n / dt / 1e6,
            "pair_evals": int(pair_evals),
            "pair_evals_per_s": pair_evals / dt / 1e9,  # G/s
            "fp32_ops_est": int(ops),
            "fp32_peak_frac": ops / dt / peak,
            "exec_member_evals_per_block": exec_pairs / c_size / 128 / (n / 128),
            "exec_pair_evals": exec_pairs,
            "exec_fp32_peak_frac": exec_pairs * tc.MT_OPS / dt / peak,
        }

    # one card's share of an 8-card strip split hands each card ~1/8 of a
    # sweep's lanes: the bounce sweep's rate at 131k rays against its rate
    # at the full 1M bounds the split's per-card efficiency. The frame's
    # all-gather is modelled from NVLink's data-sheet rate, not measured.
    ob8, db8 = v3(np.tile(ob, (8, 1)), dev), v3(np.tile(db, (8, 1)), dev)
    dt_big = sweep_s(ob8, db8)
    del ob8, db8
    rate_small = out["bounce_sorted"]["mrays_per_s_sweep"]
    rate_big = 8 * n / dt_big / 1e6
    fb_bytes_1200x800 = 1200 * 800 * 3 * 4
    fov4k_lane_bytes = 22e6  # the 4K foveated lane colours a frame gathers
    out["scale8"] = {
        "bounce_sweep_mrays_shard_131k": rate_small,
        "bounce_sweep_mrays_full_1m": rate_big,
        "per_chip_efficiency": min(1.0, rate_small / rate_big),
        "collective_ms_per_frame_1200x800": fb_bytes_1200x800 / NVLINK_BYTES_PER_S * 1e3,
        "collective_ms_per_frame_fov4k": fov4k_lane_bytes / NVLINK_BYTES_PER_S * 1e3,
        "collective_model": "all-gather bytes / 450 GB/s (H100 SXM NVLink 4, one direction of "
                            "its data-sheet 900 GB/s; a model, not a measurement)",
    }
    out["fp32_ops_per_s"] = peak
    return out


# --------------------------------------------------------------------------
# The triangle-count scaling line (bench.py:394-505)
# --------------------------------------------------------------------------

BIG_METRIC = ("Mrays/s sorted-bounce sweep, 1.35M-tri scene "
              "(scaling axis; exact, dense-oracle-gated)")


def big_scene_line(city_bounce_mrays, device, gate_n=1024):
    """The 1.35M-triangle big scene (the city, a finely tessellated terrain
    apron, two suburb rings): winning triangles against the dense oracle on
    a mixed camera + sorted-bounce subset, then the camera and sorted-bounce
    closest sweeps at 131k rays through the walk `hier=None` takes.
    vs_baseline = bounce rate / (0.5 x the city's bounce rate)."""
    hs = scenes.build_big_scene()
    t0 = time.perf_counter()
    cs = compile_scene(hs, device, **BUILD)
    _sync(device)
    build_s = time.perf_counter() - t0
    cl = cs.clusters
    cam_b = scenes.city_camera(1200, 800)  # bench.py's aspect ratio 1.5

    n = UTIL_RAYS
    rng = np.random.default_rng(7)
    ocam, dcam = _tile_camera_rays(cam_b, n)
    bb = cl.scene_aabb.cpu().numpy()
    lo, hi = bb[0:3], bb[3:6]
    ob = (lo + rng.uniform(0.05, 0.95, (n, 3)) * (hi - lo)).astype(np.float32)
    db = rng.normal(0, 1, (n, 3)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    ob, db = _coherence_sorted(cl.scene_aabb, ob, db)

    og = v3(np.concatenate([ocam[:gate_n // 2], ob[:gate_n // 2]]), device)
    dg = v3(np.concatenate([dcam[:gate_n // 2], db[:gate_n // 2]]), device)
    ref_tri = tc.reference_closest(cl, og, dg, 1e-3, 1e16).tri
    got_tri = tc.closest_hit_cluster(cl, og, dg, 1e-3, 1e16).tri
    mism = int((ref_tri != got_tri).sum())

    rates = {}
    for name, o, d in (("camera", ocam, dcam), ("bounce_sorted", ob, db)):
        ov, dv = v3(o, device), v3(d, device)
        tc.closest_hit_cluster(cl, ov, dv, 1e-3, 1e16)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(2):
            tc.closest_hit_cluster(cl, ov, dv, 1e-3, 1e16)
        _sync(device)
        rates[name] = n * 2 / (time.perf_counter() - t0) / 1e6
    bar = 0.5 * city_bounce_mrays
    gated_out = mism > 0
    return {
        "metric": BIG_METRIC,
        "value": 0.0 if gated_out else round(rates["bounce_sorted"], 3),
        "unit": "Mrays/s",
        "vs_baseline": 0.0 if gated_out else round(
            rates["bounce_sorted"] / bar, 3) if bar > 0 else 0.0,
        "detail": {
            "triangles": cs.num_triangles,
            "entries": cl.num_entries,
            "walk": walk_of(cl),
            "bvh_build_s": build_s,
            "camera_sweep_mrays": rates["camera"],
            "bounce_sweep_mrays": rates["bounce_sorted"],
            "gate_mismatch_rays": mism,
            "gate_rays": gate_n,
            "city_bounce_mrays": city_bounce_mrays,
            "bar_is_half_city_rate": bar,
        },
    }


# --------------------------------------------------------------------------
# Time to quality (bench.py:508-913)
# --------------------------------------------------------------------------

def sqrt_img(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(a, min=0.0))


def sqrt_rmse(a: torch.Tensor, ref_sqrt: torch.Tensor) -> float:
    """sqrt-space RMSE of an image against a reference already in sqrt
    space, on the device; one scalar to the host (the sync)."""
    return float(torch.sqrt(torch.mean((sqrt_img(a) - ref_sqrt) ** 2)))


def _accum(v: Vec3) -> torch.Tensor:
    return torch.stack(list(v), -1)


def _error_row(metric, msg, unit="s"):
    print(f"BENCH ERROR: {msg}", file=sys.stderr, flush=True)
    return {"metric": metric, "value": 0.0, "unit": unit, "vs_baseline": 0.0, "error": msg}


QUALITY_METRIC = "time-to-RMSE track"


def quality_track(cs, probe, on_cpu, max_launches=128, ref_path=None):
    """Seconds of render time to sqrt-space RMSE <= 0.03 against a committed
    converged reference (scenes/ref_city_600x400.npz, or ref_path), with
    each row's spp and the reference's:

      uniform   progressive PT, random sampling, raw accumulation;
      pipeline  Sobol sampling + variance-guided adaptive refinement +
                AOV-guided A-Trous denoise (its cost counted);
      foveated  progressive 3-zone foveation under a static central gaze,
                RMSE over the fovea disc.

    Every RMSE is computed on the device, one scalar to the host per
    checkpoint (the sync that ends each timed step). A missing reference
    gives an error row. Returns a list of JSON records."""
    from .engine.adaptive import AdaptiveRenderer
    from .engine.foveated import FoveatedRenderer, FoveationConfig

    if ref_path is None:
        ref_path = os.path.join(REPO, "scenes", "ref_city_600x400.npz")
    if not os.path.exists(ref_path):
        return [_error_row(QUALITY_METRIC, f"missing committed reference artifact "
                           f"{ref_path} (regenerate with tools/make_reference.py)")]
    dev = cs.device
    ref_d = np.load(ref_path)
    w, h = int(ref_d["width"]), int(ref_d["height"])
    ref_spp = int(ref_d["spp"])
    ref_below_floor = ref_spp < 2048  # below it the reference's own noise counts
    if ref_below_floor:
        print(f"BENCH WARNING: {ref_path} has ref_spp={ref_spp} < 2048 — quality rows are "
              "marked ref_below_floor", file=sys.stderr, flush=True)
    # (H*W, 3) canonical, bottom row first
    ref_sqrt = sqrt_img(torch.as_tensor(ref_d["image"].astype(np.float32), device=dev))

    cam = scenes.city_camera(w, h)
    cfgq = RenderConfig(
        width=w, height=h, samples_per_launch=2, max_depth=4,
        traversal="lockstep" if on_cpu else "cluster", dispatch_tiles=1,
        sort_rays=not on_cpu, nee_final_bounce=False, batch_spp=True,
    )
    records = []

    def row(label, run):
        """run() yields (seconds so far, rmse, spp) checkpoints."""
        secs = spp = None
        rmse = float("inf")
        for t, v, s in run:
            rmse = v
            if v <= QUALITY_TARGET:
                secs, spp = t, s
                break
        rec = {
            "metric": f"seconds to RMSE<=0.03 @{w}x{h} ({label})",
            "value": round(secs, 2) if secs is not None else 0.0,
            "unit": "s",
            "reached": secs is not None,
            "final_rmse": round(rmse, 5),
            "spp": spp,
            "ref_spp": ref_spp,
            "seconds": secs,
        }
        if ref_below_floor:
            rec["ref_below_floor"] = True
        records.append(rec)
        return rec

    # ---- row 1: uniform random PT ------------------------------------------
    r = Renderer(cs, probe, cfgq, cam)
    ref_tile = ref_sqrt[torch.as_tensor(r._perm, device=dev)]

    def run_uniform():
        r.render(download=False)  # warm-up
        sqrt_rmse(_accum(r.accum), ref_tile)
        r.resize(w, h)  # a fresh accumulation
        t = 0.0
        for i in range(max_launches):
            t0 = time.perf_counter()
            r.render(download=False)
            v = sqrt_rmse(_accum(r.accum), ref_tile)
            _sync(dev)
            t += time.perf_counter() - t0
            yield t, v, (i + 1) * cfgq.samples_per_launch

    u_rec = row("uniform PT, random sampling", run_uniform())
    del r, ref_tile

    # ---- row 2: Sobol + adaptive + denoise -----------------------------------
    acfg = dataclasses.replace(cfgq, sampling="sobol")
    ref_img = ref_sqrt.reshape(h, w, 3).flip(0)  # top row first, as `denoised_tensor`

    def make_adaptive():
        return AdaptiveRenderer(cs, probe, acfg, cam, warmup_spp=2, refine_spp=4,
                                refine_fraction=0.25)

    def run_pipeline():
        # warm both launch shapes (the warm-up round and a refine round) on a
        # throw-away renderer, then time a fresh one
        warm = make_adaptive()
        for _ in range(2):
            warm.render()
            sqrt_rmse(warm.denoised_tensor(), ref_img)
        del warm
        ar = make_adaptive()
        t = 0.0
        for _ in range(48):
            t0 = time.perf_counter()
            ar.render()
            v = sqrt_rmse(ar.denoised_tensor(), ref_img)  # the bench's denoise: variance-scaled, demodulated
            _sync(dev)
            t += time.perf_counter() - t0
            yield t, v, round(float(ar.count.sum()) / (w * h), 2)

    p_rec = row("sobol+adaptive+denoise", run_pipeline())

    # ---- row 3: progressive foveation, fovea-disc RMSE -----------------------
    fcfg = FoveationConfig(inner_radius=80, outer_radius=200, progressive=True)
    gx, gy = w // 2, h // 2  # the frame's centre: the y flip does not move it
    ii = torch.arange(w * h, device=dev)
    fmask = ((ii % w - gx) ** 2 + (ii // w - gy) ** 2) <= 80 ** 2
    ref_disc = ref_sqrt[fmask]

    def make_fov():
        fr = FoveatedRenderer(cs, probe, dataclasses.replace(acfg, samples_per_launch=1), cam, fcfg)
        fr.set_gaze(gx, gy)
        return fr

    def run_fovea():
        make_fov().render()  # warm-up, then a fresh progressive accumulation
        fr = make_fov()
        t = 0.0
        for i in range(40):
            t0 = time.perf_counter()
            fr.render()
            v = sqrt_rmse(_accum(fr.accum)[fmask], ref_disc)
            _sync(dev)
            t += time.perf_counter() - t0
            yield t, v, (i + 1) * fcfg.fovea_spp

    row("progressive foveation, fovea disc", run_fovea())

    if u_rec["reached"] and p_rec["reached"] and p_rec["value"] > 0:
        speed = u_rec["value"] / p_rec["value"]
        records.append({
            "metric": "equal-quality speedup: sobol+adaptive+denoise "
                      f"vs uniform PT (RMSE<=0.03 @{w}x{h})",
            "value": round(speed, 2),
            "unit": "x",
            "vs_baseline": round(speed / 3.0, 3),  # target: >= 3x
        })
    return records


FOVEA4K_METRIC = "seconds to fovea-disc RMSE<=0.03 @3840x2160"


def fovea4k_track(cs, probe, max_frames=16):
    """The published sv4 configuration as a quality row: 3840x2160, 3-zone
    foveation with radii 157/515 and zone spp 1/2/8, progressive under a
    static gaze, Sobol sampling + Russian roulette + an A-Trous denoise of
    the 384x384 fovea crop with first-hit guides (checked raw and denoised,
    its cost counted). Seconds to fovea-disc sqrt-RMSE <= 0.03 against
    scenes/ref_city_4k_fovea.npz, plus the whole frame's RMSE at quarter
    resolution against scenes/ref_city_4k_q.npz."""
    from .engine.foveated import FoveatedRenderer, FoveationConfig
    from .engine.wavefront import _hit_geometry
    from .ops.denoise import atrous_denoise

    fov_ref = os.path.join(REPO, "scenes", "ref_city_4k_fovea.npz")
    q_ref = os.path.join(REPO, "scenes", "ref_city_4k_q.npz")
    missing = [p for p in (fov_ref, q_ref) if not os.path.exists(p)]
    if missing:
        return [_error_row(FOVEA4K_METRIC, f"missing committed 4K reference artifact(s) "
                           f"{missing} (regenerate with tools/make_reference_4k.py)")]
    dev = cs.device
    fd = np.load(fov_ref)
    qd = np.load(q_ref)
    w, h = int(fd["width"]), int(fd["height"])
    cx, cy = (int(v) for v in fd["gaze"])  # buffer coordinates, bottom row first
    idx = torch.as_tensor(fd["idx"].astype(np.int64), device=dev)
    ref_disc = sqrt_img(torch.as_tensor(fd["image"].astype(np.float32), device=dev))
    ref_q = sqrt_img(torch.as_tensor(qd["image"].astype(np.float32), device=dev))

    cam = scenes.city_camera(w, h)
    cfg = RenderConfig(
        width=w, height=h, samples_per_launch=1, max_depth=4,
        traversal="cluster", dispatch_tiles=1, sort_rays=True,
        nee_final_bounce=False, batch_spp=True, sampling="sobol",
        russian_roulette=True,
    )
    fov = FoveationConfig(inner_radius=157, outer_radius=515, progressive=True)
    fr = FoveatedRenderer(cs, probe, cfg, cam, fov)
    fr.set_gaze(cx, h - 1 - cy)  # image coordinates: the splat centre is the disc's

    half = 192  # the fovea crop, 384x384 around the gaze; the r=157 disc lies inside
    r0, c0 = cy - half, cx - half
    disc_rows, disc_cols = idx // w - r0, idx % w - c0
    # first-hit guides of the crop (gaze and camera are static): one primary
    # visibility pass through the cluster walk and the engine's hit geometry
    ys, xs = np.mgrid[r0:r0 + 2 * half, c0:c0 + 2 * half]
    uu, vv, ww = cam.uvw_frame()
    dirs = ((2.0 * (xs.ravel() + 0.5) / w - 1.0)[:, None] * uu[None]
            + (2.0 * (ys.ravel() + 0.5) / h - 1.0)[:, None] * vv[None] + ww[None])
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    d3 = v3(dirs, dev)
    o3 = Vec3(*(torch.full_like(d3.x, float(c)) for c in np.asarray(cam.eye, np.float32)))
    rec = tc.closest_hit_cluster(cs.clusters, o3, d3, 1e-3, 1e16)
    nrm, _, alb, _ = _hit_geometry(cs, rec, d3, False)
    hit = rec.t < 1e15
    sh = (2 * half, 2 * half)
    g_nrm, g_alb = (torch.stack([torch.where(hit, c, 0.0) for c in v], -1).reshape(sh + (3,))
                    for v in (nrm, alb))
    g_z = torch.where(hit, rec.t, 0.0).reshape(sh)

    def rmses():
        img = _accum(fr.accum)  # (W*H, 3), canonical
        raw = sqrt_rmse(img[idx], ref_disc)
        crop = img.reshape(h, w, 3)[r0:r0 + 2 * half, c0:c0 + 2 * half]
        dn = atrous_denoise(crop, g_nrm, g_alb, sigma_color=4.0, sigma_albedo=1.0, depth=g_z,
                            demodulate=True)
        return raw, sqrt_rmse(dn[disc_rows, disc_cols], ref_disc)

    def companion():
        q = _accum(fr.accum).reshape(h // 4, 4, w // 4, 4, 3).mean(dim=(1, 3))
        return sqrt_rmse(q, ref_q)

    fr.render()  # warm-up, then a fresh accumulation
    rmses()
    companion()
    fr.accum = Vec3.zeros((w * h,), dev)
    fr.subframe_index = 0

    t = 0.0
    secs = spp = None
    raw = den = float("inf")
    used = "raw"
    for i in range(max_frames):
        t0 = time.perf_counter()
        fr.render()
        raw, den = rmses()
        _sync(dev)
        t += time.perf_counter() - t0
        if min(raw, den) <= QUALITY_TARGET:
            secs = t
            spp = (i + 1) * fov.fovea_spp
            used = "denoised" if den < raw else "raw"
            break
    return [{
        "metric": "seconds to fovea-disc RMSE<=0.03 @3840x2160 "
                  "(3-zone foveation r157/515, sobol+RR+denoised-fovea)",
        "value": round(secs, 2) if secs is not None else 0.0,
        "unit": "s",
        "vs_baseline": round(2.0 / secs, 3) if secs else 0.0,  # target: <= 2 s
        "reached": secs is not None,
        "seconds": secs,
        "frames": i + 1,
        "final_rmse_raw": round(raw, 5),
        "final_rmse_denoised": round(den, 5),
        "gate_variant": used,
        "fovea_spp": spp,
        "ref_spp": int(fd["spp"]),
        "companion_fullframe_rmse_q": round(companion(), 5),
        "companion_ref_effective_spp": int(qd["effective_spp"]),
        "reference_fps_at_this_config": 41.0,  # the sv4 reference's published rate
    }]


# --------------------------------------------------------------------------
# The interactive loop, demand textures, the other presets (bench.py:916-1162)
# --------------------------------------------------------------------------

INTERACTIVE_METRIC = "interactive foveated fps @640x480"


def interactive_line(cs, probe, frames=16, record_path=None, width=640, height=480):
    """A live foveated viewer loop at 640x480 driven by a scripted circular gaze
    path: fused 3-zone foveation (the sv4 radii scaled to 480 rows), Sobol
    sampling, Russian roulette, fovea 4 spp, and as the display step a
    tone-map and an A-Trous denoise of the fovea crop on the device. Rows
    per frame: i, stateUpdate, render, display (seconds), cursorX, cursorY,
    rays; record_path writes them as TSV. `width` / `height` size the loop
    down for a test (the radii scale with the height); the row's metric
    names 640x480 whatever they are."""
    from .engine.foveated import FoveatedRenderer, FoveationConfig
    from .ops import tonemap
    from .ops.denoise import atrous_denoise

    dev = cs.device
    w, h = width, height
    cam = scenes.city_camera(w, h)
    cfg = RenderConfig(
        width=w, height=h, samples_per_launch=1, max_depth=4,
        traversal="cluster", dispatch_tiles=1, sort_rays=True,
        nee_final_bounce=False, sampling="sobol", russian_roulette=True,
    )
    inner = max(8, 157 * h // 2160)
    fov = FoveationConfig(inner_radius=inner, outer_radius=max(24, 515 * h // 2160),
                          fovea_spp=4)  # a denoised display needs fewer than sv4's 8
    fr = FoveatedRenderer(cs, probe, cfg, cam, fov, fused=True)
    half = min(inner + 7, 64)

    def display(accum, gx, gy):
        """Tone-mapped RGBA8 frame with the denoised fovea crop around the
        gaze (buffer coordinates), on the device."""
        disp = tonemap.finalize(accum, mode=tonemap.TONEMAP_REINHARD, exposure_stops=2.0)
        img = _accum(disp).reshape(h, w, 3).clone()
        ys, xs = slice(gy - half, gy + half), slice(gx - half, gx + half)
        crop = img[ys, xs]
        img[ys, xs] = atrous_denoise(crop, torch.zeros_like(crop), torch.ones_like(crop),
                                     iterations=3, sigma_color=1.0)
        return tonemap.pack_rgba8(Vec3(*(img[:, :, k].reshape(-1) for k in range(3))))

    rows = []
    fps_list = []
    margin = half + 2
    fr.render()  # warm-up
    display(fr.accum, w // 2, h // 2)[:4].cpu()
    for i in range(frames):
        t0 = time.perf_counter()
        ang = 2 * math.pi * i / max(frames, 1)
        gx = int(w / 2 + 0.22 * w * math.cos(ang))
        gy = int(h / 2 + 0.22 * h * math.sin(ang))
        gx = min(max(gx, margin), w - 1 - margin)
        gy = min(max(gy, margin), h - 1 - margin)
        fr.set_gaze(gx, gy)
        t1 = time.perf_counter()
        fr.render()
        t2 = time.perf_counter()
        display(fr.accum, gx, h - 1 - gy)
        _sync(dev)
        t3 = time.perf_counter()
        rows.append((i, t1 - t0, t2 - t1, t3 - t2, gx, gy, fr.last_rays))
        fps_list.append(1.0 / (t3 - t1))
    if record_path:
        os.makedirs(os.path.dirname(record_path), exist_ok=True)
        with open(record_path, "w") as f:
            f.write("i\tstateUpdate\trender\tdisplay\tcursorX\tcursorY\trays\n")
            for r_ in rows:
                f.write("\t".join(str(x) for x in r_) + "\n")
    steady = fps_list[1:] if len(fps_list) > 1 else fps_list
    fps = float(np.mean(steady))
    return {
        "metric": "interactive foveated fps @640x480 (fused 3-zone, "
                  "scripted gaze orbit, sobol+RR+denoised fovea display)",
        "value": round(fps, 3),
        "unit": "fps",
        "vs_baseline": round(fps / 2.0, 3),  # target: >= 2 fps
        "frames": frames,
        "render_ms_mean": 1e3 * float(np.mean([r_[2] for r_ in rows[1:]])),
        "display_ms_mean": 1e3 * float(np.mean([r_[3] for r_ in rows[1:]])),
    }


DEMAND_METRIC = "demand-textured loft fps"


def demand_textures_line(on_cpu, device):
    """The loft with its walls re-skinned by 8192x8192 procedural sources
    (checkerboards and a Mandelbrot set) streamed through a demand pool of
    1024 tiles with 6-level mips and footprint LOD: steady-state fps after
    a settling frame, and the pager's counters. Gate: the steady frames
    shade no page that is not resident."""
    from .io.demand import CheckerBoardSource, DemandTextureManager, MandelbrotSource
    from .io.obj import load_obj

    hs = load_obj(os.path.join(REPO, "scenes", "loft.obj"))
    sources = [
        CheckerBoardSource(8192, 8192, squares_per_side=128,
                           color_a=(0.8, 0.7, 0.55), color_b=(0.45, 0.3, 0.2)),
        MandelbrotSource(8192, 8192),
        CheckerBoardSource(8192, 8192, squares_per_side=32,
                           color_a=(0.75, 0.75, 0.78), color_b=(0.5, 0.52, 0.6)),
    ]
    while len(sources) < len(hs.textures):
        sources.append(CheckerBoardSource(8192, 8192))
    mgr = DemandTextureManager(sources[: len(hs.textures)], capacity=1024, levels=6, device=device)
    cs = compile_scene(hs, device, **BUILD)
    probe = scenes.dark_probe(device)
    w, h = 480, 320
    cfg = RenderConfig(
        width=w, height=h, samples_per_launch=2, max_depth=3,
        traversal="lockstep" if on_cpu else "cluster", dispatch_tiles=1,
        sort_rays=not on_cpu, nee_final_bounce=False, batch_spp=True,
        emission_all_bounces=True, use_shading_normals=True,
    )
    cam = scenes.loft_camera(w, h, fov_y=55)
    r = Renderer(cs, probe, cfg, cam, demand=mgr)
    t0 = time.perf_counter()
    r.render(download=False)  # first frame: settle (page in the working set)
    _sync(device)
    settle_s = time.perf_counter() - t0
    loaded_at_settle = mgr.pages_loaded
    frames = 3  # steady state: the same camera, pages resident
    t0 = time.perf_counter()
    for _ in range(frames):
        r.render(download=False)
    rays = float(r.last_output.rays_traced)
    _sync(device)
    dt = time.perf_counter() - t0
    usage = r.last_output.tex_usage.cpu().numpy()
    non_resident_shaded = int((usage & (mgr._page_table < 0)).sum())
    fps = frames / dt
    return {
        "metric": "demand-textured loft fps (3x 8k procedural sources, "
                  f"6-level mips, cluster backend, {w}x{h} spp2 depth3)",
        "value": 0.0 if non_resident_shaded else round(fps, 3),
        "unit": "fps",
        "vs_baseline": 0.0,
        "pages_resident": int((mgr._page_table >= 0).sum()),
        "pages_loaded": mgr.pages_loaded,
        "pages_evicted": mgr.pages_evicted,
        "pages_total_addressable": int(mgr.num_pages),
        "pool_capacity": mgr.capacity,
        "settle_pages": loaded_at_settle,
        "settle_s": settle_s,  # the settle frame with its host page reads
        "non_resident_shaded_steady": non_resident_shaded,
        "rays_per_s": rays * frames / dt / 1e6,
    }


def per_config_lines(cs, probe, cam):
    """One perf line per other preset: hello_raytracing, whitted, spectral.
    Each row is gated on a finite, non-constant frame (`frame_ok`; the
    radiometry is held by the preset goldens)."""
    from . import models

    dev = cs.device
    rows = []

    def timed(render, frames=3):
        img = render()  # warm-up
        t0 = time.perf_counter()
        for _ in range(frames):
            img = render()
        _sync(dev)
        dt = time.perf_counter() - t0
        a = np.asarray(img)
        ok = bool(np.isfinite(a[np.isfinite(a)].astype(np.float64)).all() and a.std() > 0)
        return frames / dt, ok

    def row(metric, make, frames=3, extra=None):
        # one preset's failure must not take down the others'
        try:
            fps, ok = timed(make(), frames=frames)
        except Exception as e:  # noqa: BLE001 — reported as the row's error
            traceback.print_exc()
            rows.append({"metric": metric, "value": 0.0, "unit": "fps", "vs_baseline": 0.0,
                         "error": str(e)[:200]})
            return
        r = {"metric": metric, "value": round(fps, 3) if ok else 0.0, "unit": "fps",
             "vs_baseline": 0.0, "frame_ok": ok}
        if extra and ok:
            r.update(extra(fps))
        rows.append(r)

    row("hello_raytracing fps (primary+shadow, 150k-tri city, 1200x800)",
        lambda: models.make_hello_renderer(cs, cam, width=1200, height=800).render,
        extra=lambda fps: {"mrays_per_s_min": round(fps * 1200 * 800 * 2 / 1e6, 2)})
    row("whitted fps (glass/metal spheres + floor, depth 3, 768x576)",
        lambda: models.make_whitted_renderer(width=768, height=576, max_depth=3,
                                             device=dev).render)
    row("spectral fps (hero-wavelength 4-lambda, 150k-tri city, "
        "1200x800 spp2 depth4)",
        lambda: models.make_spectral_renderer(cs, probe, cam, width=1200, height=800, spp=2,
                                              max_depth=4).render,
        frames=2)
    return rows


# --------------------------------------------------------------------------
# More than one card: strips over NCCL ranks (bench.py:1353-1393)
# --------------------------------------------------------------------------

def strip_bench_program(rank, world, device, hs, sky, cfg, cam, frames) -> dict:
    """One rank of the headline's strip split: a `DistributedRenderer` frame
    to warm up, then `frames` timed frames; the rays of all ranks and this
    rank's seconds."""
    from .parallel.tiles import DistributedRenderer

    cs = compile_scene(hs, device, **BUILD)
    dr = DistributedRenderer(cs, build_probe(sky, device), cfg, cam)
    dr.render()
    torch.distributed.barrier()
    rays = 0.0
    t0 = time.perf_counter()
    for _ in range(frames):
        dr.render()
        rays += dr.last_rays
    _sync(device)
    return dict(rank=rank, rays=rays, seconds=time.perf_counter() - t0)


def multi_device_frames(hs, sky, cfg, cam, world, frames, backend="nccl", device="cuda"):
    """(rays, seconds) of `frames` strip-split frames over `world` ranks
    (rank r on cuda:r under NCCL): the rays of all ranks, the slowest
    rank's seconds."""
    from .parallel.ranks import run_ranks

    with tempfile.TemporaryDirectory() as tmp:
        res = run_ranks(strip_bench_program, world, backend, device, os.path.join(tmp, "rdv"),
                        args=(hs, sky, cfg, cam, frames))
    return res[0]["rays"], max(r["seconds"] for r in res)


# --------------------------------------------------------------------------
# main (bench.py:1179-1512)
# --------------------------------------------------------------------------

def _parse(argv):
    p = argparse.ArgumentParser(prog="optixpathtracer_tpu_torch.bench",
                                description="throughput benchmark of the port")
    p.add_argument("--small", action="store_true", help="320x240, 1 spp, a 400-box city")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (the lockstep walk)")
    p.add_argument("--scene", choices=SCENES, default="city")
    p.add_argument("--no-fullres", action="store_true", help="skip the 1200x800 quality track")
    p.add_argument("--no-big", action="store_true", help="skip the 1.35M-triangle line")
    p.add_argument("--no-4k", action="store_true", help="skip the sv4 4K quality row")
    return p.parse_args(argv)


def _device(cpu: bool) -> torch.device:
    """cuda:0, or the CPU when `cpu`; without a CUDA device and without
    `cpu` it raises (the bench and the tools never fall back)."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("this runs on a CUDA device and none is available "
                           "(pass --cpu to run on the CPU)")
    return torch.device("cuda", 0)


def _scene(name: str, small: bool):
    """(HostScene, label) of bench.py's --scene."""
    if name == "loft":
        from .io.obj import load_obj

        return load_obj(os.path.join(REPO, "scenes", "loft.obj")), "loft interior"
    if name == "hostile":
        return (scenes.build_hostile_scene(n_boxes=980 if small else 9800),
                "150k-tri hostile terrain+rotated city")
    if name == "big":
        return (scenes.build_big_scene(n_boxes=1250 if small else 12500,
                                       terrain_grid=(256, 128) if small else (1024, 512)),
                "1.35M-tri city+terrain (hier backend)")
    return scenes.build_city_scene(n_boxes=400 if small else 12500), "150k-tri city"


def _warm_up(device: torch.device):
    """CUDA context, the sweep kernels' build and the host builders, outside
    the build timer. Returns the nvcc build's seconds (None on the CPU; 0.0
    when the library was built before)."""
    nvcc_s = None
    if device.type == "cuda":
        from .ops import cuda_build

        torch.zeros(1, device=device)
        cuda_build.load("traverse_cluster")
        nvcc_s = cuda_build.build_info["traverse_cluster"]["seconds"]
    compile_scene(scenes.build_city_scene(n_boxes=4), device, **BUILD)
    _sync(device)
    return nvcc_s


def runs_tracks(args, on_cpu: bool) -> bool:
    """The tracks run on the city at full size on the card only (the
    committed references are of the city at full size)."""
    return args.scene == "city" and not args.small and not on_cpu


def _failed(rec: dict) -> str | None:
    """Why a printed row failed, or None."""
    if "error" in rec:
        return rec["error"]
    if rec.get("frame_ok") is False:
        return "frame not finite or constant"
    if rec.get("non_resident_shaded_steady"):
        return f"{rec['non_resident_shaded_steady']} non-resident pages shaded"
    if rec.get("detail", {}).get("gate_mismatch_rays"):
        return f"{rec['detail']['gate_mismatch_rays']} rays apart from the oracle"
    return None


def main(argv=None) -> int:
    args = _parse(argv)
    dev = _device(args.cpu)
    on_cpu = dev.type == "cpu"
    small = args.small
    loft = args.scene == "loft"
    width, height = (320, 240) if small else (1200, 800)
    spp = 1 if small else 2

    hs, scene_label = _scene(args.scene, small)
    t0 = time.perf_counter()
    nvcc_s = _warm_up(dev)
    warmup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # cluster_size 256: fatter member evaluations amortise each one's fixed cost
    cs = compile_scene(hs, dev, **BUILD)
    _sync(dev)
    build_s = time.perf_counter() - t0

    if loft:  # the closed room is lit by its emissive panels, not the sky
        sky = np.full((8, 16, 3), 1e-6, np.float32)
    else:  # sky probe with a sun
        sky = np.full((64, 128, 3), 0.4, np.float32)
        sky[8:12, 30:34] = (60.0, 55.0, 45.0)
    probe = build_probe(sky, dev)

    cfg = RenderConfig(
        width=width, height=height, samples_per_launch=spp, max_depth=4,
        traversal="lockstep" if on_cpu else "cluster",
        dispatch_tiles=1 if small else 2,
        sort_rays=not on_cpu,
        nee_final_bounce=False,  # the reference discards the last bounce's NEE
        batch_spp=not small,
        emission_all_bounces=loft,
        use_shading_normals=loft,
    )
    cam = scenes.loft_camera(width, height, fov_y=55) if loft else scenes.city_camera(width, height)

    # ---- quality gate: the headline counts only if the walk agrees with the
    # dense no-cull oracle on this very scene (8192 mixed rays)
    gate = None
    gate_mismatch = 0
    seconds = {"warmup": warmup_s}  # wall seconds of the stages the detail times nowhere else
    t0 = time.perf_counter()
    if not on_cpu:
        gate = exactness_gate(cs, hs, cam, dev)
        gate_mismatch = gate["mismatch"]
    seconds["gate"] = time.perf_counter() - t0

    util = None
    t0 = time.perf_counter()
    if not on_cpu and not small:
        util = measure_utilization(cs, cam)
    seconds["utilization"] = time.perf_counter() - t0

    r = Renderer(cs, probe, cfg, cam)
    t0 = time.perf_counter()
    r.render()  # the first frame
    _sync(dev)
    compile_s = time.perf_counter() - t0

    n_dev = torch.cuda.device_count() if not on_cpu else 1
    frames = 2 if small else 4
    rays = 0.0
    overflow = 0.0
    scaling = launches = None
    if n_dev > 1:  # strips over every card whose count divides the pixel grid
        world = n_dev
        while (width * height) % world:
            world -= 1
        t0 = time.perf_counter()
        r.render()  # one device's frame (r is warm)
        _sync(dev)
        single_dt = time.perf_counter() - t0
        single_mrays = float(r.last_output.rays_traced) / single_dt / 1e6
        overflow += float(r.last_output.bfs_overflow)
        rays, dt = multi_device_frames(hs, sky, cfg, cam, world, frames)
        mrays = rays / dt / 1e6
        scaling = {
            "n_devices": world,
            "single_device_mrays": single_mrays,
            "scaling_efficiency": mrays / (world * single_mrays) if single_mrays > 0 else 0.0,
        }
    else:
        tc.launch_counts.clear()  # the kernels the timed frames launch
        t0 = time.perf_counter()
        for _ in range(frames):
            r.render()
            rays += float(r.last_output.rays_traced)
            overflow += float(r.last_output.bfs_overflow)
        _sync(dev)
        dt = time.perf_counter() - t0
        mrays = rays / dt / 1e6
        launches = dict(tc.launch_counts)
    fps = frames / dt

    # ---- refuse a headline number from wrong images -------------------------
    gated_out = (overflow != 0.0) or (gate_mismatch != 0)
    projected_8chip = None
    if util is not None and not gated_out:
        # strip split over 8 cards: 8 x this card's rate x the measured
        # shard-size sweep efficiency
        projected_8chip = 8 * mrays * util["scale8"]["per_chip_efficiency"]
    failures = []

    def emit(rec):
        print(json.dumps(rec), flush=True)
        why = _failed(rec)
        if why:
            failures.append(f"{rec['metric']}: {why}")

    print(json.dumps({
        "metric": f"Mrays/s incoherent (Disney PT, depth 4, {scene_label}, 1200x800)",
        "value": 0.0 if gated_out else round(mrays, 3),
        "unit": "Mrays/s",
        "vs_baseline": 0.0 if gated_out else round(mrays / TARGET_MRAYS, 4),
    }), flush=True)
    if gated_out:
        failures.append(f"headline gated out: {gate_mismatch} gate rays apart from the oracle, "
                        f"overflow {overflow}")

    track_seconds = []

    def guarded(metric, unit, fn):
        """Print fn()'s rows; an exception becomes the row's error."""
        t0 = time.perf_counter()
        try:
            out = fn()
        except Exception as e:  # noqa: BLE001 — one broken row must not take down the rest
            traceback.print_exc()
            out = [{"metric": metric, "value": 0.0, "unit": unit, "vs_baseline": 0.0,
                    "error": str(e)[:200]}]
        out = out if isinstance(out, list) else [out]
        track_seconds.append({"metrics": [rec["metric"] for rec in out],
                              "seconds": time.perf_counter() - t0})
        for rec in out:
            emit(rec)

    if runs_tracks(args, on_cpu):
        guarded(QUALITY_METRIC, "s", lambda: quality_track(cs, probe, on_cpu))
        if not args.no_fullres:
            guarded(QUALITY_METRIC, "s", lambda: quality_track(
                cs, probe, on_cpu, ref_path=os.path.join(REPO, "scenes", "ref_city_1200x800.npz")))
        guarded(DEMAND_METRIC, "fps", lambda: demand_textures_line(on_cpu, dev))
        guarded("per-config lines", "fps", lambda: per_config_lines(cs, probe, cam))
        if not args.no_big:
            city_bounce = (util or {}).get("bounce_sorted", {}).get("mrays_per_s_sweep", 0.0)
            guarded(BIG_METRIC, "Mrays/s", lambda: big_scene_line(city_bounce, dev))
        guarded(INTERACTIVE_METRIC, "fps", lambda: interactive_line(cs, probe))
        if not args.no_4k:
            guarded(FOVEA4K_METRIC, "s", lambda: fovea4k_track(cs, probe))

    print(json.dumps({"detail": {
        "fps": fps,
        "spp_per_launch": spp,
        "rays_total": rays,
        "traversal": cfg.traversal,
        "walk": None if on_cpu else walk_of(cs.clusters),
        "launches": launches,
        "overflow": overflow,
        "gate_mismatch_rays": gate_mismatch,
        "gate": gate,
        "quality_gated_out": gated_out,
        "bvh_build_s": build_s,
        "nvcc_s": nvcc_s,
        "first_frame_incl_compile_s": compile_s,
        "triangles": cs.num_triangles,
        "scene": args.scene,
        "width": width,
        "height": height,
        "spp": spp,
        "devices": ([torch.cuda.get_device_name(i) for i in range(n_dev)][:4] if not on_cpu
                    else ["cpu"]),
        "nvidia_smi": None if on_cpu else nvidia_smi(),
        "scaling": scaling,
        "projected_8chip_mrays": projected_8chip,
        "utilization": util,
        "seconds": seconds,
        "track_seconds": track_seconds,
        "failed": failures,
    }}), file=sys.stderr, flush=True)
    if failures:
        print("BENCH FAILED: " + "; ".join(failures), file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

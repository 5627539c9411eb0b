#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It builds the three hand-written cluster-traversal kernels
(optixpathtracer_tpu_torch/csrc/traverse_cluster.cu), holds each against its
plain PyTorch version on the card, runs the bench's exactness gate and the
`disney_open*` golden renders on the card, then drives the main path — the
`disney_pt` preset on the 150k-triangle city at 1200x800, 2 spp, depth 4,
with the bench's flags — and checks that it went through the kernels.
Every phase prints one JSON line; any failure exits non-zero. The last
line is the device contract:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

It exits non-zero without a CUDA device, and outside the repository (the
port package must be importable beside it).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
RMSE_TOL = 2e-3  # tests/test_goldens.py
PLAIN_BUDGET_S = 60.0  # time a plain version at the slice shape within this
WIDTH, HEIGHT, SPP, DEPTH = 1200, 800, 2, 4
BENCH_FLAGS = dict(sort_rays=True, batch_spp=True, nee_final_bounce=False)
KERNELS = {  # name -> the TPU kernel it replaces
    "cull": "optixpathtracer_tpu/ops/traverse_cluster.py:226",
    "closest": "optixpathtracer_tpu/ops/traverse_cluster.py:482",
    "any": "optixpathtracer_tpu/ops/traverse_cluster.py:622",
}
SOURCE = "optixpathtracer_tpu_torch/csrc/traverse_cluster.cu"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of fn, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _device_us(e) -> float:
    """Self device time (us) of a profiler key-average entry."""
    return float(getattr(e, "self_device_time_total", 0.0) or getattr(e, "self_cuda_time_total", 0.0))


def mixed_rays(cs, hs, cam, n, seed, device):
    """bench.py's gate rays: half camera rays, half scene-interior rays."""
    import torch

    from optixpathtracer_tpu_torch.core.math import Vec3

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

    def v3(a):
        return Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, i]), device=device) for i in range(3)))

    return v3(og), v3(dg)


def sub_cull(cr, nr):
    """The first nr ray blocks of a CullResult."""
    from optixpathtracer_tpu_torch.ops.traverse_cluster import BLOCK

    return cr._replace(**{k: getattr(cr, k)[:nr] for k in cr._fields if k != "rays8"},
                       rays8=cr.rays8[: nr * BLOCK])


def compare(name, kernel_out, plain_out):
    """max |kernel - plain| over a kernel's outputs; raises unless bit-equal."""
    import torch

    err = 0.0
    for k, p in zip(kernel_out, plain_out):
        if k is None or p is None:
            continue
        if not torch.equal(k, p):
            bad = int((k != p).sum())
            raise AssertionError(f"{name}: kernel differs from its plain version in {bad} values")
        err = max(err, float((k.double() - p.double()).abs().max()) if k.numel() else 0.0)
    return err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    try:
        import optixpathtracer_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the repository root (optixpathtracer_tpu_torch not found)",
              file=sys.stderr)
        return 2

    from optixpathtracer_tpu_torch import scenes
    from optixpathtracer_tpu_torch.builder import compile_scene
    from optixpathtracer_tpu_torch.core.math import Vec3
    from optixpathtracer_tpu_torch.core.rng import RngState, tea
    from optixpathtracer_tpu_torch.engine import wavefront
    from optixpathtracer_tpu_torch.lights.probe import probe_sample
    from optixpathtracer_tpu_torch.models import make_disney_pt_renderer
    from optixpathtracer_tpu_torch.ops import cuda_build
    from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    card = f"{torch.cuda.get_device_name(0)}, power limit {smi.split(',')[-1].strip() if smi else 'unknown'}"
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # ---- build ------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.load("traverse_cluster")
    info = cuda_build.build_info["traverse_cluster"]
    ptxas = [ln.strip() for ln in info["ptxas"].splitlines() if "registers" in ln or "spill" in ln]
    emit("build", source=SOURCE, seconds=time.perf_counter() - t0, nvcc_seconds=info["seconds"],
         ptxas=ptxas)

    # ---- the city, and the slice's renderer ------------------------------
    t0 = time.perf_counter()
    hs = scenes.build_city_scene()
    cs = compile_scene(hs, dev, leaf_size=8, cluster_size=256)
    torch.cuda.synchronize()
    emit("scene", triangles=cs.num_triangles, entries=cs.clusters.num_entries,
         cluster_size=cs.clusters.cluster_size, build_s=time.perf_counter() - t0)
    cam = scenes.city_camera(WIDTH, HEIGHT)
    probe = scenes.city_sky(dev)
    renderer = make_disney_pt_renderer(cs, probe, cam, width=WIDTH, height=HEIGHT, spp=SPP,
                                       max_depth=DEPTH, **BENCH_FLAGS)
    cfg = renderer.config
    cl = cs.clusters
    c = cl.cluster_size
    sph_t = tc.sphere_table(cl)

    # ---- kernels vs plain, bit for bit, on 64k mixed rays -----------------
    o, d = mixed_rays(cs, hs, cam, 65536, 7, dev)
    rays8 = tc._pack_rays8(cl, o, d, 1e-3, 1e16)
    errs = {"cull": compare("cull", tc.cull_blocks(rays8, sph_t), tc._cull_torch(rays8, sph_t))}
    cr = tc.block_cull(cl, o, d, 1e-3, 1e16)
    errs["closest"] = compare("closest", tc.closest_sweep(cl.rows, cl.xf_inv, cr, c)[:2],
                              tc._closest_torch(cl.rows, cl.xf_inv, cr, c))
    cr_s = tc.block_cull(cl, o, d, 0.01, 1e16)
    errs["any"] = compare("any", (tc.any_sweep(cl.rows, cl.xf_inv, cr_s, c),),
                          (tc._any_torch(cl.rows, cl.xf_inv, cr_s, c),))
    emit("kernels_vs_plain", rays=65536, max_abs_err=errs, bit_equal=True)

    # ---- times at the slice's shapes: the first-bounce wavefront ----------
    cam_p = wavefront.CameraParams.from_camera(cam, dev)
    o1, d1 = wavefront.first_bounce_rays(cfg, cam_p, *renderer.pixels)
    n1 = o1.x.shape[0]
    no = torch.zeros(n1, dtype=torch.bool, device=dev)
    perm = wavefront._stable_argsort(wavefront._coherence_key(o1, d1, no, cl.scene_aabb))
    o1, d1 = Vec3(*(a[perm] for a in o1)), Vec3(*(a[perm] for a in d1))
    rays8_1 = tc._pack_rays8(cl, o1, d1, cfg.t_min, cfg.t_max)
    cr1 = tc.block_cull(cl, o1, d1, cfg.t_min, cfg.t_max)
    # the NEE shadow rays of that bounce, coherence-sorted as the engine does
    rec = tc.closest_hit_cluster(cl, o1, d1, cfg.t_min, cfg.t_max)
    p_hit = o1 + d1 * rec.t
    _, wi, _, _ = probe_sample(probe, RngState.seed(tea(torch.arange(n1, device=dev), 7)))
    t_sh = torch.where(rec.hit, cfg.t_max, 0.0)
    perm = wavefront._stable_argsort(
        wavefront._coherence_key(p_hit, wi, t_sh <= cfg.shadow_t_min, cl.scene_aabb))
    p_hit, wi, t_sh = Vec3(*(a[perm] for a in p_hit)), Vec3(*(a[perm] for a in wi)), t_sh[perm]
    cr_sh = tc.block_cull(cl, p_hit, wi, cfg.shadow_t_min, t_sh)

    nr_full = cr1.ids.shape[0]
    timing = {}
    cases = {
        "cull": (lambda: tc.cull_blocks(rays8_1, sph_t),
                 lambda nr: tc._cull_torch(rays8_1[: nr * tc.BLOCK], sph_t)),
        "closest": (lambda: tc.closest_sweep(cl.rows, cl.xf_inv, cr1, c),
                    lambda nr: tc._closest_torch(cl.rows, cl.xf_inv, sub_cull(cr1, nr), c)),
        "any": (lambda: tc.any_sweep(cl.rows, cl.xf_inv, cr_sh, c),
                lambda nr: tc._any_torch(cl.rows, cl.xf_inv, sub_cull(cr_sh, nr), c)),
    }
    for name, (kern, plain) in cases.items():
        ms = cuda_ms(kern, reps=5)
        probe_nr = max(8, nr_full // 32)
        est_s = cuda_ms(lambda: plain(probe_nr), reps=1) / 1e3 * nr_full / probe_nr
        nr = nr_full if est_s <= PLAIN_BUDGET_S else max(8, int(nr_full * PLAIN_BUDGET_S / est_s))
        plain_ms = cuda_ms(lambda: plain(nr), reps=1)
        if nr == nr_full:  # the whole wavefront: hold the kernel to it here too
            out_k = kern()
            out_k = out_k[:2] if name == "closest" else (out_k if name == "cull" else (out_k,))
            out_p = plain(nr)
            out_p = (out_p,) if name == "any" else out_p
            compare(name, out_k, out_p)
        timing[name] = dict(ms=ms, plain_ms=plain_ms, rays=n1, plain_rays=nr * tc.BLOCK)
        emit("kernel_time", kernel=name, wavefront="first bounce, 1200x800x2spp", **timing[name],
             card=card)
    # ---- exactness gate (bench.py:1302-1340) ------------------------------
    og, dg = mixed_rays(cs, hs, cam, 8192, 42, dev)
    fast = tc.closest_hit_cluster(cl, og, dg, 1e-3, 1e16)
    exact = tc.reference_closest(cl, og, dg, 1e-3, 1e16)
    mismatch = int((fast.tri != exact.tri).sum())
    emit("exactness_gate", rays=8192, mismatch=mismatch, hits=int((exact.tri >= 0).sum()))
    if mismatch:
        raise AssertionError(f"exactness gate: {mismatch} rays disagree with reference_closest")

    # ---- goldens on the card ---------------------------------------------
    for name in scenes.OPEN_GOLDENS:
        got = scenes.render_open_golden(name, dev)
        want = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))["image"]
        rmse = scenes.golden_rmse(got, want)
        emit("golden", name=name, rmse=rmse, tol=RMSE_TOL)
        if not (got.shape == want.shape and rmse <= RMSE_TOL):
            raise AssertionError(f"golden {name}: RMSE {rmse} > {RMSE_TOL}")

    # ---- the slice --------------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tc.launch_counts.clear()
    renderer.render(download=False)  # warm-up
    times, rays = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        renderer.render(download=False)  # ends in torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rays.append(int(renderer.last_output.rays_traced))
    launches = dict(tc.launch_counts)
    img = renderer.accum_image()
    frame_s = float(np.median(times))
    emit("slice", width=WIDTH, height=HEIGHT, spp=SPP, max_depth=DEPTH, flags=BENCH_FLAGS,
         frame_s=frame_s, frame_times_s=times, rays_traced=rays[-1],
         mrays_per_s=rays[-1] / frame_s / 1e6, max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, image_mean=float(img.mean()), card=card)
    if img.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(img).all() or not img.max() > 0:
        raise AssertionError("the slice's frame is not a finite, non-black 1200x800 image")
    for name in KERNELS:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"the main path never launched kernel {name}")

    # one more frame under the profiler (not timed above): device busy time
    # by kernel, and the device's idle share of the frame
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        renderer.render(download=False)
        wall = time.perf_counter() - t0
    # device-side entries only: the CPU-side op entries repeat their kernels'
    # device time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    busy = sum(_device_us(e) for e in events) / 1e6
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time: no idle share")
    top = sorted(events, key=_device_us, reverse=True)[:15]
    emit("profile", wall_s=wall, device_busy_s=busy, idle_share=1.0 - busy / wall,
         top=[{"name": e.key[:80], "ms": _device_us(e) / 1e3, "calls": e.count} for e in top])

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": KERNELS[name],
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"]}
        for name in KERNELS
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 — report the failing phase, exit non-zero
        traceback.print_exc()
        emit("failed", error=traceback.format_exc().strip().splitlines()[-1])
        sys.exit(1)

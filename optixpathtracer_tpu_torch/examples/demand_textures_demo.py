"""Demand-loaded sparse textures driven by visibility feedback; port of
examples/demand_textures_demo.py.

A ground plane carries a huge (8k x 8k) procedural checkerboard texture,
far too big to keep resident. Primary rays through the port's closest-hit
entry point (`ops/dispatch.trace_closest`) give first-hit (tex, u, v);
sampling the sparse pool (`io/demand.sample_demand`) records page
requests; the host pager services them; the next pass finds the pages
resident. The loop ends when a pass loads nothing. Only the pages the
camera sees are ever loaded (the point of the reference's DemandLoading
library, which its build disables: CMakeLists.txt:385-386). It runs on the
card unless --cpu is given (the original ran on the CPU only because of
its accelerator's transfer costs).

Run:  python -m optixpathtracer_tpu_torch.examples.demand_textures_demo [out.png] [--cpu]
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..builder import compile_scene
from ..core.camera import Camera
from ..core.materials import make_material
from ..core.math import Vec3, normalize
from ..core.scene import HostScene, Mesh
from ..engine.wavefront import CameraParams
from ..io.demand import CheckerBoardSource, DemandTextureManager, sample_demand
from ..io.image import save_png
from ..ops.dispatch import trace_closest
from ..tools import device
from . import parse

TEX = 8192  # the checkerboard's side in texels
GROUND = 60.0  # the ground quad's half side; its uv spans 0..1 across it
MAX_PASSES = 11


def demand_scene() -> HostScene:
    """The uv-mapped ground quad (material 0) and a box on it."""
    hs = HostScene()
    s = GROUND
    verts = np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]], np.float32)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    faces = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    hs.add_mesh(Mesh(vertices=verts, indices=faces, texcoords=uvs,
                     material=make_material(color=(1, 1, 1))))
    hs.add_box(make_material(color=(0.8, 0.3, 0.2)), pos=(0, 1.5, 0), extent=(1.5, 1.5, 1.5))
    return hs


def first_hit(cs, cam: CameraParams, width: int, height: int):
    """Per pixel (bottom-first rows): (tex id, u, v, hit, shade, mip lod) of
    the primary ray's first hit. Divisions by the frame size go through
    device scalars, so the card divides as the CPU does."""
    dev = cs.device
    ys, xs = np.divmod(np.arange(width * height, dtype=np.int32), width)
    px = torch.as_tensor(xs, device=dev).to(torch.float32)
    py = torch.as_tensor(ys, device=dev).to(torch.float32)
    w = torch.tensor(float(width), device=dev)
    h = torch.tensor(float(height), device=dev)
    dx = 2.0 * (px + 0.5) / w - 1.0
    dy = 2.0 * (py + 0.5) / h - 1.0
    d = normalize(cam.u * dx + cam.v * dy + cam.w * 1.0)
    zero = torch.zeros_like(dx)
    o = Vec3(cam.eye.x + zero, cam.eye.y + zero, cam.eye.z + zero)
    rec = trace_closest(cs, o, d, 1e-3, 1e16)
    tri = torch.clamp(rec.tri, min=0).to(torch.int64)
    sc = cs.scene
    w0 = 1.0 - rec.u - rec.v
    tu = sc.uv0u[tri] * w0 + sc.uv1u[tri] * rec.u + sc.uv2u[tri] * rec.v
    tv = sc.uv0v[tri] * w0 + sc.uv1v[tri] * rec.u + sc.uv2v[tri] * rec.v
    # the ground quad is the first mesh: material 0 carries the demand
    # texture, everything else samples nothing
    hit = rec.tri >= 0
    tex = torch.where(hit & (sc.material_id[tri] == 0), 0, -1).to(torch.int32)
    shade = torch.abs(d.y)  # a headlight-like term for the demo image
    # screen-space texel footprint -> mip LOD: the pixel's solid angle
    # grows the footprint with hit distance t and with grazing incidence
    # on the ground plane (1/|d.y|); one TEX-texel texture spans 2 GROUND
    pixel_ang = 2.0 * math.tan(math.radians(45.0 / 2)) / height
    texel_sz = (2 * GROUND) / TEX
    foot = rec.t * pixel_ang / torch.clamp(torch.abs(d.y), min=1e-3) / texel_sz
    lod = torch.clamp(torch.log2(torch.clamp(foot, min=1.0)), 0.0, 5.0)
    return tex, tu, tv, hit, shade, lod


def demand_demo(dev, out: str, width: int = 640, height: int = 400, capacity: int = 4096,
                levels: int = 6, log=print) -> dict:
    """Page the checkerboard in until a pass loads nothing, then write the
    shaded first hits to `out`. Returns the pager's counts and the passes."""
    cs = compile_scene(demand_scene(), dev)
    # 8192^2 checkerboard = 17,689 base pages of 62^2 texels; the pool holds
    # `capacity`, a fraction of the texture; with the mip chain and the
    # distance LOD distant ground resolves from a handful of coarse pages
    src = CheckerBoardSource(width=TEX, height=TEX, squares_per_side=128,
                             color_a=(0.9, 0.9, 0.85), color_b=(0.15, 0.2, 0.5))
    mgr = DemandTextureManager([src], capacity=capacity, levels=levels, device=dev)
    cam = Camera(eye=(9, 5, 9), lookat=(0, 0.8, 0), up=(0, 1, 0), fov_y=45,
                 aspect_ratio=width / height)
    tex, tu, tv, hit, shade, lod = first_hit(cs, CameraParams.from_camera(cam, dev), width, height)

    passes = []
    for npass in range(1, MAX_PASSES + 1):
        color, _, usage = sample_demand(mgr.pool, tex, tu, tv, lod, trilinear=True)
        usage = usage.cpu().numpy()
        loaded = mgr.process_requests(usage)
        passes.append((int(usage.sum()), loaded))
        log(f"pass {npass}: touched {passes[-1][0]} pages, loaded {loaded} "
            f"(total {mgr.pages_loaded}, evicted {mgr.pages_evicted})")
        if loaded == 0:
            break
    resident = int((mgr.pool.page_table >= 0).sum())
    log(f"resident {resident} / {mgr.num_pages} pages ({mgr.pages_loaded} loads): sparse "
        f"residency; distance LOD resolves distant ground from coarse mip pages")

    img = np.zeros((width * height, 3), np.float32)
    rgb = torch.stack(list(color), -1).cpu().numpy()
    hitm = hit.cpu().numpy()
    img[hitm] = rgb[hitm] * shade.cpu().numpy()[hitm, None]
    img[~hitm] = (0.4, 0.55, 0.8)
    img = img.reshape(height, width, 3)[::-1]
    save_png(out, (np.clip(img, 0, 1) ** (1 / 2.2) * 255).astype(np.uint8))
    log(f"wrote {out}")
    return {"resident": resident, "num_pages": mgr.num_pages, "pages_loaded": mgr.pages_loaded,
            "pages_evicted": mgr.pages_evicted, "passes": passes, "image": img}


def main(argv=None) -> int:
    args = parse("demand_textures_demo", "demand_textures.png", argv)
    demand_demo(device(args.cpu), args.out, log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Demand-loaded sparse textures (port of optixpathtracer_tpu/io/demand.py).

The reference's DemandLoading design without sparse hardware textures: a
tile pool of resident texture tiles, each stored with a one-texel gutter
ring so bilinear filtering never needs a neighbour tile, and a page table
mapping page id -> pool slot (or -1). `sample_demand` is plain tensor code:
a page-table lookup and one gather from the pool for resident pages, the
texture's fallback colour for misses, and a `(num_pages,)` page-usage
bitmap of every valid page touch (resident or not: the usage reports drive
the LRU). `DemandTextureManager` is the host pager: it services a launch's
usage bitmap between launches, reads the missing tiles from an
`ImageSource`, assigns slots (free first, then least recently used) and
writes only the touched pool rows and the page table on the device.

The pool's tensors live on the render device; the pager's bookkeeping is
host numpy, as in the reference. The usage scatter is deterministic: every
lane writes the same value (True), and invalid lanes write into a spare
slot past the end, the reference's `mode="drop"`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Protocol, Sequence

import numpy as np
import torch

from ..core.math import Vec3
from ..core.scene import _wrap01

Tensor = torch.Tensor

TILE = 62  # payload texels per tile side; stored side is TILE+2 (gutter)
STORE = TILE + 2


class ImageSource(Protocol):
    """Tile-addressable image (the reference's imageSource::ImageSource)."""

    width: int
    height: int

    def read_texel_block(self, x0: np.ndarray, y0: np.ndarray) -> np.ndarray:
        """Texels at integer grids, (len(y0), len(x0), 3) float32.
        Coordinates may be out of range; sources wrap them."""
        ...


def _wrap(i: np.ndarray, n: int) -> np.ndarray:
    return np.mod(i, n)


@dataclasses.dataclass
class ArraySource:
    """Whole-image-in-memory source (file textures decoded by io/image)."""

    data: np.ndarray  # (H, W, 3) float32

    def __post_init__(self):
        self.data = np.asarray(self.data, np.float32)
        self.height, self.width = self.data.shape[:2]

    def read_texel_block(self, x0, y0):
        return self.data[_wrap(y0, self.height)[:, None], _wrap(x0, self.width)[None, :]]


@dataclasses.dataclass
class CheckerBoardSource:
    """Procedural checkerboard (ImageSource/src/CheckerBoardImage.cpp):
    `squares_per_side` squares across the image, alternating colours."""

    width: int = 4096
    height: int = 4096
    squares_per_side: int = 32
    color_a: tuple = (1.0, 1.0, 1.0)
    color_b: tuple = (0.1, 0.1, 0.4)

    def read_texel_block(self, x0, y0):
        sx = self.width // self.squares_per_side
        sy = self.height // self.squares_per_side
        cx = _wrap(x0, self.width) // sx
        cy = _wrap(y0, self.height) // sy
        par = (cx[None, :] + cy[:, None]) % 2
        a = np.asarray(self.color_a, np.float32)
        b = np.asarray(self.color_b, np.float32)
        return np.where(par[..., None] == 0, a, b).astype(np.float32)


@dataclasses.dataclass
class MandelbrotSource:
    """Procedural Mandelbrot set (ImageSource/src/MandelbrotImage.cpp),
    escape-time shaded over [-2.2, 1] x [-1.6, 1.6]."""

    width: int = 4096
    height: int = 4096
    max_iter: int = 64

    def read_texel_block(self, x0, y0):
        xs = _wrap(x0, self.width) / self.width * 3.2 - 2.2
        ys = _wrap(y0, self.height) / self.height * 3.2 - 1.6
        c = xs[None, :] + 1j * ys[:, None]
        z = np.zeros_like(c)
        count = np.zeros(c.shape, np.int32)
        alive = np.ones(c.shape, bool)
        for _ in range(self.max_iter):
            z = np.where(alive, z * z + c, z)
            alive &= np.abs(z) <= 2.0
            count += alive
        t = count.astype(np.float32) / self.max_iter
        return np.stack([t, t * t, np.sqrt(t)], axis=-1).astype(np.float32)


class DemandTexturePool(NamedTuple):
    """Device-resident sparse texture state. Tables are indexed [texture,
    mip level]; a texture with fewer levels than the table width repeats
    its coarsest row, so any in-range level index is safe."""

    tile_r: Tensor  # (capacity, STORE*STORE) f32 resident tiles + gutter
    tile_g: Tensor
    tile_b: Tensor
    page_table: Tensor  # (num_pages,) i32 page -> slot, or -1 (non-resident)
    page_offset: Tensor  # (T, L) i32 first page id of texture t, level l
    pages_x: Tensor  # (T, L) i32 page-grid width per level
    width: Tensor  # (T, L) i32 level texel dims
    height: Tensor  # (T, L) i32
    levels: Tensor  # (T,) i32 mip levels of each texture
    fallback: Tensor  # (T, 3) f32 per-texture mean colour for misses

    @property
    def num_pages(self) -> int:
        return self.page_table.shape[0]


def _usage(pool: DemandTexturePool, valid: Tensor, *pages: Tensor) -> Tensor:
    """(num_pages,) bool: True at every page a valid lane touched. Invalid
    (and out-of-range) lanes write into one spare slot past the end."""
    n = pool.num_pages
    buf = torch.zeros((n + 1,), dtype=torch.bool, device=valid.device)
    for page in pages:
        ok = valid & (page >= 0) & (page < n)
        buf.index_fill_(0, torch.where(ok, page, n).to(torch.int64), True)
    return buf[:n]


def sample_demand(pool: DemandTexturePool, tex_id: Tensor, u: Tensor, v: Tensor,
                  lod: Tensor | None = None, trilinear: bool = False) -> tuple[Vec3, Tensor, Tensor]:
    """Bilinear sample with wrap addressing from the sparse tile pool.

    `lod` (optional, float per lane) selects the mip level, clamped to the
    texture's chain (rounded half to even); None samples the base level.
    `trilinear=True` blends the two bracketing levels; where only one of
    them is resident the lane samples that level alone.

    Returns (colour, resident mask, usage bitmap). Non-resident lookups
    return the texture's fallback colour; tex_id < 0 samples nothing
    (white, not resident, no usage)."""
    tid = torch.clamp(tex_id, min=0).to(torch.int64)
    valid = tex_id >= 0
    n_levels = pool.levels[tid]
    if lod is None or not trilinear:
        if lod is None:
            lvl = torch.zeros_like(tid)
        else:
            lvl = torch.clamp(torch.round(lod).to(torch.int32), min=0)
            lvl = torch.minimum(lvl, n_levels - 1).to(torch.int64)
        out, resident, page = _sample_level(pool, tid, u, v, lvl)
        usage = _usage(pool, valid, page)
    else:
        lodc = torch.minimum(torch.clamp(lod, min=0.0), (n_levels - 1).to(torch.float32))
        l0 = torch.floor(lodc).to(torch.int32)
        l1 = torch.minimum(l0 + 1, n_levels - 1)
        f = lodc - l0.to(torch.float32)
        out0, res0, page0 = _sample_level(pool, tid, u, v, l0.to(torch.int64))
        out1, res1, page1 = _sample_level(pool, tid, u, v, l1.to(torch.int64))
        both = res0 & res1
        w1 = torch.where(both, f, torch.where(res1, 1.0, 0.0))
        w0 = 1.0 - w1
        # zero the non-resident side so garbage texels never leak in
        w0 = torch.where(res0, w0, 0.0)
        w1 = torch.where(res1, w1, 0.0)
        out = out0 * w0 + out1 * w1
        resident = res0 | res1
        usage = _usage(pool, valid, page0, page1)
    fb = pool.fallback[tid]
    color = Vec3(*(torch.where(valid, torch.where(resident, c, fb[:, k]), 1.0)
                   for k, c in enumerate(out)))
    return color, resident & valid, usage


def _sample_level(pool: DemandTexturePool, tid: Tensor, u: Tensor, v: Tensor,
                  lvl: Tensor) -> tuple[Vec3, Tensor, Tensor]:
    """Wrap-bilinear at one mip level: (colour, resident, page) per lane."""
    w = pool.width[tid, lvl]
    h = pool.height[tid, lvl]
    uu = _wrap01(u) * w.to(torch.float32) - 0.5
    vv = _wrap01(v) * h.to(torch.float32) - 0.5
    x0 = torch.floor(uu)
    y0 = torch.floor(vv)
    fx = uu - x0
    fy = vv - y0
    # the tile holding the base texel; its gutter covers x0+1 / y0+1, and
    # the wrap seam's x0 = -1 folds to the last tile's payload
    xi = torch.remainder(x0.to(torch.int32), w)
    yi = torch.remainder(y0.to(torch.int32), h)
    tx = xi // TILE
    ty = yi // TILE
    page = (pool.page_offset[tid, lvl] + ty * pool.pages_x[tid, lvl] + tx).to(torch.int64)
    slot = pool.page_table[page]
    resident = slot >= 0
    # texel coordinates inside the stored tile (+1 for the gutter ring)
    lx = xi - tx * TILE + 1
    ly = yi - ty * TILE + 1
    s = torch.clamp(slot, min=0).to(torch.int64)

    def fetch(dx, dy):
        idx = ((ly + dy) * STORE + (lx + dx)).to(torch.int64)
        return Vec3(pool.tile_r[s, idx], pool.tile_g[s, idx], pool.tile_b[s, idx])

    c00 = fetch(0, 0)
    c10 = fetch(1, 0)
    c01 = fetch(0, 1)
    c11 = fetch(1, 1)
    top = c00 * (1.0 - fx) + c10 * fx
    bot = c01 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy, resident, page


class DemandTextureManager:
    """Host-side pager (the reference's DemandLoaderImpl + PagingSystem
    roles): owns the sources, assigns pool slots with LRU eviction and
    services usage bitmaps between launches. The pool lives on `device`."""

    def __init__(self, sources: Sequence[ImageSource], capacity: int = 256, levels: int = 1,
                 device="cuda"):
        """levels > 1 builds box-filtered mip pyramids per texture (level l
        dims = max(1, dim >> l), the chain clamped once a level fits one
        tile); levels=1 samples the base level only."""
        self.sources = list(sources)
        self.capacity = int(capacity)
        self.device = torch.device(device)
        max_l = max(1, int(levels))
        n_tex = len(self.sources)
        offs = np.zeros((n_tex, max_l), np.int32)
        px = np.zeros((n_tex, max_l), np.int32)
        w = np.zeros((n_tex, max_l), np.int32)
        h = np.zeros((n_tex, max_l), np.int32)
        n_levels = np.zeros(n_tex, np.int32)
        fb = []
        meta = []  # (texture, level, first page, grid width, grid height)
        total = 0
        for t, s in enumerate(self.sources):
            nl = 1
            while (nl < max_l and max(s.width >> nl, s.height >> nl) >= 1
                   and max(s.width >> (nl - 1), s.height >> (nl - 1)) > TILE):
                nl += 1
            n_levels[t] = nl
            for lv in range(max_l):
                le = min(lv, nl - 1)
                lw = max(1, s.width >> le)
                lh = max(1, s.height >> le)
                gx = -(-lw // TILE)
                gy = -(-lh // TILE)
                if lv < nl:
                    offs[t, lv] = total
                    meta.append((t, lv, total, gx, gy))
                    total += gx * gy
                    px[t, lv] = gx
                else:  # clamp: repeat the coarsest real level's row
                    offs[t, lv] = offs[t, nl - 1]
                    px[t, lv] = px[t, nl - 1]
                w[t, lv] = lw
                h[t, lv] = lh
            # fallback = mean of a sparse 16x16 probe grid
            xs = np.linspace(0, s.width - 1, 16).astype(np.int64)
            ys = np.linspace(0, s.height - 1, 16).astype(np.int64)
            fb.append(s.read_texel_block(xs, ys).reshape(-1, 3).mean(0))
        self.num_pages = total
        self._page_tex = np.zeros(total, np.int32)  # page -> texture id
        self._page_lvl = np.zeros(total, np.int32)  # page -> mip level
        self._page_local = np.zeros(total, np.int64)  # page - level offset
        for t, lv, o, gx, gy in meta:
            self._page_tex[o:o + gx * gy] = t
            self._page_lvl[o:o + gx * gy] = lv
            self._page_local[o:o + gx * gy] = np.arange(gx * gy)
        self._page_table = np.full(total, -1, np.int32)
        self._slot_page = np.full(self.capacity, -1, np.int64)
        self._clock = 0
        self._slot_used = np.zeros(self.capacity, np.int64)  # last-touch tick
        self._px = px
        self.pages_loaded = 0
        self.pages_evicted = 0

        def up(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

        st = STORE * STORE
        self.pool = DemandTexturePool(
            *(torch.zeros((self.capacity, st), dtype=torch.float32, device=self.device)
              for _ in range(3)),
            page_table=up(self._page_table), page_offset=up(offs), pages_x=up(px),
            width=up(w), height=up(h), levels=up(n_levels),
            fallback=up(np.stack(fb).astype(np.float32)),
        )

    def _read_level_block(self, t: int, level: int, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
        """Level-l texels at integer grids: an exact 2^l x 2^l box filter
        over the source's base level (wrap addressing), so mips are defined
        for any ImageSource, procedural included."""
        src = self.sources[t]
        if level == 0:
            return src.read_texel_block(xs, ys)
        k = 1 << level
        xf = (xs[:, None] * k + np.arange(k)[None, :]).reshape(-1)
        yf = (ys[:, None] * k + np.arange(k)[None, :]).reshape(-1)
        block = src.read_texel_block(xf, yf)  # (len(ys)*k, len(xs)*k, 3)
        return block.reshape(len(ys), k, len(xs), k, 3).mean((1, 3))

    def _read_tile(self, page: int) -> np.ndarray:
        """(STORE*STORE, 3) texels of one page: its payload plus the
        one-texel wrapped gutter."""
        t = int(self._page_tex[page])
        level = int(self._page_lvl[page])
        ty, tx = divmod(int(self._page_local[page]), int(self._px[t, level]))
        xs = np.arange(tx * TILE - 1, tx * TILE + TILE + 1, dtype=np.int64)
        ys = np.arange(ty * TILE - 1, ty * TILE + TILE + 1, dtype=np.int64)
        return self._read_level_block(t, level, xs, ys).reshape(-1, 3)

    def process_requests(self, requests) -> int:
        """Service one launch's usage bitmap (bool, numpy or a tensor):
        refresh the eviction tick of every touched resident page, load the
        non-resident ones (lowest page ids first, at most `capacity`) into
        free slots, then the least recently used. Returns pages loaded."""
        if isinstance(requests, torch.Tensor):
            requests = requests.cpu().numpy()
        pages = np.nonzero(np.asarray(requests))[0]
        if len(pages) == 0:
            return 0
        self._clock += 1
        is_resident = self._page_table[pages] >= 0
        self._slot_used[self._page_table[pages[is_resident]]] = self._clock
        pages = pages[~is_resident]
        if len(pages) == 0:
            return 0
        n_load = min(len(pages), self.capacity)
        pages = pages[:n_load]
        slots = np.argsort(self._slot_used, kind="stable")[:n_load]
        rows = np.empty((n_load, STORE * STORE, 3), np.float32)
        for i, (page, slot) in enumerate(zip(pages, slots)):
            old = self._slot_page[slot]
            if old >= 0:
                self._page_table[old] = -1
                self.pages_evicted += 1
            rows[i] = self._read_tile(int(page))
            self._slot_page[slot] = page
            self._slot_used[slot] = self._clock
            self._page_table[page] = slot
            self.pages_loaded += 1
        sl = torch.as_tensor(slots, device=self.device)
        dev_rows = torch.as_tensor(rows, device=self.device)
        for k, tile in enumerate((self.pool.tile_r, self.pool.tile_g, self.pool.tile_b)):
            tile.index_copy_(0, sl, dev_rows[..., k])
        self.pool.page_table.copy_(torch.as_tensor(self._page_table))
        return int(n_load)

    def resident_fraction(self) -> float:
        return float((self._page_table >= 0).mean())

    @classmethod
    def from_host_scene(cls, hs, capacity: int = 256, levels: int = 1,
                        device="cuda") -> "DemandTextureManager":
        """Wrap a HostScene's textures (in texture-id order) so
        material.texture_id indexes this manager directly: pass the result
        as `Renderer(demand=...)` to shade from the sparse pool instead of
        the resident TexturePool."""
        return cls([ArraySource(t) for t in hs.textures], capacity=capacity, levels=levels,
                   device=device)

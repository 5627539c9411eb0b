"""Writers of the JPEG 2000 files the codec tests and fixtures need beyond
what PIL's `save(..., "JPEG2000")` writes: OpenJPEG's own encoder (the
libopenjp2 that PIL ships) driven through ctypes for the code-block
styles, POC, SOP / EPH, tile-parts, ROI, other precisions and subsampled
components; JP2 boxes spliced around a codestream (colr sYCC / CMYK / ICC,
pclr + cmap, cdef, res); and a codestream's packet headers moved into PPT
or PPM marker segments, found with the port's tier 2 (packet boundaries
only; PIL's decode of the result is the oracle). Only the tests and
tests/torch_fixtures/make_textures.py import this, on a machine with PIL."""
from __future__ import annotations

import ctypes
import glob
import os
import struct
import tempfile

import numpy as np

_I, _U = ctypes.c_int, ctypes.c_uint32
_PATH = 4096


class _Poc(ctypes.Structure):
    _fields_ = [(n, _U) for n in ("resno0", "compno0", "layno1", "resno1", "compno1", "layno0", "precno0",
                                  "precno1")] + [
        ("prg1", _I), ("prg", _I), ("progorder", ctypes.c_char * 5), ("tile", _U)] + [
        (n, ctypes.c_int32) for n in ("tx0", "tx1", "ty0", "ty1")] + [
        (n, _U) for n in ("layS", "resS", "compS", "prcS", "layE", "resE", "compE", "prcE", "txS", "txE", "tyS", "tyE",
                          "dx", "dy", "lay_t", "res_t", "comp_t", "prc_t", "tx0_t", "ty0_t")]


class _CParams(ctypes.Structure):
    """opj_cparameters_t of OpenJPEG 2.5."""
    _fields_ = [
        ("tile_size_on", _I), ("cp_tx0", _I), ("cp_ty0", _I), ("cp_tdx", _I), ("cp_tdy", _I), ("cp_disto_alloc", _I),
        ("cp_fixed_alloc", _I), ("cp_fixed_quality", _I), ("cp_matrice", ctypes.c_void_p),
        ("cp_comment", ctypes.c_char_p),
        ("csty", _I), ("prog_order", _I), ("POC", _Poc * 32), ("numpocs", _U), ("tcp_numlayers", _I),
        ("tcp_rates", ctypes.c_float * 100), ("tcp_distoratio", ctypes.c_float * 100), ("numresolution", _I),
        ("cblockw_init", _I), ("cblockh_init", _I), ("mode", _I), ("irreversible", _I), ("roi_compno", _I),
        ("roi_shift", _I), ("res_spec", _I), ("prcw_init", _I * 33), ("prch_init", _I * 33),
        ("infile", ctypes.c_char * _PATH), ("outfile", ctypes.c_char * _PATH), ("index_on", _I),
        ("index", ctypes.c_char * _PATH), ("image_offset_x0", _I), ("image_offset_y0", _I), ("subsampling_dx", _I),
        ("subsampling_dy", _I), ("decod_format", _I), ("cod_format", _I), ("jpwl_epc_on", _I), ("jpwl_hprot_MH", _I),
        ("jpwl_hprot_TPH_tileno", _I * 16), ("jpwl_hprot_TPH", _I * 16), ("jpwl_pprot_tileno", _I * 16),
        ("jpwl_pprot_packno", _I * 16), ("jpwl_pprot", _I * 16), ("jpwl_sens_size", _I), ("jpwl_sens_addr", _I),
        ("jpwl_sens_range", _I), ("jpwl_sens_MH", _I), ("jpwl_sens_TPH_tileno", _I * 16), ("jpwl_sens_TPH", _I * 16),
        ("cp_cinema", _I), ("max_comp_size", _I), ("cp_rsiz", _I), ("tp_on", ctypes.c_char), ("tp_flag", ctypes.c_char),
        ("tcp_mct", ctypes.c_char), ("jpip_on", _I), ("mct_data", ctypes.c_void_p), ("max_cs_size", _I),
        ("rsiz", ctypes.c_uint16)]


class _CmptParm(ctypes.Structure):
    _fields_ = [(n, _U) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd")]


class _Comp(ctypes.Structure):
    _fields_ = [(n, _U) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd", "resno_decoded",
                                  "factor")] + [
        ("data", ctypes.POINTER(ctypes.c_int32)), ("alpha", ctypes.c_uint16)]


class _Image(ctypes.Structure):
    _fields_ = [("x0", _U), ("y0", _U), ("x1", _U), ("y1", _U), ("numcomps", _U), ("color_space", _I),
                ("comps", ctypes.POINTER(_Comp)), ("icc_profile_buf", ctypes.c_void_p), ("icc_profile_len", _U)]


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        import PIL

        libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
        lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libopenjp2-*.so*"))[0])
        lib.opj_image_create.restype = ctypes.POINTER(_Image)
        lib.opj_image_create.argtypes = [_U, ctypes.POINTER(_CmptParm), _I]
        lib.opj_create_compress.restype = ctypes.c_void_p
        lib.opj_create_compress.argtypes = [_I]
        lib.opj_setup_encoder.argtypes = [ctypes.c_void_p, ctypes.POINTER(_CParams), ctypes.POINTER(_Image)]
        lib.opj_stream_create_default_file_stream.restype = ctypes.c_void_p
        lib.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p, _I]
        lib.opj_end_compress.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.opj_start_compress.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Image), ctypes.c_void_p]
        lib.opj_encode.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.opj_stream_destroy.argtypes = [ctypes.c_void_p]
        lib.opj_destroy_codec.argtypes = [ctypes.c_void_p]
        lib.opj_image_destroy.argtypes = [ctypes.POINTER(_Image)]
        _LIB = lib
    return _LIB


def opj_encode(planes: list, prec=8, sgnd=False, dxy=None, offset=(0, 0), jp2: bool = False, color_space: int = 1,
               pocs=None, rates=(0,), **params) -> bytes:
    """A codestream (or, jp2=True, a JP2 file) of the component planes by
    OpenJPEG's encoder: each plane at its subsampled size, `dxy` the
    (XRsiz, YRsiz) of each, `offset` the image offset; `pocs` as
    (RSpoc, CSpoc, LYEpoc, REpoc, CEpoc, Ppoc); `rates` one compression
    ratio a layer (0: lossless); the rest set opj_cparameters_t fields
    (mode, csty, irreversible, numresolution, cblockw_init, tp_on, ...)."""
    lib = _lib()
    n = len(planes)
    dxy = dxy or [(1, 1)] * n
    parms = (_CmptParm * n)()
    for i, (pl, (dx, dy)) in enumerate(zip(planes, dxy)):
        h, w = pl.shape
        c = parms[i]
        c.dx, c.dy, c.w, c.h = dx, dy, w, h
        c.x0, c.y0 = -(-offset[0] // dx), -(-offset[1] // dy)
        c.prec = prec[i] if isinstance(prec, (list, tuple)) else prec
        c.sgnd = int(sgnd[i] if isinstance(sgnd, (list, tuple)) else sgnd)
    img = lib.opj_image_create(n, parms, color_space)
    h0, w0 = planes[0].shape
    img.contents.x0, img.contents.y0 = offset
    img.contents.x1 = offset[0] + (w0 - 1) * dxy[0][0] + 1
    img.contents.y1 = offset[1] + (h0 - 1) * dxy[0][1] + 1
    for i, pl in enumerate(planes):
        flat = np.ascontiguousarray(pl, np.int32).ravel()
        ctypes.memmove(img.contents.comps[i].data, flat.ctypes.data, flat.nbytes)
    p = _CParams()
    lib.opj_set_default_encoder_parameters(ctypes.byref(p))
    p.tcp_numlayers = len(rates)
    p.cp_disto_alloc = 1
    for j, r in enumerate(rates):
        p.tcp_rates[j] = r
    for k, v in params.items():
        if k in ("prcw_init", "prch_init"):
            for j, x in enumerate(v):
                getattr(p, k)[j] = x
            p.csty |= 1
            p.res_spec = len(v)
        elif k in ("tp_on", "tp_flag", "tcp_mct"):
            setattr(p, k, bytes([v]) if isinstance(v, int) else v)
        else:
            setattr(p, k, v)
    for j, (r0, c0, l1, r1, c1, prg) in enumerate(pocs or ()):
        q = p.POC[j]
        q.resno0, q.compno0, q.layno1, q.resno1, q.compno1, q.prg1, q.tile = r0, c0, l1, r1, c1, prg, 1
    p.numpocs = len(pocs or ())
    codec = lib.opj_create_compress(2 if jp2 else 0)
    fd, path = tempfile.mkstemp(suffix=".jp2" if jp2 else ".j2k")
    os.close(fd)
    try:
        if not lib.opj_setup_encoder(codec, ctypes.byref(p), img):
            raise ValueError("opj_setup_encoder refused the parameters")
        st = lib.opj_stream_create_default_file_stream(path.encode(), 0)
        ok = lib.opj_start_compress(codec, img, st) and lib.opj_encode(codec, st) and lib.opj_end_compress(codec, st)
        lib.opj_stream_destroy(st)
        if not ok:
            raise ValueError("OpenJPEG's encoder failed")
        with open(path, "rb") as f:
            return f.read()
    finally:
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(img)
        os.remove(path)


def planes(h: int, w: int, n: int, seed: int, prec: int = 8, sgnd: bool = False) -> list:
    """n smooth-ish planes with noise, values in the precision's range."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    out = []
    for i in range(n):
        v = (x * (3 + i) + y * (5 - i) + (x * y) // 7) % (1 << prec) + rng.integers(-3, 4, (h, w))
        v = np.clip(v, 0, (1 << prec) - 1)
        out.append(v - (1 << (prec - 1)) if sgnd else v)
    return out


def box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def jp2_file(codestream: bytes, height: int, width: int, nc: int, bpc: int, colr: bytes | None = None,
             extra: bytes = b"", brand: bytes = b"jp2 ") -> bytes:
    """A JP2 file around a codestream: the signature, ftyp, jp2h (ihdr, the
    colr box given, then `extra` boxes), jp2c."""
    ihdr = box(b"ihdr", struct.pack(">IIHBBBB", height, width, nc, bpc, 7, 0, 0))
    return (box(b"jP  ", b"\x0d\x0a\x87\x0a") + box(b"ftyp", brand + bytes(4) + brand)
            + box(b"jp2h", ihdr + (colr or b"") + extra) + box(b"jp2c", codestream))


def colr(enumcs: int) -> bytes:
    return box(b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs))


def colr_icc(profile: bytes) -> bytes:
    return box(b"colr", bytes([2, 0, 0]) + profile)


def pclr(colours: np.ndarray) -> bytes:
    """A palette of 8-bit columns and the cmap that maps component 0 onto it."""
    ne, npc = colours.shape
    body = struct.pack(">HB", ne, npc) + bytes([7] * npc) + np.asarray(colours, np.uint8).tobytes()
    cmap = b"".join(struct.pack(">HBB", 0, 1, k) for k in range(npc))
    return box(b"pclr", body) + box(b"cmap", cmap)


def cdef(entries: list) -> bytes:
    return box(b"cdef", struct.pack(">H", len(entries)) + b"".join(struct.pack(">HHH", *e) for e in entries))


def _tile_parts(cs: bytes):
    """(main header, [(SOT..SOD header bytes, tile-part body)]) of a
    codestream whose tile-parts give their lengths."""
    pos = 2
    while cs[pos:pos + 2] != b"\xff\x90":  # the main header's segments
        pos += 2 + int.from_bytes(cs[pos + 2:pos + 4], "big")
    main, parts = cs[:pos], []
    while cs[pos:pos + 2] == b"\xff\x90":
        psot = int.from_bytes(cs[pos + 6:pos + 10], "big")
        sod = cs.index(b"\xff\x93", pos) + 2
        parts.append((cs[pos:sod], cs[sod:pos + psot]))
        pos += psot
    return main, parts


def _split_packets(cs: bytes) -> list:
    """For each tile-part (one a tile), its packets' (header bytes, body
    bytes with any SOP), by the port's tier 2."""
    from optixpathtracer_tpu_torch.io.codecs import j2k, j2k_t2

    stream = j2k.Codestream(cs)
    out = {}
    for index in stream.order:
        tile = stream.tiles[index]
        assert len(tile.parts) == 1, "one tile-part a tile"
        cod, codings = stream.coding(tile)
        box_ = stream.tile_box(index)
        tcs = [j2k.TileComp(box_, comp, k) for comp, k in zip(stream.comps, codings)]
        data = tile.parts[0]
        spans, pos = [], 0
        for lay, resno, compno, precno in j2k_t2.packet_order(tcs, box_, cod["layers"], cod["prg"],
                                                             tile.pocs or stream.pocs):
            pos = j2k_t2.read_packet(data, pos, len(data), None, tcs[compno], resno, precno, lay,
                                     codings[compno].cblksty, bool(cod["csty"] & 2), bool(cod["csty"] & 4), spans)
        out[index] = [(data[h0:h1], data[s:h0] + data[h1:e]) for s, h0, h1, e in spans]
    return out


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def to_ppt(cs: bytes, chunk: int = 1000) -> bytes:
    """The codestream with each tile's packet headers moved into PPT marker
    segments of its tile-part header (`chunk` bytes of headers each)."""
    main, parts = _tile_parts(cs)
    packets = _split_packets(cs)
    out = main
    for head, _body in parts:
        index = int.from_bytes(head[4:6], "big")
        headers = b"".join(h for h, _ in packets[index])
        bodies = b"".join(b for _, b in packets[index])
        ppt = b"".join(_segment(0xFF61, bytes([z]) + headers[i:i + chunk])
                       for z, i in enumerate(range(0, max(len(headers), 1), chunk)))
        rest = head[12:-2] + ppt + b"\xff\x93"
        out += head[:6] + struct.pack(">I", 12 + len(rest) + len(bodies)) + head[10:12] + rest + bodies
    return out + b"\xff\xd9"


def to_ppm(cs: bytes, chunk: int = 1000) -> bytes:
    """The codestream with every tile-part's packet headers in PPM marker
    segments of the main header (Nppm, then the headers, a tile-part at a
    time, split over segments of at most `chunk` bytes)."""
    main, parts = _tile_parts(cs)
    packets = _split_packets(cs)
    stream, rebuilt = b"", b""
    for head, _body in parts:
        index = int.from_bytes(head[4:6], "big")
        headers = b"".join(h for h, _ in packets[index])
        bodies = b"".join(b for _, b in packets[index])
        stream += struct.pack(">I", len(headers)) + headers
        rest = head[12:]
        rebuilt += head[:6] + struct.pack(">I", 12 + len(rest) + len(bodies)) + head[10:12] + rest + bodies
    ppm = b"".join(_segment(0xFF60, bytes([z]) + stream[i:i + chunk])
                   for z, i in enumerate(range(0, len(stream), chunk)))
    return main + ppm + rebuilt + b"\xff\xd9"

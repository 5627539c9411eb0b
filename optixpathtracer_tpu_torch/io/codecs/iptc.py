"""IPTC/NAA image records, as PIL's IptcImagePlugin reads them: the
dataset fields (0x1C, record, dataset, a 16-bit or extended size) up to
the first 8:10 field; the layers and component flag of 3:60, the size of
3:20 / 3:30, compression 1 (raw 8-bit rows) or 5 (a JPEG) of 3:120; every
8:10 field's data joined. One layer without components is grey; three or
four layers with components put the data in the band 3:65 names of an
RGB or CMYK image whose other bands are zero."""
from __future__ import annotations

import numpy as np

from ._common import DecodeError, NotThisFormat, cmyk_rgb, grey_rgb, raw_rows


def _field(data: bytes, pos: int):
    """-> ((record, dataset) or None, size, the position after the header)."""
    s = data[pos:pos + 5]
    if not s.strip(b"\0"):
        return None, 0, pos + len(s)
    if len(s) < 5 or s[0] != 0x1C or s[1] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
        raise NotThisFormat("invalid IPTC/NAA file")
    size, pos = s[3], pos + 5
    if size > 132:
        raise DecodeError("illegal field length in IPTC/NAA file")
    if size == 128:
        size = 0
    elif size > 128:
        size, pos = int.from_bytes(data[pos:pos + size - 128][-4:], "big"), pos + size - 128
    else:
        size = int.from_bytes(s[3:5], "big")
    return (s[1], s[2]), size, pos


def _int(v) -> int:
    if isinstance(v, list) or v is None:
        raise DecodeError("bad IPTC field")
    return int.from_bytes(v[-4:], "big")


def rgb8(data: bytes) -> np.ndarray:
    info: dict = {}
    pos = 0
    while True:
        start = pos
        tag, size, pos = _field(data, pos)
        if not tag or tag == (8, 10):
            break
        value = data[pos:pos + size] if size else None
        pos += size
        if tag in info:
            info[tag] = (info[tag] if isinstance(info[tag], list) else [info[tag]]) + [value]
        else:
            info[tag] = value
    try:
        layers, component = info[(3, 60)][0], info[(3, 60)][1]
        width, height = _int(info[(3, 20)]), _int(info[(3, 30)])
        compression = _int(info[(3, 120)])
    except (KeyError, IndexError, TypeError) as e:
        raise DecodeError(f"IPTC record without its image fields: {e!r}") from e
    if layers == 1 and not component:
        bands, band = 1, None
    elif layers in (3, 4) and component:
        bands = layers
        band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
    else:
        raise DecodeError("IPTC image of no mode PIL reads")
    if compression not in (1, 5):
        raise DecodeError("Unknown IPTC image compression")
    if tag != (8, 10):
        raise DecodeError("IPTC record without image data")
    body = bytearray()
    pos = start
    while True:
        tag, size, pos = _field(data, pos)
        if tag != (8, 10):
            break
        body += data[pos:pos + size]
        pos += size
    if compression == 1:
        img = raw_rows(bytes(body), 0, height, width, what="IPTC")[..., None]
    else:
        from ..image import decode_jpeg

        img = decode_jpeg(bytes(body))
    if band is None:
        if img.shape[-1] == 3:
            return np.ascontiguousarray(img)
        if img.shape[-1] != 1:
            raise DecodeError("IPTC grey image of a CMYK JPEG")
        return grey_rgb(img[..., 0])
    if img.shape[-1] != 1 or not 0 <= band < bands:
        raise DecodeError("IPTC band image that is not grey")
    px = np.zeros(img.shape[:2] + (bands,), np.uint8)
    px[..., band] = img[..., 0]
    return px if bands == 3 else cmyk_rgb(px)

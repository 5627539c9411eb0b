"""Lossless JPEG (SOF3, Huffman-coded, 8-bit), as libjpeg-turbo decodes it
(jdlhuff.c, jdlossls.c, jddiffct.c).

Each sample's difference is a Huffman category (16 reads 32768 with no
extra bits) and its bits; predictors 1-7 (T.81 Table H.1) with the first
row predicted from the left and its first sample from
2^(precision - Pt - 1), each later row's first sample from above, a restart
making the next row a first row again; samples are mod 2^16, shifted left
by the point transform and kept to their low 8 bits. The entropy decoding
is a host loop; predictors 1-5 are cumulative sums along each row."""
from __future__ import annotations

import numpy as np

from ._common import DecodeError


def decode_scan(frame, comps, dc_luts, pred, pt, segs, restart, bit_windows, receive):
    """One lossless scan -> each scan component's (rows, cols) int64 samples
    in frame.samples. dc_luts: each component's 16-bit-peek Huffman table
    (io/image.py's `_huffman_lut`)."""
    if not 1 <= pred <= 7:
        raise DecodeError(f"lossless JPEG predictor {pred}")
    if len(comps) == 1:
        c = comps[0]
        grid = [(frame.cw[c], frame.ch[c], 1, 1)]
        mcus_x, mcus_y = frame.cw[c], frame.ch[c]
    else:
        mcus_x, mcus_y = frame.mcus_x, frame.mcus_y
        grid = [(mcus_x * frame.h[c], mcus_y * frame.v[c], frame.h[c], frame.v[c]) for c in comps]
    diffs = [np.zeros((gh, gw), np.int64) for gw, gh, _, _ in grid]
    per = restart or mcus_x * mcus_y
    if restart and restart % mcus_x:
        raise DecodeError("lossless JPEG restart interval not a whole number of rows")
    n_mcus = mcus_x * mcus_y
    bad = "corrupt JPEG data: invalid Huffman code"
    for seg_i in range(-(-n_mcus // per)):
        win = bit_windows(segs[seg_i] if seg_i < len(segs) else b"")
        pos = 0
        for m in range(seg_i * per, min(n_mcus, (seg_i + 1) * per)):
            my, mx = divmod(m, mcus_x)
            for ci, (_, _, h, v) in enumerate(grid):
                lut = dc_luts[ci]
                out = diffs[ci]
                for y in range(v):
                    for x in range(h):
                        e = lut[(win[pos >> 3] >> (48 - (pos & 7))) & 0xFFFF]
                        if not e:
                            raise DecodeError(bad)
                        pos += e >> 8
                        s = e & 0xFF
                        if s == 16:
                            d = 32768
                        elif s:
                            d, pos = receive(win, pos, s)
                        else:
                            d = 0
                        out[my * v + y, mx * h + x] = d
    rows_per_restart = (per // mcus_x) if restart else None
    for ci, c in enumerate(comps):
        v = grid[ci][3]
        d = diffs[ci][:frame.ch[c], :frame.cw[c]]
        first_rows = set(range(0, d.shape[0], rows_per_restart * v)) if restart else {0}
        frame.samples[c] = _undifference(d, pred, pt, first_rows)


def _undifference(d: np.ndarray, pred: int, pt: int, first_rows: set) -> np.ndarray:
    h, w = d.shape
    out = np.zeros((h, w), np.int64)
    init = 1 << (8 - pt - 1)
    for y in range(h):
        row = d[y]
        if y in first_rows:  # predictor 1, the first sample from the initial value
            out[y] = (np.cumsum(row) + init) & 0xFFFF
            continue
        up = out[y - 1]
        first = (row[0] + up[0]) & 0xFFFF
        if pred == 1:
            out[y] = (first + np.cumsum(np.concatenate([[0], row[1:]]))) & 0xFFFF
        elif pred == 2:
            out[y] = (row + up) & 0xFFFF
        elif pred == 3:
            out[y, 0] = first
            out[y, 1:] = (row[1:] + up[:-1]) & 0xFFFF
        elif pred in (4, 5):  # Ra plus a term of the row above: a running sum
            t = up[1:] - up[:-1] if pred == 4 else (up[1:] - up[:-1]) >> 1
            out[y] = (first + np.cumsum(np.concatenate([[0], row[1:] + t]))) & 0xFFFF
        else:
            r = out[y]
            r[0] = first
            ra = first
            ul, urow, drow = up.tolist(), r, row.tolist()
            for x in range(1, w):
                if pred == 6:
                    p = ul[x] + ((ra - ul[x - 1]) >> 1)
                else:
                    p = (ra + ul[x]) >> 1
                ra = (drow[x] + p) & 0xFFFF
                urow[x] = ra
    return (out << pt) & 0xFF

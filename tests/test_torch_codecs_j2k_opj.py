"""Port parity, the JPEG 2000 variants PIL reads and does not write, made
with OpenJPEG's own encoder (tests/torch_j2k_encoders.py), against PIL's
`convert("RGB")`, bit for bit.

Each code-block style bit (BYPASS, RESET, TERMALL, VSC, predictable
termination, SEGSYM) and their mixes on both transforms; SOP / EPH;
tile-parts split by resolution, component and layer; POC; ROI max-shift;
precisions 1-16, signed and unsigned; subsampled components, with PIL's
sYCC guess on raw codestreams and its refusal of subsampled grey.
"""
import pytest

from torch_codec_encoders import assert_as_pil, assert_fails_like_pil, assert_like_pil, pil_rgb
from torch_j2k_encoders import colr, jp2_file, opj_encode, planes

STYLES = {"bypass": 1, "reset": 2, "termall": 4, "vsc": 8, "pterm": 16, "segsym": 32, "all": 63,
          "bypass_termall": 5, "bypass_vsc": 9, "reset_vsc": 10}


@pytest.mark.parametrize("irreversible", [0, 1])
@pytest.mark.parametrize("style", list(STYLES))
def test_code_block_styles(style, irreversible):
    p = planes(37, 45, 3, STYLES[style])
    assert_like_pil(opj_encode(p, mode=STYLES[style], irreversible=irreversible, cblockw_init=16, cblockh_init=16,
                               rates=(20, 8, 1), numresolution=4))
    assert_like_pil(opj_encode(p, mode=STYLES[style], irreversible=irreversible, cblockw_init=8, cblockh_init=32,
                               rates=(30, 10), numresolution=3, jp2=True))


@pytest.mark.parametrize("csty", [2, 4, 6])
def test_sop_eph(csty):
    p = planes(37, 45, 3, csty)
    assert_like_pil(opj_encode(p, csty=csty, rates=(10, 1), numresolution=4))
    assert_like_pil(opj_encode(p, csty=csty, irreversible=1, tile_size_on=1, cp_tdx=16, cp_tdy=24, numresolution=3))


@pytest.mark.parametrize("flag", "RCL")
def test_tile_parts(flag):
    p = planes(37, 45, 3, ord(flag))
    assert_like_pil(opj_encode(p, tp_on=1, tp_flag=ord(flag), rates=(20, 5, 1), numresolution=4))
    assert_like_pil(opj_encode(p, tp_on=1, tp_flag=ord(flag), tile_size_on=1, cp_tdx=32, cp_tdy=16,
                               numresolution=3, prog_order=2, csty=6))


def test_poc():
    """Progression order changes: each entry's packets in its order, those
    an earlier entry sent skipped, a tile's and the main header's."""
    p = planes(37, 45, 3, 40)
    assert_like_pil(opj_encode(p, numresolution=4, rates=(10, 1),
                               pocs=[(0, 0, 1, 2, 3, 0), (2, 0, 2, 4, 2, 2), (0, 2, 2, 4, 3, 4)]))
    assert_like_pil(opj_encode(p, numresolution=4, rates=(20, 10, 1), tile_size_on=1, cp_tdx=24, cp_tdy=24,
                               irreversible=1, pocs=[(1, 1, 2, 4, 3, 1), (0, 0, 3, 4, 3, 3)]))


@pytest.mark.parametrize("irreversible", [0, 1])
def test_roi(irreversible):
    p = planes(37, 45, 3, 41)
    for comp, shift in ((0, 4), (1, 7), (2, 1)):
        assert_like_pil(opj_encode(p, roi_compno=comp, roi_shift=shift, rates=(15, 1), irreversible=irreversible,
                                   numresolution=3))


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("prec", [1, 2, 4, 5, 7, 9, 12, 15, 16])
def test_precisions(prec, signed):
    """PIL shifts each sample to 8 bits (16 for I;16) after offsetting
    signed ones, keeping the low bits."""
    assert_like_pil(opj_encode(planes(21, 19, 1, prec, prec, signed), prec=prec, sgnd=signed, numresolution=4))
    assert_like_pil(opj_encode(planes(21, 19, 3, prec + 50, prec, signed), prec=prec, sgnd=signed,
                               irreversible=int(prec > 4), numresolution=4))


SUBSAMPLED = {  # (XRsiz, YRsiz) of each component
    "chroma_420": [(1, 1), (2, 2), (2, 2)], "only_second": [(1, 1), (2, 2), (1, 1)],
    "only_third": [(1, 1), (1, 1), (2, 1)], "first": [(2, 2), (1, 1), (1, 1)],
    "first_two": [(2, 2), (2, 2), (1, 1)], "alpha": [(1, 1), (1, 1), (1, 1), (2, 2)],
    "rgba_chroma": [(1, 1), (2, 1), (2, 1), (1, 1)], "grey_alpha": [(1, 1), (2, 2)], "grey": [(2, 2)]}


@pytest.mark.parametrize("case", list(SUBSAMPLED))
@pytest.mark.parametrize("shape", [(20, 22), (21, 23)])
def test_subsampled_components(case, shape):
    """PIL takes a raw codestream whose second or third component is the
    first subsampled as sYCC, reads each component at its subsampled place
    (with its floor-divided strides), and refuses subsampled grey."""
    dxy = SUBSAMPLED[case]
    h, w = shape
    p = [planes(-(-h // dy), -(-w // dx), 1, 60 + i)[0] for i, (dx, dy) in enumerate(dxy)]
    data = opj_encode(p, dxy=dxy, tcp_mct=0, numresolution=3)
    if case.startswith("grey"):
        assert_fails_like_pil(data)
        return
    rh, rw = assert_like_pil(data).shape[:2]
    if len(dxy) == 3:  # an sRGB or sYCC JP2 is taken as it says, subsampled or not
        for enumcs in (16, 18):
            assert_like_pil(jp2_file(data, rh, rw, 3, 7, colr(enumcs)))


def test_precision_above_eight_in_rgb_and_odd_offsets():
    p = planes(13, 31, 3, 70, 10)
    assert_like_pil(opj_encode(p, prec=10, offset=(3, 5), irreversible=1, numresolution=3, prog_order=4,
                               tile_size_on=1, cp_tx0=1, cp_ty0=2, cp_tdx=9, cp_tdy=7))
    assert assert_as_pil(opj_encode(planes(9, 11, 3, 71), offset=(1, 1), numresolution=2))
    assert pil_rgb(opj_encode(planes(9, 11, 3, 72), numresolution=2)).shape == (9, 11, 3)

"""The two twins of JPEG 2000 tier 1 (codecs/j2k_t1.py): the native one
(csrc/host/j2k_t1.cpp, built at first use by utils/host_build) and the
Python reference taken under OPTIX_TPU_NO_NATIVE=1, equal on every
committed JPEG 2000 fixture, code-block for code-block, and on the
OpenJPEG-encoded variants of every code-block style; a failed build raises
and never falls back.
"""
import json
import os

import numpy as np
import pytest

from optixpathtracer_tpu_torch.io import codecs
from optixpathtracer_tpu_torch.io.codecs import j2k_t1
from optixpathtracer_tpu_torch.utils import host_build
from torch_fixtures.make_textures import MANIFEST, OUT
from torch_j2k_encoders import opj_encode, planes

with open(MANIFEST) as f:
    J2K = sorted(n for n in json.load(f) if n.endswith((".j2k", ".jp2")) or n == "loft_tex2_j2k.icns")


def _both(monkeypatch):
    """Every code-block through both twins: their outputs compared."""
    blocks = []

    def both(*args):
        native, ref = j2k_t1.decode_cblk_native(*args), j2k_t1.decode_cblk_py(*args)
        blocks.append(bool(np.array_equal(native, ref)))
        return native

    monkeypatch.setattr(j2k_t1, "decode_cblk", both)
    return blocks


def test_fixtures_are_covered():
    assert len(J2K) >= 29


@pytest.mark.parametrize("name", J2K)
def test_twins_equal_on_fixture(name, monkeypatch):
    with open(os.path.join(OUT, name), "rb") as f:
        data = f.read()
    blocks = _both(monkeypatch)
    codecs.rgb8(data)
    assert blocks and all(blocks)


@pytest.mark.parametrize("mode", [0, 1, 2, 4, 8, 16, 32, 63, 5, 9, 10])
def test_twins_equal_on_code_block_styles(mode, monkeypatch):
    blocks = _both(monkeypatch)
    p = planes(19, 23, 3, mode)
    for irreversible in (0, 1):
        codecs.rgb8(opj_encode(p, mode=mode, irreversible=irreversible, cblockw_init=8, cblockh_init=8,
                               rates=(20, 8, 1), numresolution=3))
    codecs.rgb8(opj_encode(p, mode=mode, roi_compno=0, roi_shift=4, numresolution=3))
    assert blocks and all(blocks)


def test_no_native_takes_the_reference(monkeypatch):
    calls = []
    monkeypatch.setattr(j2k_t1, "decode_cblk_py", lambda *a: calls.append(1) or j2k_t1.decode_cblk_native(*a))
    monkeypatch.setenv("OPTIX_TPU_NO_NATIVE", "1")
    with open(os.path.join(OUT, "j2k_poc.j2k"), "rb") as f:
        codecs.rgb8(f.read())
    assert calls


def test_failed_build_raises(monkeypatch, tmp_path):
    """A missing compiler raises (no silent Python fallback), as for the
    port's other host libraries."""
    monkeypatch.delenv("OPTIX_TPU_NO_NATIVE", raising=False)
    monkeypatch.setattr(host_build, "_libs", {})
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(j2k_t1, "_SIG", None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        j2k_t1.decode_cblk(b"", [], 4, 4, 0, 1, 0, 0)

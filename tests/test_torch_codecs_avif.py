"""AVIF: the port's host/av1.py, av1_decode.py, av1_msac.py,
av1_transform.py and _av1_tables.py against the JAX package's
utils/ twins on the same bytes, and AVIF through the port's entry points
(imread, the CLI, --psf-file, the server).

Inputs: the committed streams of tests/data/torch_codecs/ (written by
cv2's libavif/libaom with make_fixtures.py avif; the card's machine has
no AVIF encoder) with avif_digests.json, the SHA-256 of cv2.imdecode's
output for each and of libdav1d's planes for the CDEF stream; seeded
range-coder streams, transform coefficients, truncations and byte
flips; where cv2 encodes AVIF, fresh streams too (those skip elsewhere,
so the pass count never rests on them). Tolerance: bitwise everywhere,
and JAX's exception class where JAX raises.

Two deliberate differences from JAX, each held here:
- the CDEF chroma direction: on avif_cdef_uv_420_64x64.avif (a 4:2:0
  stream with cdef_uv_pri_strength 7) the port's planes are libdav1d's
  and JAX's are not;
- 4:2:2: the port raises a ValueError naming the subsampling before the
  tile decode, JAX a numpy broadcast ValueError after it.
"""

import hashlib
import json
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest
import torch

from fft_restoration_tpu.utils import _av1_tables as jtables
from fft_restoration_tpu.utils import av1 as jav1
from fft_restoration_tpu.utils import av1_decode as jdec
from fft_restoration_tpu.utils import av1_msac as jmsac
from fft_restoration_tpu.utils import av1_transform as jtx
from fft_restoration_tpu.utils import formats as jf
from fft_restoration_tpu.utils import imageio as jio
from fft_restoration_tpu_torch import cli
from fft_restoration_tpu_torch.host import _av1_tables as tables
from fft_restoration_tpu_torch.host import av1, av1_decode, av1_msac, av1_transform, formats, imageio

torch.set_num_threads(1)

FIXTURES = Path(__file__).parent / "data" / "torch_codecs"
DIGESTS = json.loads((FIXTURES / "avif_digests.json").read_text())
CDEF = "avif_cdef_uv_420_64x64.avif"
SMALL = sorted(n for n in DIGESTS if n != "avif_q50_640x330.avif")
MATCHING = sorted(n for n in DIGESTS if n != CDEF)


def _blob(name):
    return (FIXTURES / name).read_bytes()


def _digest(arr):
    arr = np.ascontiguousarray(arr)
    return {"shape": list(arr.shape), "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def _as_cv2(img):
    """decode_avif's gray / RGB / RGBA in cv2.imdecode's IMREAD_UNCHANGED
    channel order."""
    return img if img.ndim == 2 else img[..., [2, 1, 0, 3][:img.shape[2]]]


def _outcome(fn, *args):
    try:
        return fn(*args)
    except Exception as e:  # the exception's class is the outcome compared
        return type(e).__name__


def _same(a, b):
    if isinstance(a, str) or isinstance(b, str):
        assert a == b, (a, b)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _frame_parts(mod, blob):
    """(item, sequence header, frame header, tile bytes) of the primary
    item, through `mod`'s parsers."""
    item = mod.parse_avif(blob)
    seq = hdr = tile = None
    for t, p in mod.split_obus(item.data):
        if t == 1:
            seq = mod.parse_sequence_header(p)
        elif t == 6:
            hdr = mod.parse_frame_header(p, seq)
            tile = p[(hdr.header_bitpos + 7) // 8:]
    return item, seq, hdr, tile


def _planes(mod, dec, blob, **kw):
    _, seq, hdr, tile = _frame_parts(mod, blob)
    return dec.decode_frame(seq, hdr, tile, **kw)


# ---------------------------------------------------------------- tables


def test_tables_equal_jax():
    """Every public value of _av1_tables.py (CDF arrays, quantizer
    lookups and matrices, QM_OFFSET) is JAX's, in dtype and shape."""
    names = sorted(n for n in vars(jtables) if not n.startswith("_") and n != "np")
    assert names == sorted(n for n in vars(tables) if not n.startswith("_") and n != "np")
    assert len(names) > 20
    for name in names:
        want, got = getattr(jtables, name), getattr(tables, name)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert got == want, name


# ------------------------------------------------------------ range coder


def _random_cdf(rng, n):
    icdf = np.sort(rng.choice(np.arange(64, 32768 - 64), n - 1, replace=False))[::-1]
    return [int(v) for v in icdf] + [0, int(rng.integers(0, 33))]


@pytest.mark.parametrize("seed", range(4))
def test_msac_symbol_sequences_equal_jax(seed):
    """Seeded random streams read through every Msac entry point in a
    seeded order: the same symbols, the same adapted CDFs and the same
    coder state as JAX's (with CDF adaptation on, and off for seed 3)."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, 600).astype(np.uint8).tobytes()
    update = seed != 3
    ours, theirs = av1_msac.Msac(data, update), jmsac.Msac(data, update)
    for step in range(1500):
        op = int(rng.integers(0, 6))
        if op == 0:
            n = int(rng.integers(2, 17))
            cdf = _random_cdf(rng, n)
            a, b = list(cdf), list(cdf)
            assert ours.symbol(a, n) == theirs.symbol(b, n)
            assert a == b
        elif op == 1:
            cdf = [int(rng.integers(64, 32704)), int(rng.integers(0, 33))]
            a, b = list(cdf), list(cdf)
            assert ours.bool_cdf(a) == theirs.bool_cdf(b)
            assert a == b
        elif op == 2:
            f = int(rng.integers(64, 32704))
            assert ours.bool_prob(f) == theirs.bool_prob(f)
        elif op == 3:
            assert ours.bool_equi() == theirs.bool_equi()
        elif op == 4:
            n = int(rng.integers(1, 9))
            assert ours.literal(n) == theirs.literal(n)
        else:
            assert _outcome(ours.golomb) == _outcome(theirs.golomb)
        assert (ours.dif, ours.rng, ours.cnt, ours.pos) == (
            theirs.dif, theirs.rng, theirs.cnt, theirs.pos), step


# -------------------------------------------------------------- transforms


SIZES = [(w, h) for w in (4, 8, 16, 32, 64) for h in (4, 8, 16, 32, 64)
         if max(w, h) <= 4 * min(w, h)]


@pytest.mark.parametrize("w,h", SIZES)
def test_inverse_transform_2d_equal_jax(w, h):
    """Every transform type at every size the spec codes (a type a size
    does not take raises the same class on both sides), and the lossless
    4x4 Walsh-Hadamard, on seeded coefficients: bitwise JAX's."""
    rng = np.random.default_rng(w * 100 + h)
    coeffs = rng.integers(-600, 601, (h, w)) * (rng.random((h, w)) < 0.4)
    decoded = 0
    for tx_type in range(16):
        got = _outcome(av1_transform.inverse_transform_2d, coeffs, tx_type, w, h, False)
        want = _outcome(jtx.inverse_transform_2d, coeffs, tx_type, w, h, False)
        _same(got, want)
        decoded += not isinstance(got, str)
    assert decoded >= 1
    if (w, h) == (4, 4):
        _same(av1_transform.inverse_transform_2d(coeffs, 0, 4, 4, True),
              jtx.inverse_transform_2d(coeffs, 0, 4, 4, True))


# ----------------------------------------------------------------- headers


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_headers_equal_jax(name):
    """parse_avif's item (payloads and properties), the sequence header
    and the frame header: every field equal to JAX's; probe_avif_size
    too."""
    blob = _blob(name)
    ours, theirs = _frame_parts(av1, blob), _frame_parts(jav1, blob)
    for a, b in zip(ours[:3], theirs[:3]):
        assert asdict(a) == asdict(b)
    assert ours[3] == theirs[3]
    assert [t for t, _ in av1.split_obus(ours[0].data)] == [t for t, _ in jav1.split_obus(theirs[0].data)]
    assert av1.probe_avif_size(blob) == jav1.probe_avif_size(blob) == tuple(
        DIGESTS[name]["cv2"]["shape"][:2])


# ------------------------------------------------------------ tile decode


@pytest.mark.parametrize("deblock,cdef", [(False, False), (True, False), (True, True)],
                         ids=["recon", "deblock", "all"])
@pytest.mark.parametrize("name", SMALL)
def test_decode_frame_planes_equal_jax(name, deblock, cdef):
    """decode_frame's planes, reconstruction alone, + deblocking, + CDEF:
    bitwise JAX's, but the CDEF stream with CDEF on (its chroma planes
    are libdav1d's, test_cdef_chroma_direction_is_dav1d)."""
    blob = _blob(name)
    ours = _planes(av1, av1_decode, blob, apply_deblock=deblock, apply_cdef=cdef)
    theirs = _planes(jav1, jdec, blob, apply_deblock=deblock, apply_cdef=cdef)
    assert len(ours) == len(theirs)
    for k, (a, b) in enumerate(zip(ours, theirs)):
        if name == CDEF and cdef and k:
            assert (a != b).any()
        else:
            _same(a, b)


@pytest.mark.parametrize("name", MATCHING)
def test_decode_avif_equal_jax_and_cv2(name):
    """decode_avif: bitwise JAX's and cv2.imdecode's (its digest), on
    every committed stream but the CDEF one; formats.decode and
    decode_image_bgr the same."""
    blob = _blob(name)
    ours = av1.decode_avif(blob)
    _same(ours, jav1.decode_avif(blob))
    assert _digest(_as_cv2(ours)) == DIGESTS[name]["cv2"]
    _same(formats.decode(blob), ours)
    _same(imageio.decode_image_bgr(blob), jio.decode_image_bgr(blob))


def test_cdef_chroma_direction_is_dav1d():
    """The CDEF stream (4:2:0, cdef_uv_pri_strength 7): the port's planes
    are libdav1d's (its committed digests, and live libdav1d where it
    loads) and its RGB is cv2's; JAX's chroma planes and RGB are not,
    which documents the repair of JAX's 4:2:2 direction remap."""
    blob = _blob(CDEF)
    ours = _planes(av1, av1_decode, blob)
    theirs = _planes(jav1, jdec, blob)
    assert [_digest(p) for p in ours] == DIGESTS[CDEF]["dav1d"]
    assert _digest(theirs[0]) == DIGESTS[CDEF]["dav1d"][0]
    assert all(_digest(p) != d for p, d in zip(theirs[1:], DIGESTS[CDEF]["dav1d"][1:]))
    assert _digest(_as_cv2(av1.decode_avif(blob))) == DIGESTS[CDEF]["cv2"]
    assert _digest(_as_cv2(jav1.decode_avif(blob))) != DIGESTS[CDEF]["cv2"]
    assert [av1_decode._cdef_uv_direction(d, 1, 1) for d in range(8)] == list(range(8))
    assert [av1_decode._cdef_uv_direction(d, 0, 0) for d in range(8)] == list(range(8))
    assert [av1_decode._cdef_uv_direction(d, 1, 0) for d in range(8)] == [7, 0, 2, 4, 5, 6, 6, 6]
    assert [av1_decode._cdef_uv_direction(d, 0, 1) for d in range(8)] == [1, 2, 2, 2, 3, 4, 6, 0]
    oracle = pytest.importorskip("dav1d_oracle")
    try:
        oracle._load()
    except OSError:
        pytest.skip("libdav1d not available")
    ref, layout, _ = oracle.decode_yuv(av1.parse_avif(blob).data, oracle.INLOOP_ALL)
    assert layout == 1
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ refusals and fuzz


def _with_profile_2(blob):
    """The stream with its sequence header's seq_profile 0 -> 2: an 8-bit
    profile-2 stream is 4:2:2 (and no longer reads
    chroma_sample_position)."""
    payload = next(p for t, p in av1.split_obus(av1.parse_avif(blob).data) if t == 1)
    off = blob.find(payload)
    assert off > 0 and payload[0] >> 5 == 0
    out = bytearray(blob)
    out[off] = (out[off] & 0x1F) | (2 << 5)
    return bytes(out)


def test_422_raises_before_the_tile_decode(monkeypatch):
    """A 4:2:2 stream: the port raises a ValueError naming the
    subsampling without decoding a tile; JAX decodes the tiles and fails
    in numpy's broadcast of the half-width chroma (a ValueError too)."""
    blob = _with_profile_2(_blob("avif_q50_96x64.avif"))
    seq = _frame_parts(av1, blob)[1]
    assert (seq.seq_profile, seq.subsampling_x, seq.subsampling_y) == (2, 1, 0)
    with pytest.raises(ValueError, match="could not be broadcast") as want:
        jio.decode_image_bgr(blob)
    assert "(64,96)" in str(want.value) and "(64,48)" in str(want.value)

    def no_tile_decode(*args, **kw):
        raise AssertionError("4:2:2 reached the tile decode")

    monkeypatch.setattr(av1_decode, "decode_frame", no_tile_decode)
    for fn in (av1.decode_avif, formats.decode, imageio.decode_image_bgr):
        with pytest.raises(ValueError, match=r"^AVIF chroma subsampling 1x0 \(4:2:2\) is not supported"):
            fn(blob)


def _heic_like(blob):
    """The stream relabelled as HEIC: the 'heic' brand, an 'hvc1' item,
    an 'hvcC' property and an HEVC parameter-set NAL unit (length
    prefixed) where the AV1 payload was."""
    item = av1.parse_avif(blob)
    out = bytearray(blob.replace(b"ftypavif", b"ftypheic", 1).replace(b"av01", b"hvc1", 1)
                    .replace(b"av1C", b"hvcC", 1))
    nal = b"\x00\x00\x00\x0c\x40\x01\x0c\x01\xff\xff\x01\x60\x00\x00\x03\x00"
    off = blob.find(item.data)
    out[off:off + len(nal)] = nal
    return bytes(out)


def test_heic_brand_raises_jax_error():
    """A HEIC item raises JAX's exception with JAX's message, on every
    entry point."""
    blob = _heic_like(_blob("avif_q50_96x64.avif"))
    assert formats.sniff(blob) == "avif"
    for fn, jfn in ((av1.decode_avif, jav1.decode_avif), (formats.decode, jf.decode),
                    (imageio.decode_image_bgr, jio.decode_image_bgr)):
        with pytest.raises(Exception) as got:
            fn(blob)
        with pytest.raises(Exception) as want:
            jfn(blob)
        assert type(got.value) is type(want.value) and str(got.value) == str(want.value)
        assert isinstance(got.value, ValueError)


def _fuzz_outcome(mod, blob):
    """`mod`'s decode_avif of a mutated stream, or its exception's class
    name; a stream whose headers ask for a frame larger than 128x128 is
    compared on its headers alone (a flipped size would decode for
    minutes)."""
    try:
        _, seq, hdr, _ = _frame_parts(mod, blob)
        if hdr is not None and hdr.width * hdr.height > 128 * 128:
            return ("headers", asdict(seq), asdict(hdr))
        return mod.decode_avif(blob)
    except Exception as e:  # the exception's class is the outcome compared
        return type(e).__name__


@pytest.mark.parametrize("name", ["avif_q50_96x64.avif", "avif_gray_96x64.avif"])
def test_truncation_and_flip_fuzz(name):
    """Eight seeded truncations and twelve seeded byte flips of each
    stream: the port gives JAX's pixels where JAX decodes, and raises
    JAX's class where JAX raises."""
    blob = _blob(name)
    rng = np.random.default_rng(len(name))
    cuts = sorted(int(c) for c in rng.integers(1, len(blob), 8))
    mutants = [blob[:c] for c in cuts]
    for _ in range(12):
        bad = bytearray(blob)
        pos = int(rng.integers(len(bad)))
        bad[pos] ^= int(rng.integers(1, 256))
        mutants.append(bytes(bad))
    for m in mutants:
        got, want = _fuzz_outcome(av1, m), _fuzz_outcome(jav1, m)
        if isinstance(want, tuple):
            assert got == want
        else:
            _same(got, want)


# --------------------------------------------------- fresh cv2 encodes


def _cv2_avif(img, q):
    cv2 = pytest.importorskip("cv2")
    try:
        ok, enc = cv2.imencode(".avif", img, [cv2.IMWRITE_AVIF_QUALITY, q])
    except cv2.error as e:
        pytest.skip(f"cv2 cannot encode AVIF here: {e}")
    if not ok:
        pytest.skip("cv2 cannot encode AVIF here")
    return enc.tobytes(), cv2


@pytest.mark.parametrize("q,shape", [(30, (64, 96)), (75, (64, 96)), (90, (64, 96)),
                                     (100, (40, 56)), (50, (37, 53))])
def test_fresh_cv2_streams_equal_jax(q, shape):
    """Where cv2 encodes AVIF: fresh streams at q 30/75/90/100 and an odd
    size decode bitwise as JAX's and as cv2.imdecode's."""
    img = np.random.default_rng(q).integers(0, 256, (*shape, 3)).astype(np.uint8)
    img = np.clip(img.astype(int) // 3 + np.mgrid[:shape[0], :shape[1]][1][..., None], 0, 255)
    blob, cv2 = _cv2_avif(img.astype(np.uint8), q)
    ours = av1.decode_avif(blob)
    _same(ours, jav1.decode_avif(blob))
    np.testing.assert_array_equal(_as_cv2(ours), cv2.imdecode(np.frombuffer(blob, np.uint8),
                                                              cv2.IMREAD_UNCHANGED))


# ------------------------------------------------------------ entry points


@pytest.mark.parametrize("name", ["avif_q50_96x64.avif", "avif_gray_96x64.avif",
                                  "avif_alpha_96x64.avif"])
def test_imread_equal_jax(name, tmp_path):
    """imread and probe_size of a .avif file: JAX's (gray repeats to
    three channels, alpha is dropped)."""
    path = tmp_path / "x.avif"
    path.write_bytes(_blob(name))
    _same(imageio.imread(str(path)), jio.imread(str(path)))
    assert imageio.imread(str(path)).shape == (64, 96, 3)
    assert imageio.probe_size(str(path)) == jio.probe_size(str(path)) == (64, 96)


def test_cli_restores_an_avif_frame(tmp_path, capsys):
    """The CLI on a .avif frame: exit 0, the oracle's inf tier, and -o
    the pipeline's restore of the decoded frame."""
    from fft_restoration_tpu_torch.models.pipeline import WienerDeblurPipeline

    src = tmp_path / "frame.avif"
    src.write_bytes(_blob("avif_q50_96x64.avif"))
    out = tmp_path / "out.png"
    rc = cli.main([str(src), "9", "30", "--device", "cpu", "--tier", "inf", "-o", str(out)])
    text = capsys.readouterr().out
    assert rc == 0 and "[Success] tier=inf" in text, text
    want = WienerDeblurPipeline("cpu").restore(imageio.imread(str(src)), 9, 30.0)
    np.testing.assert_array_equal(imageio.imread(str(out)), want)


def test_cli_psf_file_avif(tmp_path, capsys):
    """--psf-file k.avif: a gray AVIF kernel loads as JAX's loader loads
    it and the restore exits 0."""
    from fft_restoration_tpu.ops.psf import load_psf_file as j_load_psf_file
    from fft_restoration_tpu_torch.host.psf_file import load_psf_file

    kernel = tmp_path / "k.avif"
    kernel.write_bytes(_blob("avif_gray_96x64.avif"))
    np.testing.assert_array_equal(load_psf_file(str(kernel)), j_load_psf_file(str(kernel)))
    src = tmp_path / "frame.png"  # the kernel is 96 square: the frame pads to 128 x 256
    frame = np.random.default_rng(3).integers(0, 256, (100, 140, 3)).astype(np.uint8)
    imageio.imwrite(str(src), frame)
    rc = cli.main([str(src), "1", "0", "--psf-file", str(kernel), "--device", "cpu"])
    text = capsys.readouterr().out
    assert rc == 0, text


def test_server_restores_an_avif_body():
    """One AVIF request to an in-process server on the CPU: 200, and the
    pixels of the same frame's PNG request."""
    import http.client
    import threading
    from http.server import ThreadingHTTPServer

    from fft_restoration_tpu_torch.serve import RestorationService, build_parser, make_handler

    service = RestorationService(build_parser().parse_args(
        ["--device", "cpu", "--psf-length", "5", "--psf-angle", "30"]))
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()

    def post(body):
        conn = http.client.HTTPConnection(*srv.server_address, timeout=120)
        try:
            conn.request("POST", "/restore", body=body)
            r = conn.getresponse()
            return r.status, r.read()
        finally:
            conn.close()

    try:
        blob = _blob("avif_odd_57x33.avif")
        status, avif_png = post(blob)
        assert status == 200
        status, png_png = post(imageio.encode_png_bgr(imageio.decode_image_bgr(blob)))
        assert status == 200
        np.testing.assert_array_equal(imageio.decode_png_bgr(avif_png),
                                      imageio.decode_png_bgr(png_png))
    finally:
        srv.shutdown()
        srv.server_close()
        service.batcher.shutdown()
        thread.join(timeout=120)


def test_av1_modules_import_nothing_of_jax_torch_or_the_jax_package():
    """The five AV1 modules import neither jax, torch nor the JAX
    package (the acceptance grep, run as a test)."""
    host = Path(av1.__file__).parent
    files = sorted(host.glob("av1*.py")) + [host / "_av1_tables.py"]
    assert len(files) == 5
    res = subprocess.run(["grep", "-nE", r"^\s*(import|from) +(jax|torch|fft_restoration_tpu)([. ]|$)",
                          *map(str, files)], capture_output=True, text=True)
    assert res.returncode == 1 and res.stdout == "", res.stdout
    assert sys.modules.get("fft_restoration_tpu_torch.host.av1") is av1

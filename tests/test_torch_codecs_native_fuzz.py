"""Guarded-output fuzz of the port's three newer native codec libraries
(csrc/host/webp_codec.cpp, gif_codec.cpp, jp2_t1.cpp), the port's twin
of tests/test_native_fuzz.py.

Byte-flipped, truncated and random payloads go straight to each native
entry point (webp_vp8l_decode, webp_alpha_decode, webp_vp8_decode,
gif_lzw_decode, jp2_decode_block), with the size arguments the port's
decoders would pass. Every output buffer sits inside an arena of
sentinel bytes that must come back untouched: no entry point writes
outside its buffer. Each call either refuses (non-zero; -1 for the LZW
decoder) or fills the buffer with exactly the plain lane's result on the
same payload; and where the native lane refuses, the plain lane raises
too (a refusal of a stream the plain lane reads would be a fault the
port's no-fallback contract exposes). Last, two threads decoding at once
through freshly loaded libraries give one thread's bits, and the child
command of tools/native_asan_fuzz.py (which replays this file on ASAN
builds) is checked without running it.
"""

import threading

import numpy as np
import pytest

from fft_restoration_tpu_torch.host import gif, jp2_t1, native, webp
from fft_restoration_tpu_torch.host.native import ptr
from fft_restoration_tpu_torch.host.webp_encode import encode_webp
from fft_restoration_tpu_torch.host.webp_vp8 import decode_vp8

PAD = 64  # sentinel bytes on each side of every output buffer
H, W = 40, 56
N_FLIPS, N_CUTS, N_GARBAGE = 120, 24, 16


class _Guarded:
    """A uint8 arena with PAD sentinel bytes around an output view."""

    def __init__(self, shape, dtype=np.uint8):
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        self.arena = np.full(n + 2 * PAD, 0xA5, np.uint8)
        self.out = self.arena[PAD: PAD + n].view(dtype).reshape(shape)

    def intact(self) -> bool:
        return bool((self.arena[:PAD] == 0xA5).all() and (self.arena[-PAD:] == 0xA5).all())


def _corpus(rng, payload: bytes):
    """(tag, payload): byte flips, truncations, random bytes."""
    blob = bytearray(payload)
    for _ in range(N_FLIPS):
        pos = int(rng.integers(len(blob)))
        old = blob[pos]
        blob[pos] = int(rng.integers(256))
        yield f"flip@{pos}", bytes(blob)
        blob[pos] = old
    for cut in sorted({int(c) for c in np.linspace(0, len(payload) - 1, N_CUTS)}):
        yield f"cut@{cut}", payload[:cut]
    for i in range(N_GARBAGE):
        yield f"garbage#{i}", rng.integers(0, 256, int(rng.integers(1, 2 * len(payload))),
                                           dtype=np.uint8).tobytes()


def _raises(fn, *args) -> bool:
    try:
        fn(*args)
    except (ValueError, IndexError, KeyError, OverflowError):
        return True
    return False


def _chunks(blob):
    out, pos = {}, 12
    while pos + 8 <= len(blob):
        size = int.from_bytes(blob[pos + 4: pos + 8], "little")
        out[blob[pos: pos + 4]] = blob[pos + 8: pos + 8 + size]
        pos += 8 + size + (size & 1)
    return out


def _photo(rng, channels=3):
    y, x = np.mgrid[:H, :W]
    base = 128 + 60 * np.sin(x / 6.0) * np.cos(y / 5.0) + rng.random((H, W)) * 40
    planes = [base, np.roll(base, 5, 1), 255 - base, np.roll(base, 9, 0)][:channels]
    return np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)


def _cv2_webp(img, q):
    cv2 = pytest.importorskip("cv2")
    src = img[..., ::-1] if img.shape[-1] == 3 else img[..., [2, 1, 0, 3]]
    ok, enc = cv2.imencode(".webp", src, [cv2.IMWRITE_WEBP_QUALITY, q])
    assert ok
    return enc.tobytes()


def _vp8l_size(p):
    """(h, w, whether decode_webp would pass them to the native decoder):
    the header's size when it is a small one, else (H, W, False)."""
    if len(p) >= 5 and p[0] == 0x2F:
        bits = int.from_bytes(p[1:5], "little")
        h, w = ((bits >> 14) & 0x3FFF) + 1, (bits & 0x3FFF) + 1
        if h * w <= 4 * H * W:
            return h, w, True
    return H, W, False


def _vp8_size(p):
    """(h, w, whether decode_webp would pass them to the native decoder):
    the header's size when it is a small one, else (H, W, False)."""
    if len(p) >= 10 and p[3:6] == b"\x9d\x01\x2a":
        w, h = (p[6] | (p[7] << 8)) & 0x3FFF, (p[8] | (p[9] << 8)) & 0x3FFF
        if w and h and h * w <= 4 * H * W:
            return h, w, True
    return H, W, False


def test_vp8l_native_fuzz():
    rng = np.random.default_rng(20260830)
    lib = native.load("webp")
    sources = [_chunks(_cv2_webp(_photo(rng), 101))[b"VP8L"],
               _chunks(encode_webp(_photo(rng, 4)))[b"VP8L"]]
    checked = 0
    for payload in sources:
        for tag, bad in _corpus(rng, payload):
            h, w, as_decode_webp = _vp8l_size(bad)
            g = _Guarded((h, w, 4))
            rc = lib.webp_vp8l_decode(bad, len(bad), w, h, ptr(g.out))
            assert g.intact(), f"vp8l {tag}: wrote outside its buffer"
            if rc == 0:
                want = webp._argb_to_rgba(webp._VP8LDecoder(bad).decode())
                np.testing.assert_array_equal(g.out, want, err_msg=f"vp8l {tag}")
                checked += 1
            elif as_decode_webp:
                assert _raises(lambda: webp._VP8LDecoder(bad).decode()), f"vp8l {tag}"
    assert checked > 0


def test_alpha_native_fuzz():
    pil = pytest.importorskip("PIL.Image")
    import io

    rng = np.random.default_rng(20260831)
    lib = native.load("webp")
    buf = io.BytesIO()
    pil.fromarray(_photo(rng, 4), "RGBA").save(buf, "WEBP", quality=70, lossless=False)
    sources = [_chunks(buf.getvalue())[b"ALPH"],
               bytes([2 << 2]) + _photo(rng)[..., 0].tobytes()]  # raw, vertical filter
    checked = 0
    for payload in sources:
        for tag, bad in _corpus(rng, payload):
            g = _Guarded((H, W))
            rc = lib.webp_alpha_decode(bad, len(bad), W, H, ptr(g.out))
            assert g.intact(), f"alpha {tag}: wrote outside its buffer"
            if rc == 0:
                np.testing.assert_array_equal(g.out, webp._decode_alpha(bad, H, W, native=False),
                                              err_msg=f"alpha {tag}")
                checked += 1
            elif bad:
                assert _raises(webp._decode_alpha, bad, H, W, False), f"alpha {tag}"
    assert checked > 0


def test_vp8_native_fuzz():
    rng = np.random.default_rng(20260832)
    lib = native.load("webp")
    payload = _chunks(_cv2_webp(_photo(rng), 75))[b"VP8 "]
    checked = 0
    for tag, bad in _corpus(rng, payload):
        h, w, as_decode_webp = _vp8_size(bad)
        g = _Guarded((h, w, 3))
        rc = lib.webp_vp8_decode(bad, len(bad), ptr(webp._VP8_PROBS), ptr(webp._VP8_BMODE),
                                 w, h, ptr(g.out))
        assert g.intact(), f"vp8 {tag}: wrote outside its buffer"
        if rc == 0:
            np.testing.assert_array_equal(g.out, decode_vp8(bad), err_msg=f"vp8 {tag}")
            checked += 1
        elif as_decode_webp:
            assert _raises(decode_vp8, bad), f"vp8 {tag}"
    assert checked > 0


def test_gif_lzw_native_fuzz():
    rng = np.random.default_rng(20260833)
    lib = native.load("gif")
    idx = rng.integers(0, 256, H * W, dtype=np.uint8)
    payloads = [(gif._lzw_encode(idx, 8), 8), (gif._lzw_encode(idx & 3, 2), 2)]
    for payload, mcs in payloads:
        for tag, bad in _corpus(rng, payload):
            for m in (mcs, 11):
                g = _Guarded((H * W,))
                n = lib.gif_lzw_decode(bad, len(bad), m, ptr(g.out), H * W)
                assert g.intact(), f"gif lzw {tag} mcs={m}: wrote outside its buffer"
                if n >= 0:
                    np.testing.assert_array_equal(g.out[:n], gif._lzw_decode_py(bad, m, H * W))
                else:
                    assert n == -1 and _raises(gif._lzw_decode_py, bad, m, H * W), tag


def test_jp2_t1_native_fuzz():
    """Random codewords with random bit planes, passes and orientation
    family sweep the pass state machine; the plain lane is held equal on
    the smaller blocks (it runs per bit in Python)."""
    rng = np.random.default_rng(20260834)
    lib = native.load("jp2t1")
    fams = ("LL", "HL", "HH")
    for i in range(400):
        data = rng.integers(0, 256, int(rng.integers(1, 400)), dtype=np.uint8).tobytes()
        w, h = (W, H) if i % 4 else (int(rng.integers(1, 17)), int(rng.integers(1, 17)))
        numbps = int(rng.integers(1, 32 if i % 4 else 10))
        npasses = int(rng.integers(1, 3 * numbps))
        fam = int(rng.integers(3))
        g = _Guarded((h, w), np.int32)
        rc = lib.jp2_decode_block(data, len(data), w, h, numbps, npasses, fam, ptr(g.out))
        assert g.intact(), f"jp2 t1 {i}: wrote outside its buffer"
        assert rc == 0
        if i % 4 == 0:
            np.testing.assert_array_equal(
                g.out, jp2_t1.decode_block(data, w, h, numbps, npasses, fams[fam], native=False))
    for bad_args in ((0, 4, 1), (4, 0, 1), (4, 4, 3), (4, 4, -1)):
        w, h, fam = bad_args
        g = _Guarded((16,), np.int32)
        assert lib.jp2_decode_block(b"\x00", 1, w, h, 3, 1, fam, ptr(g.out)) == -1
        assert g.intact()


def _decodes():
    """One sizeable decode through each library, as the server's handler
    threads would run it."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (160, 200, 3), dtype=np.uint8)
    lossless = encode_webp(img)
    gif_blob = gif.encode_gif(img)
    from fft_restoration_tpu_torch.host import jp2, jp2_encode

    jp2_blob = jp2_encode.encode_jp2(img[:48, :64])
    return [lambda: webp.decode_webp(lossless), lambda: gif.decode_gif(gif_blob),
            lambda: jp2.decode_jp2(jp2_blob)]


def test_two_threads_on_freshly_loaded_libraries(monkeypatch):
    """No library keeps state between calls: two threads decoding at
    once, through libraries loaded anew by whichever thread comes first,
    give one thread's bits."""
    decodes = _decodes()
    want = [f() for f in decodes]
    monkeypatch.setattr(native, "_libs", {})
    results, errors = [[], []], []
    start = threading.Barrier(2)

    def run(k):
        try:
            start.wait()
            for _ in range(4):
                results[k].append([f() for f in decodes])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for per_thread in results:
        assert len(per_thread) == 4
        for outs in per_thread:
            for got, w in zip(outs, want):
                np.testing.assert_array_equal(got, w)


def test_asan_replay_child_command(tmp_path, monkeypatch):
    """tools/native_asan_fuzz.py's child, checked without running it: the
    interpreter preloads libasan then libstdc++, and its code points
    host/native.py at ASAN flags and a build root under the temporary
    directory before pytest runs this file (with a stand-in pytest)."""
    import sys
    import types

    from fft_restoration_tpu_torch.tools import native_asan_fuzz as tool

    argv, env = tool.child_command(str(tmp_path), "/gcc/libasan.so", "/gcc/libstdc++.so.6")
    assert argv[:2] == [sys.executable, "-c"] and len(argv) == 3
    assert env["LD_PRELOAD"] == "/gcc/libasan.so /gcc/libstdc++.so.6"
    assert "detect_leaks=0" in env["ASAN_OPTIONS"]
    assert f"log_path={tmp_path / 'asan_report'}" in env["ASAN_OPTIONS"]
    assert str(tool.REPO) in env["PYTHONPATH"].split(":")
    assert tool.CORPUS == (tool.REPO / "tests" / "test_torch_codecs_native_fuzz.py",)
    assert all(p.is_file() for p in tool.CORPUS)
    calls = []
    monkeypatch.setitem(sys.modules, "pytest", types.SimpleNamespace(main=lambda a: calls.append(a) or 0))
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS)
    monkeypatch.setattr(native, "BUILD_ROOT", native.BUILD_ROOT)
    with pytest.raises(SystemExit) as done:
        exec(argv[2], {"__name__": "__main__"})
    assert done.value.code == 0
    assert native.CXX_FLAGS == ("-O1", "-g", "-fPIC", "-shared", "-fsanitize=address")
    assert native.BUILD_ROOT == tmp_path / "native"
    assert calls == [[str(tool.CORPUS[0]), "-q", "-p", "no:cacheprovider", "--noconftest"]]

"""The port's decode pool (``emr2a_tpu_torch/native``, ``data/native_loader``)
against the JAX package's pool, which decodes with libpng and libjpeg-turbo:
byte-identical rows and equal ``ok`` masks on a matrix of small PNGs and
JPEGs, damaged files, resizes and thread counts; ``resize_rgb_reference``
against the pool's resize; and the JAX package's own pool tests
(``tests/test_native_loader.py``) run on the port.

PNGs that PIL does not write (forced filters, Adam7, low bit depths with
tRNS, split IDATs) come from the small numpy + zlib writer here. The
comparisons skip only where the JAX package's pool cannot build.
"""

import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from emr2a_tpu.data import native_loader as jax_loader
from emr2a_tpu_torch.data import native_loader as loader

sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from jax_pool_gate import jax_pool_available  # noqa: E402

needs_jax_pool = pytest.mark.skipif(not jax_pool_available(),
                                    reason="the JAX package's decode pool (libpng, "
                                           "libjpeg) cannot build here")

ADAM7 = [(0, 8, 0, 8), (4, 8, 0, 8), (0, 4, 4, 8), (2, 4, 0, 4), (0, 2, 2, 4),
         (1, 2, 0, 2), (0, 1, 1, 2)]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _pack_row(row: np.ndarray, depth: int) -> bytes:
    if depth == 16:
        return row.astype(">u2").tobytes()
    if depth == 8:
        return row.astype(np.uint8).tobytes()
    per = 8 // depth
    vals = np.zeros(-(-len(row) // per) * per, np.int64)
    vals[:len(row)] = row
    shifts = 8 - depth * (np.arange(per) + 1)
    return (vals.reshape(-1, per) << shifts).sum(1).astype(np.uint8).tobytes()


def _filter(rows: list, bpp: int, pick) -> bytes:
    out = bytearray()
    prev = bytes(len(rows[0]))
    for y, r in enumerate(rows):
        f = pick(y)
        cur = bytearray(len(r))
        for i in range(len(r)):
            a = r[i - bpp] if i >= bpp else 0
            b, c = prev[i], (prev[i - bpp] if i >= bpp else 0)
            if f == 0:
                p = 0
            elif f == 1:
                p = a
            elif f == 2:
                p = b
            elif f == 3:
                p = (a + b) >> 1
            else:
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[i] = (r[i] - p) & 255
        out.append(f)
        out += cur
        prev = r
    return bytes(out)


def write_png(path, arr, color, depth, filt=None, interlace=False, level=6,
              idat_size=None, palette=None, trns=None, seed=0) -> bytes:
    """A PNG of ``arr`` ((h, w, channels) ints in the depth's range) with
    filter ``filt`` on every row (None: cycle through all five, "rand":
    random per row), Adam7 when ``interlace``, IDATs of ``idat_size`` bytes."""
    h, w = arr.shape[:2]
    ch = CHANNELS[color]
    arr = np.asarray(arr).reshape(h, w, ch)
    bpp = max(1, ch * depth // 8)
    rng = np.random.RandomState(seed)

    def pick(passno):
        if filt == "rand":
            return lambda y: int(rng.randint(5))
        if filt is None:
            return lambda y: (y + passno) % 5
        return lambda y: filt

    raw = b""
    passes = ADAM7 if interlace else [(0, 1, 0, 1)]
    for p, (x0, dx, y0, dy) in enumerate(passes):
        sub = arr[y0::dy, x0::dx]
        if sub.shape[0] and sub.shape[1]:
            raw += _filter([_pack_row(r.reshape(-1), depth) for r in sub], bpp, pick(p))
    z = zlib.compress(raw, level)
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        data += _chunk(b"PLTE", bytes(np.asarray(palette, np.uint8)))
    if trns is not None:
        data += _chunk(b"tRNS", bytes(trns))
    step = idat_size or len(z)
    for i in range(0, len(z), step):
        data += _chunk(b"IDAT", z[i:i + step])
    data += _chunk(b"IEND", b"")
    path.write_bytes(data)
    return data


def pattern(h, w, ch, maxv, seed=1):
    """A smooth gradient with noise, every value within 0..maxv."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 7 + y * 3 + 40 * k) for k in range(ch)], -1)
    return (base + rng.randint(0, max(2, (maxv + 1) // 8), (h, w, ch))) % (maxv + 1)


def photo(h, w, seed=2):
    """A smooth RGB image: what a JPEG encoder is made for."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.stack([128 + 100 * np.sin(6 * x + 3 * k) * np.cos(5 * y + k) for k in range(3)], -1)
    return np.clip(img + rng.randn(h, w, 3) * 6, 0, 255).astype(np.uint8)


# ------------------------------------------------------------------ cases

def _png_case(color, depth, trns=False, interlace=False, shape=(13, 17), **kw):
    def make(d):
        h, w = shape
        arr = pattern(h, w, CHANNELS[color], (1 << depth) - 1)
        pal = tr = None
        if color == 3:
            n = 1 << depth
            pal = np.random.RandomState(5).randint(0, 256, 3 * n)
            tr = np.random.RandomState(6).randint(0, 256, n // 2 + 1).astype(np.uint8) if trns else None
        elif trns:
            tr = struct.pack(">H", 1) if color == 0 else struct.pack(">HHH", 1, 2, 3)
        p = d / "case.png"
        write_png(p, arr, color, depth, interlace=interlace, palette=pal, trns=tr, **kw)
        return p
    return make


def _jpeg_case(shape=(64, 96), grey=False, **save):
    def make(d):
        img = photo(*shape)
        p = d / "case.jpg"
        Image.fromarray(img[..., 0] if grey else img).save(p, **save)
        return p
    return make


def _cv2_case(shape, params):
    def make(d):
        import cv2
        p = d / "case.jpg"
        cv2.imwrite(str(p), photo(*shape), [getattr(cv2, k) if isinstance(k, str) else k
                                            for k in params])
        return p
    return make


def _truncated(make, keep=None, cut=None):
    def trunc(d):
        p = make(d)
        data = p.read_bytes()
        p.write_bytes(data[:int(len(data) * keep)] if keep is not None else data[:-cut])
        return p
    return trunc


PNG_CASES = {}
for _color, _depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)),
                        (4, (8, 16)), (6, (8, 16))):
    for _depth in _depths:
        for _trns in ((False, True) if _color in (0, 2, 3) else (False,)):
            PNG_CASES[f"png-c{_color}-d{_depth}{'-trns' if _trns else ''}"] = _png_case(
                _color, _depth, _trns)
for _color, _depth in ((0, 1), (0, 16), (2, 8), (3, 4), (4, 8), (6, 16)):
    PNG_CASES[f"png-adam7-c{_color}-d{_depth}"] = _png_case(_color, _depth, interlace=True,
                                                            shape=(11, 9))
for _shape in ((1, 1), (2, 3), (5, 1), (1, 9), (7, 7)):
    PNG_CASES[f"png-adam7-{_shape[0]}x{_shape[1]}"] = _png_case(0, 8, interlace=True,
                                                                shape=_shape)
for _f in range(5):
    PNG_CASES[f"png-filter{_f}"] = _png_case(2, 8, shape=(20, 23), filt=_f)
for _level in (0, 1, 9):
    PNG_CASES[f"png-level{_level}"] = _png_case(2, 8, shape=(20, 23), filt="rand", level=_level)
for _size in (1, 7, 100):
    PNG_CASES[f"png-idat{_size}"] = _png_case(2, 8, shape=(20, 23), filt="rand", idat_size=_size)
for _mode in ("L", "RGB", "RGBA", "P", "LA", "1", "I;16"):
    def _pil_png(d, mode=_mode):
        p = d / "case.png"
        Image.fromarray(photo(30, 41)).convert(mode).save(p)
        return p
    PNG_CASES[f"png-pil-{_mode}"] = _pil_png

JPEG_CASES = {}
for _q in (75, 95):
    for _ss in (0, 1, 2):
        JPEG_CASES[f"jpeg-q{_q}-s{_ss}"] = _jpeg_case(quality=_q, subsampling=_ss)
for _ss in (0, 1, 2):
    JPEG_CASES[f"jpeg-progressive-s{_ss}"] = _jpeg_case(quality=80, subsampling=_ss,
                                                        progressive=True)
    JPEG_CASES[f"jpeg-77x100-s{_ss}"] = _jpeg_case(shape=(77, 100), quality=85, subsampling=_ss)
JPEG_CASES["jpeg-optimize"] = _jpeg_case(quality=90, optimize=True)
JPEG_CASES["jpeg-progressive-optimize"] = _jpeg_case(quality=90, optimize=True, progressive=True)
JPEG_CASES["jpeg-grey"] = _jpeg_case(grey=True, quality=80)
JPEG_CASES["jpeg-grey-progressive"] = _jpeg_case(grey=True, quality=80, progressive=True)
for _shape in ((8, 2), (15, 3), (33, 1), (4, 4)):
    JPEG_CASES[f"jpeg-narrow-{_shape[0]}x{_shape[1]}"] = _jpeg_case(shape=_shape,
                                                                    subsampling=2)
for _rst in (1, 3, 16):
    JPEG_CASES[f"jpeg-cv2-rst{_rst}"] = _cv2_case(
        (100, 77), ["IMWRITE_JPEG_RST_INTERVAL", _rst, "IMWRITE_JPEG_QUALITY", 85])
    JPEG_CASES[f"jpeg-cv2-rst{_rst}-progressive"] = _cv2_case(
        (100, 77), ["IMWRITE_JPEG_RST_INTERVAL", _rst, "IMWRITE_JPEG_PROGRESSIVE", 1])
for _name in ("411", "440"):
    for _shape in ((100, 77), (9, 2)):
        JPEG_CASES[f"jpeg-cv2-{_name}-{_shape[0]}x{_shape[1]}"] = _cv2_case(
            _shape, ["IMWRITE_JPEG_SAMPLING_FACTOR",
                     f"IMWRITE_JPEG_SAMPLING_FACTOR_{_name}"])


def _cmyk(d):
    p = d / "case.jpg"
    Image.fromarray(photo(32, 32)).convert("CMYK").save(p)
    return p


def _bad_idat_crc(d):
    p = _png_case(2, 8, shape=(20, 23), filt="rand")(d)
    data = bytearray(p.read_bytes())
    data[60] ^= 0x55
    p.write_bytes(bytes(data))
    return p


def _garbage(magic, suffix):
    def make(d):
        p = d / f"case{suffix}"
        p.write_bytes(magic + bytes(np.random.RandomState(7).randint(0, 256, 200)
                                    .astype(np.uint8)))
        return p
    return make


def _not_image(d):
    p = d / "case.png"
    p.write_text("not an image")
    return p


def _missing(d):
    return d / "missing.png"


def _zlib_tail(kind, idat_size):
    """A 20x23 RGB PNG whose zlib stream has a wrong Adler-32 ("adler"),
    junk after its end ("extra") or no Adler-32 ("short"), in IDATs of
    ``idat_size`` bytes: libpng fails or only warns depending on where the
    reader is when it meets the tail."""
    def make(d):
        arr = pattern(20, 23, 3, 255)
        raw = b"".join(b"\x00" + bytes(arr[y].astype(np.uint8).reshape(-1)) for y in range(20))
        z = zlib.compress(raw, 6)
        z = {"adler": z[:-1] + bytes([z[-1] ^ 1]), "extra": z + b"junkjunk",
             "short": z[:-4]}[kind]
        data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", 23, 20, 8, 2, 0, 0, 0))
        step = idat_size or len(z)
        for i in range(0, len(z), step):
            data += _chunk(b"IDAT", z[i:i + step])
        p = d / "case.png"
        p.write_bytes(data + _chunk(b"IEND", b""))
        return p
    return make


FAILURE_CASES = {
    "png-truncated-30": _truncated(_png_case(2, 8, shape=(20, 23), filt="rand"), cut=30),
    "png-truncated-12": _truncated(_png_case(2, 8, shape=(20, 23), filt="rand"), cut=12),
    "png-pil-truncated-30": _truncated(PNG_CASES["png-pil-RGB"], cut=30),
    "jpeg-baseline-half": _truncated(_jpeg_case(shape=(100, 77), quality=75, subsampling=2),
                                     keep=0.5),
    "jpeg-progressive-half": _truncated(_jpeg_case(shape=(100, 77), quality=75, subsampling=2,
                                                   progressive=True), keep=0.5),
    "jpeg-progressive-s0-half": _truncated(_jpeg_case(quality=95, subsampling=0,
                                                      progressive=True), keep=0.5),
    "jpeg-progressive-s1-65pct": _truncated(_jpeg_case(shape=(100, 77), quality=75,
                                                       subsampling=1, progressive=True),
                                            keep=0.65),
    "jpeg-progressive-s2-80pct": _truncated(_jpeg_case(shape=(100, 77), quality=75,
                                                       subsampling=2, progressive=True),
                                            keep=0.8),
    "jpeg-rst-half": _truncated(JPEG_CASES["jpeg-cv2-rst3"], keep=0.5),
    "jpeg-cmyk": _cmyk,
    "png-bad-idat-crc": _bad_idat_crc,
    "png-garbage": _garbage(b"\x89PNG\r\n\x1a\n", ".png"),
    "jpeg-garbage": _garbage(b"\xff\xd8\xff", ".jpg"),
    "not-an-image": _not_image,
    "missing": _missing,
}
for _kind in ("adler", "extra", "short"):
    for _size in (None, 7, 100):
        FAILURE_CASES[f"png-zlib-{_kind}-idat{_size or 'all'}"] = _zlib_tail(_kind, _size)

ALL_CASES = {**PNG_CASES, **JPEG_CASES, **FAILURE_CASES}


def _native_shape(path):
    try:
        with Image.open(path) as im:
            return im.size[1], im.size[0]
    except Exception:
        return 16, 16


# ------------------------------------------------------------------ tests

@needs_jax_pool
@pytest.mark.parametrize("name", sorted(ALL_CASES))
def test_decode_matches_jax_pool(name, tmp_path):
    """Byte-identical rows and equal ok masks: at the file's own size (the
    decoder alone) and at 37x45 (the resize after it)."""
    path = ALL_CASES[name](tmp_path)
    h, w = _native_shape(path)
    for size in ((h, w), (37, 45)):
        want, want_ok = jax_loader.decode_batch([path], *size, n_threads=1)
        got, got_ok = loader.decode_batch([path], *size, n_threads=1)
        assert got.shape == want.shape and got.dtype == np.uint8
        assert got_ok.tolist() == want_ok.tolist(), size
        np.testing.assert_array_equal(got, want, err_msg=str(size))
    if name in FAILURE_CASES and name.startswith(("jpeg-cmyk", "png-truncated-30", "missing",
                                                  "not-an", "png-garbage", "jpeg-garbage",
                                                  "png-bad-idat")):
        assert not got_ok[0] and not got.any()
    if name.endswith("-half") and name.startswith("jpeg"):
        assert got_ok[0]  # libjpeg's "premature end" is a warning


# Arithmetic-coded JPEGs (SOF9 / SOF10) written by libjpeg-turbo 2.1, which
# PIL and cv2 cannot write: an 8x8 sequential 4:2:0, a 16x24 one with a
# restart every MCU row, a 13x17 progressive 4:4:4, a 9x11 grey progressive.
# The port's pool does not decode them (CT slices are PNG or Huffman-coded
# JPEG); libjpeg-turbo does, so the JAX pool's rows differ.
ARITH_JPEGS = {
    "seq-8x8": bytes.fromhex(
        "ffd8ffe000104a46494600010100000100010000ffdb004300100b0c0e0c0a100e0d0e1211101318"
        "281a181616183123251d283a333d3c3933383740485c4e404457453738506d51575f626768673e4d"
        "71797064785c656763ffdb0043011112121815182f1a1a2f63423842636363636363636363636363"
        "6363636363636363636363636363636363636363636363636363636363636363636363636363ffc9"
        "0011080008000803012200021101031101ffcc000a0010100501101105ffda000c03010002110311"
        "003f00fecdb177a0688c1c48ffd9"),
    "seq-420-rst": bytes.fromhex(
        "ffd8ffe000104a46494600010100000100010000ffdb0043000d090a0b0a080d0b0a0b0e0e0d0f13"
        "201513121213271c1e17202e2931302e292d2c333a4a3e333646372c2d405741464c4e525352323e"
        "5a615a50604a51524fffdb0043010e0e0e131113261515264f352d354f4f4f4f4f4f4f4f4f4f4f4f"
        "4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4fffc9"
        "0011080010001803012200021101031101ffcc000a0010100501101105ffdd00040002ffda000c03"
        "010002110311003f00cfc09d9aeab4f7ab54abd889d528d73405565bc2f41486dec2599e961f60a4"
        "1c8df32c142119cabe3b0b1d029557c413dfe8a243ff00c083b7c3340423b34da8ffd9"),
    "prog-444": bytes.fromhex(
        "ffd8ffe000104a46494600010100000100010000ffdb0043000d090a0b0a080d0b0a0b0e0e0d0f13"
        "201513121213271c1e17202e2931302e292d2c333a4a3e333646372c2d405741464c4e525352323e"
        "5a615a50604a51524fffdb0043010e0e0e131113261515264f352d354f4f4f4f4f4f4f4f4f4f4f4f"
        "4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4fffca"
        "001108000d001103011100021101031101ffcc000600100110ffda000c03010002100310000001cd"
        "4675ac43b47d815215e7511bd40dbbffcc00041005ffda000801010001050213533458e0d5bd40ff"
        "cc00041105ffda0008010301013f0185a5ff00682cb72531f47c4c58bfdd40ffcc00041105ffda00"
        "08010201013f0136b5b6ea95febb367926684d5910ff008abdabffcc00041005ffda000801010006"
        "3f02c0ffcc00041005ffda0008010100013f219043cac95bb99c40ffda000c030100020003000000"
        "10f07dc0ffcc00041105ffda0008010301013f10ff007755fb701fb2815320ffcc00041105ffda00"
        "08010201013f10c42e39d62ea090ffcc00041005ffda0008010100013f10c81947cefd7964c2cbd4"
        "f54ce826d0ffd9"),
    "grey-prog": bytes.fromhex(
        "ffd8ffe000104a46494600010100000100010000ffdb0043000d090a0b0a080d0b0a0b0e0e0d0f13"
        "201513121213271c1e17202e2931302e292d2c333a4a3e333646372c2d405741464c4e525352323e"
        "5a615a50604a51524fffca000b080009000b01011100ffcc00040010ffda0008010100000001e0fd"
        "78bcffcc00041005ffda000801010001050284b0ff00253de1cc8d8f80ffcc00041005ffda000801"
        "0100063f029b166360ffcc00041005ffda0008010100013f21625604b031b14cffda000801010000"
        "0010d8ffcc00041005ffda0008010100013f10c31d3abd113983950145865e2580ffd9"),
}


@pytest.mark.parametrize("name", sorted(ARITH_JPEGS))
def test_arithmetic_jpeg_fails(name, tmp_path):
    """An arithmetic-coded file, whole or cut short, fails: ok = 0 and a
    zero row, beside a good file in the same batch."""
    data = ARITH_JPEGS[name]
    good = JPEG_CASES["jpeg-q75-s2"](tmp_path)
    for keep in (len(data), len(data) * 2 // 3):
        path = tmp_path / f"{keep}.jpg"
        path.write_bytes(data[:keep])
        got, ok = loader.decode_batch([path, good], 7, 9)
        assert ok.tolist() == [False, True]
        assert not got[0].any() and got[1].any()


@needs_jax_pool
@pytest.mark.xfail(strict=True, reason="libjpeg-turbo decodes arithmetic-coded JPEGs, the "
                                       "port's pool fails them (ROADMAP Queue 3)")
def test_arithmetic_jpeg_matches_jax_pool(tmp_path):
    path = tmp_path / "arith.jpg"
    path.write_bytes(ARITH_JPEGS["seq-420-rst"])
    want, want_ok = jax_loader.decode_batch([path], 16, 24)
    got, got_ok = loader.decode_batch([path], 16, 24)
    assert got_ok.tolist() == want_ok.tolist()
    np.testing.assert_array_equal(got, want)


RESIZES = {"down-512-224": ((512, 512), (224, 224)), "down-100-37": ((100, 100), (37, 37)),
           "up-64-224": ((64, 64), (224, 224)), "mixed-60x200-100x100": ((60, 200), (100, 100)),
           "identity-48x30": ((48, 30), (48, 30)), "down-odd-77x100-31x45": ((77, 100), (31, 45))}


@pytest.mark.parametrize("name", sorted(RESIZES))
def test_resize_reference_matches_pool(name, tmp_path):
    """``resize_rgb_reference`` on the decoded pixels equals the pool's row;
    the pool equals the JAX pool's where that builds."""
    (h, w), (oh, ow) = RESIZES[name]
    img = np.random.RandomState(h + w).randint(0, 256, (h, w, 3)).astype(np.uint8)
    path = tmp_path / "src.png"
    Image.fromarray(img).save(path)
    got, ok = loader.decode_batch([path], oh, ow)
    assert ok[0]
    np.testing.assert_array_equal(got[0], loader.resize_rgb_reference(img, oh, ow))
    if jax_loader.native_available():
        want, _ = jax_loader.decode_batch([path], oh, ow)
        np.testing.assert_array_equal(got, want)


def test_threads_give_equal_batches(tmp_path):
    """n_threads 1, 8, 0 (one per core) and 64 (more than cores) give the
    same batch, in order, as the JAX pool does; so do four batches decoded
    at once from Python threads, and the pool counter counts all four."""
    from concurrent.futures import ThreadPoolExecutor
    paths = []
    for i, make in enumerate((PNG_CASES["png-c2-d8"], JPEG_CASES["jpeg-q75-s2"],
                              FAILURE_CASES["missing"], PNG_CASES["png-adam7-c0-d1"],
                              JPEG_CASES["jpeg-progressive-s1"])):
        d = tmp_path / str(i)
        d.mkdir()
        paths.append(make(d))
    paths = paths * 14
    base, base_ok = loader.decode_batch(paths, 40, 40, n_threads=1)
    for n in (8, 0, 64):
        got, ok = loader.decode_batch(paths, 40, 40, n_threads=n)
        np.testing.assert_array_equal(got, base)
        np.testing.assert_array_equal(ok, base_ok)
    assert base_ok.tolist() == [True, True, False, True, True] * 14
    before = loader.POOL_BATCHES
    with ThreadPoolExecutor(max_workers=4) as ex:
        futures = [ex.submit(loader.decode_batch, paths, 40, 40, 16) for _ in range(4)]
        results = [f.result(timeout=120) for f in futures]
    assert loader.POOL_BATCHES == before + 4
    for got, ok in results:
        np.testing.assert_array_equal(got, base)
        np.testing.assert_array_equal(ok, base_ok)
    if jax_loader.native_available():
        want, want_ok = jax_loader.decode_batch(paths, 40, 40, n_threads=8)
        np.testing.assert_array_equal(base, want)
        np.testing.assert_array_equal(base_ok, want_ok)


def test_build_is_cached_and_counted(tmp_path):
    """The library lives under build/native with the source hash in its
    name; decode_batch counts the pool runs; an empty batch runs none."""
    path = loader.build()
    assert path == loader.library_path() and path.parent == loader.BUILD_DIR
    assert loader.source_digest() in path.name and loader.build() == path
    assert loader.native_available()
    before = loader.POOL_BATCHES
    out, ok = loader.decode_batch([], 8, 8)
    assert out.shape == (0, 8, 8, 3) and ok.shape == (0,)
    assert loader.POOL_BATCHES == before
    loader.decode_batch([tmp_path / "missing.png"], 8, 8)
    assert loader.POOL_BATCHES == before + 1


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails makes build() raise with its output; no
    compiler and no library makes native_available() False."""
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(loader, "CXX_FLAGS", loader.CXX_FLAGS + ("-DEMR2A_TEST_FLAG",))
    fake = tmp_path / "bin" / "g++"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'no such header' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    with pytest.raises(RuntimeError, match="no such header"):
        loader.build()
    monkeypatch.setattr(loader, "compiler", lambda: None)
    assert not loader.native_available()
    assert not list((tmp_path / "native").glob("*"))


# -------------------------------------- the JAX package's own pool tests

@pytest.fixture()
def image_files(tmp_path, rng):
    paths, arrays = [], []
    for i, (h, w, fmt) in enumerate([(64, 64, "PNG"), (100, 80, "JPEG"), (32, 32, "PNG")]):
        arr = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        p = tmp_path / f"img_{i}.{fmt.lower()}"
        Image.fromarray(arr).save(p, format=fmt)
        paths.append(p)
        arrays.append(arr)
    return paths, arrays


def _png_decode_exact(image_files, tmp_path, rng, monkeypatch):
    paths, arrays = image_files
    out, ok = loader.decode_batch([paths[0]], 64, 64)
    assert ok[0]
    np.testing.assert_array_equal(out[0], arrays[0])


def _jpeg_decode_close(image_files, tmp_path, rng, monkeypatch):
    arr = (rng.rand(48, 48, 3) * 255).astype(np.uint8)
    p = tmp_path / "q.jpg"
    Image.fromarray(arr).save(p, format="JPEG", quality=95)
    out, ok = loader.decode_batch([p], 48, 48)
    assert ok[0]
    pil = np.asarray(Image.open(p).convert("RGB"))
    assert np.abs(out[0].astype(int) - pil.astype(int)).mean() < 2.0


def _resize_and_failures(image_files, tmp_path, rng, monkeypatch):
    paths, _ = image_files
    bad = tmp_path / "corrupt.png"
    bad.write_bytes(b"not an image")
    out, ok = loader.decode_batch([paths[1], bad, tmp_path / "missing.png", paths[2]], 32, 32)
    assert list(ok) == [True, False, False, True]
    assert out[1].sum() == 0 and out[2].sum() == 0
    pil = np.asarray(Image.open(paths[1]).convert("RGB").resize((32, 32), Image.BILINEAR))
    assert np.abs(out[0].astype(int) - pil.astype(int)).mean() < 12


def _parallel_matches_serial(image_files, tmp_path, rng, monkeypatch):
    paths, _ = image_files
    big = list(paths) * 10
    a, ok_a = loader.decode_batch(big, 40, 40, n_threads=1)
    b, ok_b = loader.decode_batch(big, 40, 40, n_threads=8)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ok_a, ok_b)


def _fallback_loader(image_files, tmp_path, rng, monkeypatch):
    monkeypatch.setattr(loader, "native_available", lambda: False)
    paths, _ = image_files
    out, ok = loader.load_images_batch(paths, 32)
    assert out.shape == (3, 32, 32, 3)
    assert ok.all()


REFERENCE_SUITE = {"png_decode_exact": _png_decode_exact,
                   "jpeg_decode_close": _jpeg_decode_close,
                   "resize_and_failures": _resize_and_failures,
                   "parallel_matches_serial": _parallel_matches_serial,
                   "fallback_loader": _fallback_loader}


@pytest.mark.parametrize("name", sorted(REFERENCE_SUITE))
def test_reference_suite_case(name, image_files, tmp_path, rng, monkeypatch):
    REFERENCE_SUITE[name](image_files, tmp_path, rng, monkeypatch)


def test_load_images_batch_takes_the_pool(image_files):
    paths, _ = image_files
    before = loader.POOL_BATCHES
    out, ok = loader.load_images_batch(paths, 32)
    assert loader.POOL_BATCHES == before + 1
    want, want_ok = loader.decode_batch(paths, 32, 32)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(ok, want_ok)

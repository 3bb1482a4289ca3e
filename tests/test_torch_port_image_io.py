"""The port's image reader (keypointfusion_torch/data/image_io.py and the
C++ decoders of csrc/host/image_decode.cc) against cv2.imread, on the CPU.

Images are made from numpy seeds and written by cv2 (or, for the PNG
filter types and grey + alpha, by a small stdlib writer here); each file
is read by cv2.imread and by the port's imread in the same mode
(default: 8-bit BGR; anydepth: cv2.IMREAD_ANYDEPTH).

Tolerance: 0 everywhere, bit for bit, JPEG included (the decoder runs
libjpeg-turbo's integer IDCT, fancy upsampling and fixed-point colour
conversion). Files cv2 reads as None (damaged data) give None; valid
files outside the decoders' scope raise UnsupportedImage.
"""

import ctypes
import struct
import zlib

import cv2
import numpy as np
import pytest

from keypointfusion_torch.data import image_io
from keypointfusion_torch.data.image_io import UnsupportedImage, imread

SIZES = [(480, 640), (37, 53), (17, 9), (1, 1), (2, 3)]


def _smooth_bgr(h, w, seed):
    """Gradients, a disc and mild noise: what a camera frame looks like
    to a JPEG coder (blocks with few and with many coefficients)."""
    r = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([127 + 120 * np.sin(x / 17 + r.rand() * 6)
                    * np.cos(y / 23), 127 + 100 * np.cos((x + y) / 31),
                    x * 255 / max(w, 1)], -1)
    cv2.circle(img, (w // 3, h // 2), max(min(h, w) // 4, 1),
               (30, 200, 90), -1)
    img += r.randn(h, w, 3) * 6
    return np.clip(img, 0, 255).astype(np.uint8)


def _read_both(path, anydepth):
    want = cv2.imread(str(path), cv2.IMREAD_ANYDEPTH if anydepth
                      else cv2.IMREAD_COLOR)
    return imread(str(path), anydepth=anydepth), want


def _assert_same(got, want):
    assert got is not None and want is not None
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------- PNG ---

def _png_filter_types(data: bytes):
    """The filter type byte of every row of a PNG (8-bit samples: one
    row is width * channels bytes)."""
    pos, ihdr, idat = 8, None, b''
    while pos < len(data):
        n, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b'IHDR':
            ihdr = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat += body
        pos += 12 + n
    w, h, depth, color = ihdr[:4]
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[color]
    row = w * ch * depth // 8
    raw = zlib.decompress(idat)
    return {raw[y * (row + 1)] for y in range(h)}


def _write_png(path, img, color_type, filters):
    """A PNG written here: rows filtered with the given types in turn
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth). img is [H, W, C] uint8 or
    uint16 in the file's channel order."""
    h, w, ch = img.shape
    depth = 16 if img.dtype == np.uint16 else 8
    bpp = ch * depth // 8
    rows = img.astype('>u2' if depth == 16 else np.uint8).reshape(
        h, -1).view(np.uint8).astype(np.int64)
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for y in range(h):
        kind = filters[y % len(filters)]
        cur = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if kind == 0:
            f = cur
        elif kind == 1:
            f = cur - left
        elif kind == 2:
            f = cur - prev
        elif kind == 3:
            f = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = (np.abs(p - left), np.abs(p - prev),
                          np.abs(p - upleft))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
            f = cur - pred
        out.append(kind)
        out += (f % 256).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body
                + struct.pack('>I', zlib.crc32(kind + body)))
    data = (image_io.PNG_SIGNATURE
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, depth,
                                         color_type, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(bytes(out), 6))
            + chunk(b'IEND', b''))
    path.write_bytes(data)
    return data


PNG_FILTERS = {'none': cv2.IMWRITE_PNG_FILTER_NONE,
               'sub': cv2.IMWRITE_PNG_FILTER_SUB,
               'up': cv2.IMWRITE_PNG_FILTER_UP,
               'avg': cv2.IMWRITE_PNG_FILTER_AVG,
               'paeth': cv2.IMWRITE_PNG_FILTER_PAETH,
               'all': cv2.IMWRITE_PNG_ALL_FILTERS}


@pytest.mark.parametrize('dtype', [np.uint8, np.uint16])
@pytest.mark.parametrize('channels', [1, 3, 4])
def test_png_written_by_cv2(tmp_path, dtype, channels):
    """8/16-bit grey, BGR and BGRA, each of cv2's filter settings (a
    single type, or all of them chosen row by row), odd sizes; both read
    modes (a colour file read as grey raises, as that is not ported)."""
    r = np.random.RandomState(channels * 10 + np.dtype(dtype).itemsize)
    for h, w in SIZES:
        shape = (h, w, channels) if channels > 1 else (h, w)
        img = r.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
        img[:h // 2] //= 3               # runs of similar rows
        for name, flag in PNG_FILTERS.items():
            path = tmp_path / f'{name}.png'
            assert cv2.imwrite(str(path), img, [cv2.IMWRITE_PNG_FILTER,
                                                flag])
            if name not in ('all', 'none') and h > 1 and dtype == np.uint8:
                assert _png_filter_types(path.read_bytes()) <= {
                    0, {'sub': 1, 'up': 2, 'avg': 3, 'paeth': 4}[name]}
            _assert_same(*_read_both(path, False))
            if channels == 1:
                _assert_same(*_read_both(path, True))
            else:
                with pytest.raises(UnsupportedImage):
                    imread(str(path), anydepth=True)


@pytest.mark.parametrize('color_type', [0, 2, 4, 6])
@pytest.mark.parametrize('dtype', [np.uint8, np.uint16])
def test_png_every_filter_type(tmp_path, color_type, dtype):
    """Rows filtered with each of the five types in turn (and Paeth on
    every row), written here, for grey, RGB, grey + alpha and RGBA."""
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    r = np.random.RandomState(color_type)
    for h, w in [(31, 45), (5, 3), (1, 7), (480, 64)]:
        img = r.randint(0, np.iinfo(dtype).max + 1, (h, w, ch)).astype(
            dtype)
        for filters in ([0, 1, 2, 3, 4], [4], [3, 1]):
            path = tmp_path / 'f.png'
            data = _write_png(path, img, color_type, filters)
            assert _png_filter_types(data) == set(filters[:h])
            _assert_same(*_read_both(path, False))
            if ch <= 2:
                _assert_same(*_read_both(path, True))


def test_png_unsupported_and_damaged(tmp_path):
    """Interlaced and palette files raise; a bad CRC, a cut file, a
    missing IEND and bad zlib data give None, as cv2 gives."""
    img = np.random.RandomState(0).randint(0, 255, (20, 30, 3)).astype(
        np.uint8)
    path = tmp_path / 'a.png'
    data = _write_png(path, img, 2, [0, 1, 2, 3, 4])
    _assert_same(*_read_both(path, False))
    ihdr_end = 8 + 8 + 13
    interlaced = bytearray(data)
    interlaced[ihdr_end - 1] = 1
    interlaced[ihdr_end:ihdr_end + 4] = struct.pack(
        '>I', zlib.crc32(bytes(interlaced[12:ihdr_end])))
    with pytest.raises(UnsupportedImage, match='interlaced'):
        image_io.decode_png(bytes(interlaced))
    palette = bytearray(data)
    palette[ihdr_end - 4] = 3
    palette[ihdr_end:ihdr_end + 4] = struct.pack(
        '>I', zlib.crc32(bytes(palette[12:ihdr_end])))
    with pytest.raises(UnsupportedImage, match='colour type 3'):
        image_io.decode_png(bytes(palette))

    idat = data.index(b'IDAT')
    n = struct.unpack('>I', data[idat - 4:idat])[0]
    junk = b'\x78\x9c' + b'\xff' * (n - 2)       # a zlib header, bad data
    bad_zlib = (data[:idat + 4] + junk
                + struct.pack('>I', zlib.crc32(b'IDAT' + junk))
                + data[idat + 8 + n:])
    damaged = {
        'zlib': bad_zlib,
        'crc': data[:idat + 10] + bytes([data[idat + 10] ^ 0xFF])
        + data[idat + 11:],
        'cut': data[:len(data) // 2],
        'no_iend': data[:-12],
        'junk': image_io.PNG_SIGNATURE + b'junk' * 10,
        'empty': b'',
    }
    for name, bad in damaged.items():
        p = tmp_path / f'{name}.png'
        p.write_bytes(bad)
        assert cv2.imread(str(p)) is None, name
        assert imread(str(p)) is None, name
    with pytest.raises(image_io.CorruptImage, match='CRC'):
        image_io.decode_png(damaged['crc'])
    assert imread(str(tmp_path / 'missing.png')) is None


# ------------------------------------------------------------------ JPEG ---

SAMPLING = {'444': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            '422': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            '420': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}


@pytest.mark.parametrize('quality', [50, 75, 95, 100])
@pytest.mark.parametrize('sampling', sorted(SAMPLING))
def test_jpeg_written_by_cv2(tmp_path, quality, sampling):
    """Colour JPEGs at cv2's coder with the given quality and chroma
    sampling, restart intervals of 0, 1 and 3 MCUs, sizes that are not
    multiples of 16: BGR and the Y plane (anydepth) bit for bit."""
    path = tmp_path / 'c.jpg'
    for h, w in SIZES:
        img = _smooth_bgr(h, w, seed=h * w + quality)
        for rst in (0, 1, 3):
            assert cv2.imwrite(str(path), img, [
                cv2.IMWRITE_JPEG_QUALITY, quality,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
            _assert_same(*_read_both(path, False))
            _assert_same(*_read_both(path, True))


def test_jpeg_grey_and_cut_short(tmp_path):
    """Grey JPEGs in both modes, and colour files cut short, which cv2
    decodes with the rest of the scan mid-grey (libjpeg's premature
    end): the same pixels."""
    path = tmp_path / 'g.jpg'
    for h, w in [(480, 640), (37, 53), (9, 17)]:
        for quality in (50, 95):
            grey = _smooth_bgr(h, w, seed=quality)[..., 1]
            assert cv2.imwrite(str(path), grey,
                               [cv2.IMWRITE_JPEG_QUALITY, quality])
            _assert_same(*_read_both(path, False))
            _assert_same(*_read_both(path, True))
    img = _smooth_bgr(120, 160, seed=3)
    for sampling in ('420', '444'):
        for rst in (0, 2):
            ok, enc = cv2.imencode('.jpg', img, [
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
            data = enc.tobytes()
            for frac in (0.3, 0.7, 0.99):
                path.write_bytes(data[:int(len(data) * frac)])
                _assert_same(*_read_both(path, False))


def _with_exif_orientation(jpeg: bytes, orientation: int) -> bytes:
    """The JPEG with an APP1 EXIF segment (big-endian TIFF, IFD0 holding
    the orientation tag) after SOI."""
    tiff = (b'MM\x00\x2a' + struct.pack('>I', 8) + struct.pack('>H', 1)
            + struct.pack('>HHIHH', 0x0112, 3, 1, orientation, 0)
            + struct.pack('>I', 0))
    body = b'Exif\x00\x00' + tiff
    return jpeg[:2] + b'\xff\xe1' + struct.pack('>H', len(body) + 2) \
        + body + jpeg[2:]


def test_jpeg_unsupported_and_damaged(tmp_path):
    """Progressive, 4:1:1 and RGB-coded files and an EXIF orientation
    other than 1 raise (cv2 decodes them, rotating for the orientation);
    orientation 1 decodes as cv2 does; garbage after the JPEG signature
    gives None."""
    img = _smooth_bgr(48, 64, seed=1)
    ok, base = cv2.imencode('.jpg', img)
    base = base.tobytes()
    progressive = cv2.imencode('.jpg', img, [cv2.IMWRITE_JPEG_PROGRESSIVE,
                                             1])[1].tobytes()
    with pytest.raises(UnsupportedImage, match='progressive'):
        image_io.decode_jpeg(progressive)
    s411 = cv2.imencode('.jpg', img, [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])[1].tobytes()
    with pytest.raises(UnsupportedImage, match='sampling'):
        image_io.decode_jpeg(s411)
    rgb_coded = bytearray(base)
    sof, sos = base.index(b'\xff\xc0'), base.index(b'\xff\xda')
    for k, name in enumerate(b'RGB'):      # component ids 1-3 -> R, G, B
        rgb_coded[sof + 10 + 3 * k] = name
        rgb_coded[sos + 5 + 2 * k] = name
    path = tmp_path / 'rgb.jpg'
    path.write_bytes(bytes(rgb_coded))
    assert cv2.imread(str(path)) is not None
    with pytest.raises(UnsupportedImage, match='RGB-coded'):
        imread(str(path))
    path = tmp_path / 'o.jpg'
    path.write_bytes(_with_exif_orientation(base, 6))
    assert cv2.imread(str(path)).shape == (64, 48, 3)   # cv2 rotates
    with pytest.raises(UnsupportedImage, match='orientation 6'):
        imread(str(path))
    path.write_bytes(_with_exif_orientation(base, 1))
    _assert_same(*_read_both(path, False))
    for name, bad in {'junk': b'\xff\xd8\xff' + b'junk' * 10,
                      'header_cut': base[:100]}.items():
        p = tmp_path / f'{name}.jpg'
        p.write_bytes(bad)
        assert cv2.imread(str(p)) is None, name
        assert imread(str(p)) is None, name


def test_format_from_signature_not_name(tmp_path):
    """A PNG named .jpg and a JPEG named .png read as cv2 reads them;
    another format gives None."""
    img = _smooth_bgr(30, 40, seed=2)
    a, b = tmp_path / 'png.jpg', tmp_path / 'jpeg.png'
    a.write_bytes(cv2.imencode('.png', img)[1].tobytes())
    b.write_bytes(cv2.imencode('.jpg', img)[1].tobytes())
    _assert_same(*_read_both(a, False))
    _assert_same(*_read_both(b, False))
    c = tmp_path / 'x.png'
    c.write_bytes(b'GIF89a' + b'\x00' * 40)
    assert imread(str(c)) is None


def test_decoder_build_raises(tmp_path, monkeypatch):
    """No stand-in: a host library that cannot be built raises, without
    g++ and when g++ fails; a built one is named by a hash of its source
    and flags, so an edited source is built again."""
    import shutil

    from keypointfusion_torch.kernels import build
    monkeypatch.setattr(build, 'BUILD_DIR', tmp_path / '_build')
    monkeypatch.setattr(build, 'CSRC_DIR', tmp_path)
    (tmp_path / 'host').mkdir()
    src = tmp_path / 'host' / 'probe.cc'
    src.write_text('extern "C" int kpf_probe(int x) { return x + 1; }\n')
    lib = build.HostLibrary('probe.cc', {'kpf_probe': [ctypes.c_int]})
    which = shutil.which
    monkeypatch.setattr(shutil, 'which',
                        lambda name: None if name == 'g++' else which(name))
    with pytest.raises(RuntimeError, match='g\\+\\+ not found'):
        lib.load()
    monkeypatch.setattr(shutil, 'which', which)
    assert lib.function('kpf_probe')(41) == 42
    first = lib.library
    assert first.exists() and first.parent == tmp_path / '_build'
    src.write_text('extern "C" int kpf_probe(int x) { return x +; }\n')
    assert lib.library != first
    broken = build.HostLibrary('probe.cc', {'kpf_probe': [ctypes.c_int]})
    with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
        broken.load()
    with pytest.raises(KeyError):
        lib.function('kpf_other')

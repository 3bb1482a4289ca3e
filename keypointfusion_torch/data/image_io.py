"""Image files read as cv2.imread reads them, without cv2.

The data loaders read DexYCB's JPEG colour and 16-bit PNG depth, HO3D's
PNG (v2) or JPEG (v3) colour and its RG-encoded depth PNG, and NYU's and
STB's PNGs. `imread(path)` gives what `cv2.imread(path)` gives for these
files, bit for bit, and `imread(path, anydepth=True)` what
`cv2.imread(path, cv2.IMREAD_ANYDEPTH)` gives:

  * default: uint8 [H, W, 3] in BGR order. 16-bit samples keep their high
    byte (libpng's strip_16, as cv2 asks), grey is replicated to three
    channels and alpha dropped.
  * anydepth: one channel at the file's depth, uint8 or uint16 [H, W]; a
    colour JPEG gives its Y component, as libjpeg's grey output does. A
    colour PNG (which cv2 turns to grey with libpng's own weights) raises
    UnsupportedImage.

The format comes from the file's first bytes, not its name. PNG: 8- and
16-bit grey, grey + alpha, RGB and RGBA, not interlaced; the chunks'
CRCs are checked, the IDAT stream is inflated by zlib and its rows
unfiltered in C++. JPEG: baseline and extended sequential Huffman, 8-bit,
grey or YCbCr, 4:4:4 / 4:2:2 / 4:2:0, restart markers, in C++ with
libjpeg-turbo's arithmetic (csrc/host/image_decode.cc). A valid file
outside that (interlaced or palette PNG, progressive, arithmetic-coded,
12-bit or RGB-coded JPEG, other samplings, an EXIF orientation other than
1, which cv2 would apply) raises UnsupportedImage. A missing file, a file
of another format, or a damaged one (bad CRC, bad zlib or Huffman data,
a missing IEND) gives None, as cv2 gives; `decode_png` and `decode_jpeg`
raise CorruptImage for it instead.

`imwrite(path, img)` writes a PNG, the counterpart of the demos'
cv2.imwrite: uint8 grey [H, W] (or [H, W, 1]), BGR [H, W, 3] or BGRA
[H, W, 4], and uint16 grey, filter 0 and stdlib zlib. Its bytes are not
cv2's, but cv2.imread and `imread` give the array back bit for bit.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Optional

import numpy as np

from keypointfusion_torch.kernels.build import HostLibrary

_P, _I = ctypes.c_void_p, ctypes.c_int
DECODER = HostLibrary('image_decode.cc', {
    'kpf_png_unfilter': [_P, _I, _I, _I, _I, _P, _P, _I],
    'kpf_jpeg_info': [_P, _I, _P, _P, _I],
    'kpf_jpeg_decode': [_P, _I, _I, _P, _P, _I],
})
_CORRUPT, _UNSUPPORTED = 1, 2
_ERR_LEN = 256

PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
JPEG_SIGNATURE = b'\xff\xd8\xff'
# PNG colour type -> channels (3, palette, is not supported)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


class CorruptImage(ValueError):
    """The file is damaged: cv2.imread gives None for it."""


class UnsupportedImage(NotImplementedError):
    """A valid file that this reader does not decode (cv2 would)."""


def _check(rc: int, err) -> None:
    if rc == _CORRUPT:
        raise CorruptImage(err.value.decode())
    if rc == _UNSUPPORTED:
        raise UnsupportedImage(err.value.decode())
    if rc != 0:
        raise RuntimeError(f'image decoder returned {rc}')


def _png_chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise CorruptImage('PNG: truncated chunk')
        crc, = struct.unpack('>I', data[pos + 8 + length:pos + 12 + length])
        critical = not kind[0] & 0x20
        if critical and zlib.crc32(kind + body) != crc:
            raise CorruptImage(f'PNG: CRC error in {kind!r}')
        yield kind, body
        if kind == b'IEND':
            return
        pos += 12 + length
    raise CorruptImage('PNG: no IEND chunk')


def decode_png(data: bytes, anydepth: bool = False) -> np.ndarray:
    if not data.startswith(PNG_SIGNATURE):
        raise CorruptImage('not a PNG file')
    header, idat = None, []
    for kind, body in _png_chunks(data):
        if header is None:
            if kind != b'IHDR' or len(body) != 13:
                raise CorruptImage('PNG: IHDR is not the first chunk')
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
    width, height, depth, color, compression, filtering, interlace = header
    if width == 0 or height == 0 or compression or filtering:
        raise CorruptImage('PNG: bad IHDR')
    if interlace:
        raise UnsupportedImage('interlaced PNG is not supported')
    if color not in _PNG_CHANNELS:
        raise UnsupportedImage(f'PNG colour type {color} is not supported')
    if depth not in (8, 16):
        raise UnsupportedImage(f'PNG bit depth {depth} is not supported')
    try:
        raw = zlib.decompress(b''.join(idat))
    except zlib.error as e:
        raise CorruptImage(f'PNG: {e}') from None
    channels = _PNG_CHANNELS[color]
    bpp = channels * depth // 8
    out = np.empty((height, width * bpp), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(DECODER.function('kpf_png_unfilter')(
        raw, len(raw), height, width * bpp, bpp, out.ctypes.data, err,
        _ERR_LEN), err)
    img = (out.view('>u2').astype(np.uint16) if depth == 16 else out
           ).reshape(height, width, channels)
    if anydepth:
        if channels > 2:
            raise UnsupportedImage('a colour PNG read as grey is not '
                                   'supported')
        return np.ascontiguousarray(img[..., 0])
    if depth == 16:
        img = (img >> 8).astype(np.uint8)
    if channels <= 2:
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., 2::-1])


def decode_jpeg(data: bytes, anydepth: bool = False) -> np.ndarray:
    buf = np.frombuffer(data, np.uint8)
    info = np.zeros(4, np.int32)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(DECODER.function('kpf_jpeg_info')(
        buf.ctypes.data, len(buf), info.ctypes.data, err, _ERR_LEN), err)
    width, height, _, orientation = (int(v) for v in info)
    if orientation != 1:
        raise UnsupportedImage(f'JPEG EXIF orientation {orientation} '
                               f'(cv2 would rotate) is not supported')
    out = np.empty((height, width) if anydepth else (height, width, 3),
                   np.uint8)
    _check(DECODER.function('kpf_jpeg_decode')(
        buf.ctypes.data, len(buf), int(anydepth), out.ctypes.data, err,
        _ERR_LEN), err)
    return out


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body)))


def encode_png(img: np.ndarray) -> bytes:
    """The PNG file of a uint8 grey, BGR or BGRA image or a uint16 grey
    one (see imwrite)."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] in (3, 4):
        color, rows = (2 if img.shape[2] == 3 else 6), img.copy()
        rows[..., :3] = img[..., 2::-1]                # BGR -> RGB
    elif img.dtype in (np.uint8, np.uint16) and img.ndim == 2:
        color, rows = 0, img.astype(img.dtype.newbyteorder('>'))
    else:
        raise ValueError(f'PNG writing takes uint8 grey, BGR or BGRA or '
                         f'uint16 grey images, got {img.dtype} {img.shape}')
    height, width = img.shape[:2]
    if height == 0 or width == 0:
        raise ValueError('an empty image has no PNG')
    raw = rows.reshape(height, -1).view(np.uint8)
    scanlines = np.concatenate([np.zeros((height, 1), np.uint8), raw], 1)
    header = struct.pack('>IIBBBBB', width, height, 8 * img.itemsize, color,
                         0, 0, 0)
    return (PNG_SIGNATURE + _png_chunk(b'IHDR', header)
            + _png_chunk(b'IDAT', zlib.compress(scanlines.tobytes()))
            + _png_chunk(b'IEND', b''))


def imwrite(path: str, img: np.ndarray) -> None:
    """cv2.imwrite(path, img) for a `.png` path; raises ValueError for
    another extension or an image PNG writing does not take."""
    if not path.lower().endswith('.png'):
        raise ValueError(f'{path}: only PNG files are written')
    data = encode_png(img)
    with open(path, 'wb') as f:
        f.write(data)


def imread(path: str, anydepth: bool = False) -> Optional[np.ndarray]:
    """cv2.imread(path) (anydepth=False) or cv2.imread(path,
    cv2.IMREAD_ANYDEPTH) for PNG and JPEG files; None where cv2 gives
    None."""
    try:
        with open(path, 'rb') as f:
            data = f.read()
    except OSError:
        return None
    if data.startswith(PNG_SIGNATURE):
        decode = decode_png
    elif data.startswith(JPEG_SIGNATURE):
        decode = decode_jpeg
    else:
        return None
    try:
        return decode(data, anydepth)
    except CorruptImage:
        return None

"""Flat-image decoders of the port: the role ``cv2.imdecode`` plays in JAX.

JAX decodes flat images and MIRAX/DICOM frames with OpenCV
(``tiatoolbox_tpu/utils/misc.py:41-60``, ``wsicore/mirax.py:214-237``,
``wsicore/dicom.py:361-376``); the card machine has no OpenCV, so the port
decodes with its own code:

- PNG: the chunk stream (CRC-checked), zlib from the standard library, the
  five filter types (undone in host C++, ``native.png_unfilter``), Adam7
  interlacing, 8- and 16-bit samples of every colour
  type (grey, RGB, palette, grey+alpha, RGBA) and ``tRNS``;
- BMP: uncompressed 24- and 32-bit rows, bottom-up or top-down, and 32-bit
  ``BI_BITFIELDS`` with an alpha mask;
- JPEG: the port's baseline decoder (``native.decode_jpeg``);
- JPEG 2000: JP2 files and raw codestreams through the port's decoder
  (``native.decode_j2k``, OpenJPEG's pixels bit for bit).

``imdecode(data, mode)`` gives what ``cv2.imdecode`` gives, in RGB(A) order:
``mode="unchanged"`` (``IMREAD_UNCHANGED``) keeps grey as ``[H, W]``, alpha,
and 16-bit samples; ``mode="color"`` (``IMREAD_COLOR``) always gives ``[H, W,
3]`` uint8 (grey replicated, alpha dropped, 16-bit samples shifted right by
8, as libpng's ``png_set_strip_16``). Data that is no image, or a corrupt or
truncated stream, gives ``None``, as OpenCV's does. A format or feature the
port does not decode raises ``FileNotSupportedError`` naming it: sub-byte
PNG samples, other BMP layouts, progressive, arithmetic-coded, 12-bit,
lossless, multi-scan, 4-component and odd-sampling JPEG, the JPEG 2000
features ``native.decode_j2k`` refuses (HTJ2K, POC, PPM/PPT, RGN,
sub-sampled or other than 8-bit components), and GIF, TIFF, WebP and PNM
data.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from tiatoolbox_tpu_torch.utils.exceptions import FileNotSupportedError

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# PNG colour type -> samples per pixel
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _other_format(data: bytes) -> str | None:
    """Name of a format OpenCV reads and the port does not, from its magic bytes."""
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if data[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"):
        return "TIFF"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if len(data) > 2 and data[:1] == b"P" and data[1:2] in b"1234567" and data[2:3].isspace():
        return "PNM"
    if data[:4] == b"\x76\x2f\x31\x01":
        return "OpenEXR"
    if data.startswith((b"#?RADIANCE", b"#?RGBE")):
        return "Radiance HDR"
    return None


def imdecode(data, mode: str = "unchanged") -> np.ndarray | None:
    """Decode an encoded PNG, BMP, JPEG or JPEG 2000 image held in memory.

    Args:
        data: The encoded bytes (``bytes``, ``bytearray`` or a uint8 array).
        mode: ``"unchanged"`` or ``"color"``, as described in the module.

    Returns:
        The image in RGB(A) channel order, or ``None`` for data that is no
        image or a stream that is corrupt.

    Raises:
        FileNotSupportedError: a format or feature the port does not decode.
        ValueError: an unknown ``mode``.
    """
    if mode not in ("unchanged", "color"):
        msg = f"mode must be 'unchanged' or 'color', got {mode!r}."
        raise ValueError(msg)
    data = bytes(data) if not isinstance(data, bytes) else data
    color = mode == "color"
    if data[:8] == PNG_SIGNATURE:
        return _decode_png(data, color=color)
    if data[:2] == b"\xff\xd8":
        return _decode_jpeg(data, color=color)
    if data[:2] == b"BM":
        return _decode_bmp(data, color=color)
    if data[4:12] == b"jP  \r\n\x87\n" or data[:4] == b"\xff\x4f\xff\x51":
        return _decode_j2k(data, color=color)
    name = _other_format(data)
    if name is not None:
        msg = f"{name} images are not supported by the port's decoders."
        raise FileNotSupportedError(msg)
    return None


# -- JPEG ----------------------------------------------------------------------


def _decode_jpeg(data: bytes, *, color: bool) -> np.ndarray | None:
    from tiatoolbox_tpu_torch import native

    try:
        img = native.decode_jpeg(data)
    except native.JpegDecodeError as exc:
        if exc.unsupported:  # a feature the decoder lacks, where OpenCV decodes
            msg = f"JPEG stream not supported by the port's decoder: {exc.reason}"
            raise FileNotSupportedError(msg) from exc
        return None
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2) if color else img[:, :, 0]
    return img


# -- JPEG 2000 -----------------------------------------------------------------


def _decode_j2k(data: bytes, *, color: bool) -> np.ndarray | None:
    from tiatoolbox_tpu_torch import native

    try:
        img = native.decode_j2k(data)
    except native.J2kDecodeError as exc:
        if str(exc).startswith("unsupported"):  # a feature the decoder lacks
            msg = f"JPEG 2000 stream not supported by the port's decoder: {exc}"
            raise FileNotSupportedError(msg) from exc
        return None
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2) if color else img[:, :, 0]
    return img


# -- BMP -----------------------------------------------------------------------


def _decode_bmp(data: bytes, *, color: bool) -> np.ndarray | None:
    if len(data) < 18:
        return None
    (offset,) = struct.unpack_from("<I", data, 10)
    (header,) = struct.unpack_from("<I", data, 14)
    if header not in (40, 52, 56, 108, 124):
        msg = f"BMP with a {header}-byte info header is not supported by the port's decoder."
        raise FileNotSupportedError(msg)
    if len(data) < 14 + header:
        return None
    width, height, _planes, bpp, compression = struct.unpack_from("<iiHHI", data, 18)
    alpha = False
    if bpp == 24 and compression == 0:
        pass
    elif bpp == 32 and compression == 0:
        pass
    elif bpp == 32 and compression == 3:
        masks = struct.unpack_from("<III", data, 54)
        alpha_mask = struct.unpack_from("<I", data, 66)[0] if header >= 56 else 0
        if masks != (0xFF0000, 0xFF00, 0xFF) or alpha_mask not in (0, 0xFF000000):
            msg = f"BMP bit-field masks {masks} are not supported by the port's decoder."
            raise FileNotSupportedError(msg)
        alpha = alpha_mask != 0
    else:
        msg = (
            f"BMP with {bpp} bits per pixel and compression {compression} is not "
            "supported by the port's decoder (24- and 32-bit uncompressed only)."
        )
        raise FileNotSupportedError(msg)
    if width <= 0 or height == 0:
        return None
    rows = abs(height)
    pix = bpp // 8
    stride = (width * bpp + 31) // 32 * 4
    if offset + stride * rows > len(data):
        return None
    body = np.frombuffer(data, np.uint8, stride * rows, offset).reshape(rows, stride)
    body = body[:, : width * pix].reshape(rows, width, pix)
    if height > 0:
        body = body[::-1]
    keep = 4 if alpha and not color else 3
    out = np.empty((rows, width, keep), np.uint8)
    out[..., 0] = body[..., 2]
    out[..., 1] = body[..., 1]
    out[..., 2] = body[..., 0]
    if keep == 4:
        out[..., 3] = body[..., 3]
    return out


# -- PNG -----------------------------------------------------------------------


def _png_chunks(data: bytes):
    """(type, body) of each chunk; ``None`` where the stream is cut or a
    critical chunk's CRC is wrong."""
    pos = 8
    chunks = []
    while pos + 12 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        end = pos + 8 + length
        if end + 4 > len(data):
            return None
        body = data[pos + 8 : end]
        (crc,) = struct.unpack_from(">I", data, end)
        if zlib.crc32(kind + body) != crc:
            if kind[:1].isupper():
                return None
        else:
            chunks.append((kind, body))
        pos = end + 4
        if kind == b"IEND":
            break
    return chunks


def _decode_png(data: bytes, *, color: bool) -> np.ndarray | None:  # noqa: C901, PLR0912
    from tiatoolbox_tpu_torch import native

    chunks = _png_chunks(data)
    if not chunks or chunks[0][0] != b"IHDR" or len(chunks[0][1]) != 13:
        return None
    width, height, depth, ctype, _comp, _filt, interlace = struct.unpack(">IIBBBBB", chunks[0][1])
    if ctype not in _PNG_CHANNELS or width == 0 or height == 0:
        return None
    if depth < 8 or depth not in (8, 16) or (ctype == 3 and depth != 8):
        msg = f"PNG with {depth}-bit samples (colour type {ctype}) is not supported by the port's decoder."
        raise FileNotSupportedError(msg)
    palette = trns = None
    idat = []
    for kind, body in chunks[1:]:
        if kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if not idat or (ctype == 3 and palette is None):
        return None
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error:
        return None
    channels = _PNG_CHANNELS[ctype]
    bpp = channels * depth // 8
    samples = np.zeros((height, width, bpp), np.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw = len(range(x0, width, dx))
        ph = len(range(y0, height, dy))
        if pw == 0 or ph == 0:
            continue
        size = ph * (pw * bpp + 1)
        if pos + size > len(raw):
            return None
        image = native.png_unfilter(raw[pos : pos + size], ph, pw * bpp, bpp)
        if image is None:
            return None
        samples[y0::dy, x0::dx] = image.reshape(ph, pw, bpp)
        pos += size
    if depth == 16:
        pix = samples.reshape(height, width, channels, 2).astype(np.uint16)
        pix = (pix[..., 0] << 8) | pix[..., 1]
    else:
        pix = samples.reshape(height, width, channels)
    return _png_channels(pix, ctype, depth, palette, trns, color=color)


def _png_channels(pix, ctype, depth, palette, trns, *, color: bool) -> np.ndarray | None:
    """PNG samples to what ``cv2.imdecode`` returns, in RGB(A) order."""
    alpha = None
    if ctype == 3:
        index = pix[..., 0]
        if int(index.max()) >= len(palette):
            return None
        rgb = palette[index]
        if trns is not None:
            table = np.full(256, 255, np.uint8)
            table[: len(trns)] = np.frombuffer(trns, np.uint8)[:256]
            alpha = table[index]
    elif ctype == 2:
        rgb = pix
        if trns is not None and len(trns) >= 6:
            key = np.array(struct.unpack(">HHH", trns[:6]), np.int64)
            hit = np.all(pix.astype(np.int64) == key, axis=-1)
            top = 65535 if depth == 16 else 255
            alpha = np.where(hit, 0, top).astype(pix.dtype)
    elif ctype == 0:
        rgb = None
    elif ctype == 4:
        rgb, alpha = np.repeat(pix[..., :1], 3, axis=-1), pix[..., 1]
    else:
        rgb, alpha = pix[..., :3], pix[..., 3]
    if color:
        out = np.repeat(pix[..., :1], 3, axis=-1) if rgb is None else rgb
        if out.dtype == np.uint16:
            out = (out >> 8).astype(np.uint8)
        return np.ascontiguousarray(out)
    if rgb is None:
        return np.ascontiguousarray(pix[..., 0])
    if alpha is None:
        return np.ascontiguousarray(rgb)
    return np.concatenate([rgb, alpha[..., None]], axis=-1)

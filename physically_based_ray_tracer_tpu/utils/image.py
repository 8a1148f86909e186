"""Image IO and pixel conversion.

Replaces ``Surface``/``RGBF32_to_RGB8`` (template/surface.cpp,
template/precomp.h:300-316) and the stb-based PNG capture
(Core/Renderer.cpp:437-465). PNG (8-bit grey, RGB, RGBA) is written and
read with the standard library's ``zlib``; Radiance .hdr with numpy.
"""

from __future__ import annotations

import os
import struct
import time
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}     # PNG colour type -> channels


def rgbf32_to_rgb8(img: np.ndarray) -> np.ndarray:
    """float RGB in [0,1] -> uint8, replicating RGBF32_to_RGB8 semantics
    (template/precomp.h:300-316: scale by 255, clamp)."""
    return np.clip(np.asarray(img) * 255.0, 0.0, 255.0).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """(H, W, 3|4) uint8 -> PNG bytes (8-bit RGB/RGBA, filter 0)."""
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w, c = arr.shape
    if c not in (3, 4):
        raise ValueError(f"encode_png wants 3 or 4 channels, got {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           arr.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _unfilter(raw: bytes, h: int, w: int, c: int) -> np.ndarray:
    stride = w * c
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int32)
        pos += stride + 1
        if ftype == 0:
            cur = line
        elif ftype == 1:      # Sub: running sum per channel, mod 256
            cur = np.cumsum(line.reshape(w, c), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:      # Up
            cur = (line + prior) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            cur = line.copy()
            for x in range(stride):
                a = cur[x - c] if x >= c else 0
                b = prior[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    cc = prior[x - c] if x >= c else 0
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prior = cur
    return out.reshape(h, w, c)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 for 8-bit grey, grey+alpha, RGB and
    RGBA images without interlacing; anything else raises ValueError."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"unsupported PNG (bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace})")
    return _unfilter(zlib.decompress(b"".join(idat)), h, w, _CHANNELS[ctype])


def write_png(path: str, img: np.ndarray) -> str:
    """Write an (H, W, 3) float [0,1] or uint8 image as PNG.

    Mirrors ``Renderer::Capture`` (Core/Renderer.cpp:437-465) minus the ARGB
    repacking (our framebuffer is float RGB throughout).
    """
    arr = img if img.dtype == np.uint8 else rgbf32_to_rgb8(img)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(arr))
    return path


def capture_path(directory: str = "assets/captures") -> str:
    """Timestamped capture filename, format of Core/Renderer.cpp:459-460."""
    stamp = time.strftime("%Y-%m-%d_%H-%M-%S")
    return os.path.join(directory, f"capture_{stamp}.png")


def read_image(path: str) -> np.ndarray:
    """Read a PNG to float32 RGB or RGBA in [0,1] (stb_image replacement);
    grey images are expanded to RGB (grey+alpha to RGBA)."""
    with open(path, "rb") as f:
        arr = decode_png(f.read())
    if arr.shape[-1] in (1, 2):
        arr = np.concatenate([arr[..., :1]] * 3 + [arr[..., 1:]], axis=-1)
    return arr.astype(np.float32) / 255.0


def write_hdr(path: str, img: np.ndarray) -> str:
    """Write an (H, W, 3) float32 RGB image as a Radiance .hdr (RGBE, flat
    scanlines) — the inverse of read_hdr, used for skydome fixtures."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    m = img.max(axis=-1)
    exp = np.zeros((h, w), np.int32)
    nz = m > 1e-32
    exp[nz] = np.frexp(m[nz])[1]
    scale = np.where(nz, np.ldexp(1.0, -exp) * 256.0, 0.0).astype(np.float32)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    # Flat-scanline guard: stb-style readers treat a scanline whose first two
    # bytes are 0x02 0x02 (for widths 8..32767) as adaptive-RLE. Bump the
    # green mantissa of such a first pixel by one step (≤0.4% channel error)
    # so external tools never misdecode these flat files.
    if 8 <= w < 32768:
        bad = (rgbe[:, 0, 0] == 2) & (rgbe[:, 0, 1] == 2)
        rgbe[bad, 0, 1] = 3
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(b"-Y %d +X %d\n" % (h, w))
        f.write(rgbe.tobytes())
    return path


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr file to float32 RGB (stbi_loadf replacement).

    Pure-python RLE decoder for the RGBE format used by the reference's
    skydome loading (Core/Camera.cpp:9).
    """
    with open(path, "rb") as f:
        data = f.read()
    # Header ends at the first blank line; next line is the resolution.
    pos = 0
    lines = []
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line == b"":
            break
        lines.append(line)
    res_nl = data.index(b"\n", pos)
    res = data[pos:res_nl].split()
    pos = res_nl + 1
    if res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported .hdr orientation: {res}")
    height, width = int(res[1]), int(res[3])

    rgbe = np.zeros((height, width, 4), dtype=np.uint8)
    buf = np.frombuffer(data, dtype=np.uint8, offset=pos)
    bi = 0
    for y in range(height):
        if width < 8 or width > 0x7FFF or not (
                buf[bi] == 2 and buf[bi + 1] == 2 and (int(buf[bi + 2]) << 8 | int(buf[bi + 3])) == width):
            # flat (non-RLE) scanline
            rgbe[y] = buf[bi:bi + width * 4].reshape(width, 4)
            bi += width * 4
            continue
        bi += 4
        for c in range(4):
            x = 0
            while x < width:
                count = int(buf[bi]); bi += 1
                if count > 128:  # run
                    rgbe[y, x:x + count - 128, c] = buf[bi]
                    bi += 1
                    x += count - 128
                else:            # literal
                    rgbe[y, x:x + count, c] = buf[bi:bi + count]
                    bi += count
                    x += count
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]

"""Minimal image I/O with no external dependency: PNG (stdlib zlib),
Radiance HDR, and JPEG through PIL where it is installed.

Copy of lighthouse2_tpu/utils/image.py (write_png, read_png, write_hdr,
read_hdr, read_jpeg). Deliberate difference: read_png also takes the PNG's
bytes, so the glTF loader decodes embedded images in memory where the JAX
package writes them to a file under /tmp first. Without PIL, read_jpeg
raises the JAX package's error.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, image: np.ndarray) -> None:
    """Write [H,W,3] float (0..1) or uint8 image as PNG."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w = img.shape[:2]
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    hdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", hdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def read_png(path) -> np.ndarray:
    """Minimal PNG reader: 8-bit RGB/RGBA/gray, no interlace. `path` is a
    file path or the file's bytes. Returns uint8 [H,W,C]."""
    if isinstance(path, (bytes, bytearray)):
        data = bytes(path)
    else:
        with open(path, "rb") as f:
            data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a png"
    pos = 8
    idat = b""
    w = h = bitdepth = coltype = None
    palette = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, bitdepth, coltype, _, _, interlace = struct.unpack(">IIBBBBB", body)
            assert bitdepth == 8 and interlace == 0, "unsupported png"
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[coltype]
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        ft = raw[pos]
        row = np.frombuffer(raw[pos + 1:pos + 1 + stride], np.uint8).copy()
        pos += 1 + stride
        if ft == 0:
            pass
        elif ft == 1:  # sub
            for i in range(channels, stride):
                row[i] = (row[i] + row[i - channels]) & 0xFF
        elif ft == 2:  # up
            row = (row.astype(np.int32) + prev) % 256
            row = row.astype(np.uint8)
        elif ft == 3:  # average
            for i in range(stride):
                left = row[i - channels] if i >= channels else 0
                row[i] = (row[i] + ((int(left) + int(prev[i])) >> 1)) & 0xFF
        elif ft == 4:  # paeth
            for i in range(stride):
                a = int(row[i - channels]) if i >= channels else 0
                b = int(prev[i])
                c = int(prev[i - channels]) if i >= channels else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[i] = (row[i] + pr) & 0xFF
        out[y] = row
        prev = out[y]
    img = out.reshape(h, w, channels)
    if coltype == 3:
        img = palette[img[:, :, 0]]
    return img


def write_hdr(path: str, image: np.ndarray) -> None:
    """Write [H,W,3] float as uncompressed Radiance RGBE."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    maxc = img.max(axis=2)
    exp = np.zeros((h, w), np.int32)
    mant = np.zeros_like(img)
    nz = maxc > 1e-32
    # 2^(exp-1) <= max < 2^exp so the mantissa lands in [128,255] (frexp)
    exp[nz] = np.floor(np.log2(maxc[nz])).astype(np.int32) + 1
    scale = np.where(nz, 256.0 / np.exp2(exp), 0.0)
    mant = np.clip(img * scale[..., None] + 0.5, 0, 255).astype(np.uint8)
    rgbe = np.concatenate([mant, (exp + 128).clip(0, 255).astype(np.uint8)[..., None]], 2)
    rgbe[~nz] = 0
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr (RGBE, flat or new-style RLE) → float32 [H,W,3].

    Replaces FreeImage HDR loading (host_skydome.cpp:65-99)."""
    with open(path, "rb") as f:
        data = f.read()
    pos = data.index(b"\n\n") if b"\n\n" in data else data.index(b"\n\r\n")
    header, rest = data[:pos], data[pos:]
    rest = rest.lstrip(b"\r\n")
    nl = rest.index(b"\n")
    dims = rest[:nl].split()
    assert dims[0] == b"-Y" and dims[2] == b"+X", "unsupported hdr orientation"
    h, w = int(dims[1]), int(dims[3])
    body = rest[nl + 1:]
    rgbe = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        if len(body) >= pos + 4 and body[pos] == 2 and body[pos + 1] == 2 \
                and (body[pos + 2] << 8 | body[pos + 3]) == w:
            # new-style RLE scanline
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    cnt = body[pos]
                    pos += 1
                    if cnt > 128:
                        rgbe[y, x:x + cnt - 128, c] = body[pos]
                        pos += 1
                        x += cnt - 128
                    else:
                        rgbe[y, x:x + cnt, c] = np.frombuffer(
                            body[pos:pos + cnt], np.uint8)
                        pos += cnt
                        x += cnt
        else:
            row = np.frombuffer(body[pos:pos + w * 4], np.uint8).reshape(w, 4)
            rgbe[y] = row
            pos += w * 4
    mant = rgbe[..., :3].astype(np.float32)
    exp = rgbe[..., 3].astype(np.int32) - 128
    scale = np.where(rgbe[..., 3] > 0, np.exp2(exp.astype(np.float32)) / 256.0, 0.0)
    return mant * scale[..., None]


def read_jpeg(path) -> "np.ndarray":
    """Decode a baseline/progressive JPEG -> uint8 [H,W,3].

    The reference loads textures through FreeImage (host_texture.cpp); the
    analogous system decoder here is PIL (baked into the image). Gated with
    a clear error if PIL is unavailable."""
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "JPEG decoding requires PIL (unavailable in this environment); "
            "convert the texture to PNG") from e
    import io
    if isinstance(path, (bytes, bytearray)):
        img = Image.open(io.BytesIO(path))
    else:
        img = Image.open(path)
    return np.asarray(img.convert("RGB"))

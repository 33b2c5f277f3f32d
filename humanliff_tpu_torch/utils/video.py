"""PNG frames and orbit videos (port of ``humanliff_tpu/utils/video.py``).

:func:`write_png` needs only the standard library (``zlib``, ``struct``): a
GPU machine need not have imageio or Pillow. :func:`write_video` keeps the JAX
package's order of writers:

1. ``imageio`` mp4, when imageio and one of its mp4 plugins (``imageio_ffmpeg``
   or ``av``) are installed: the reference's contract
   (triplane_sample_layered.py:180-199);
2. an MJPEG AVI (:func:`write_mjpeg_avi`): JPEG frames by Pillow in a
   hand-built RIFF/AVI container with an ``idx1`` index;
3. no video, when neither is installed: the caller's PNGs remain.

Only a missing writer moves on to the next one. A writer that fails raises,
after removing the partial file it left.
"""

from __future__ import annotations

import importlib.util
import io
import os
import struct
import zlib
from typing import List, Optional

import numpy as np

_PNG_COLOR = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type (grey, RGB, RGBA)


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """An 8-bit PNG of ``img`` (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) uint8."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"PNG frames are uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _PNG_COLOR:
        raise ValueError(f"PNG frames are (H, W[, 1|3|4]), got {img.shape}")
    H, W, C = img.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, W * C)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", W, H, 8, _PNG_COLOR[C], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + chunk(b"IEND", b""))


def _jpeg_bytes(frame: np.ndarray, quality: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(frame)).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def write_mjpeg_avi(path: str, frames: List[np.ndarray], fps: int = 20,
                    quality: int = 92) -> str:
    """Write ``frames`` (uint8 (H, W, 3), all one size) as an MJPEG AVI:
    ``RIFF('AVI ' LIST(hdrl avih LIST(strl strh strf)) LIST(movi 00dc...) idx1)``."""
    if not frames:
        raise ValueError("no frames")
    h, w = frames[0].shape[:2]
    for f in frames:
        if f.shape[:2] != (h, w) or f.dtype != np.uint8:
            raise ValueError("frames must share one (H, W) and be uint8")
    jpegs = [_jpeg_bytes(f, quality) for f in frames]
    max_size = max(len(j) for j in jpegs)

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        # RIFF chunks are word-aligned: an odd payload gets a pad byte that
        # its stored size does not count.
        return fourcc + struct.pack("<I", len(payload)) + payload + (
            b"\x00" if len(payload) % 2 else b"")

    def lst(fourcc: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", fourcc + payload)

    avih = struct.pack(
        "<14I",
        int(1e6 / max(fps, 1)),      # dwMicroSecPerFrame
        max_size * fps,              # dwMaxBytesPerSec (upper bound)
        0,                           # dwPaddingGranularity
        0x10,                        # dwFlags: AVIF_HASINDEX
        len(frames), 0, 1,           # dwTotalFrames, dwInitialFrames, dwStreams
        max_size,                    # dwSuggestedBufferSize
        w, h, 0, 0, 0, 0,            # dwWidth, dwHeight, dwReserved[4]
    )
    strh = b"vids" + b"MJPG" + struct.pack(
        "<IHHIIIIIIiI4H",
        0, 0, 0,                     # dwFlags, wPriority, wLanguage
        0, 1, max(fps, 1),           # dwInitialFrames, dwScale, dwRate
        0, len(frames),              # dwStart, dwLength (in frames)
        max_size, -1, 0,             # dwSuggestedBufferSize, dwQuality, dwSampleSize
        0, 0, w, h,                  # rcFrame
    )
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))

    movi_payload = b"movi"
    index = b""
    for j in jpegs:
        # idx1 offsets point at a chunk's fourcc, relative to the 'movi'
        # fourcc (the convention players expect).
        index += b"00dc" + struct.pack("<3I", 0x10, len(movi_payload), len(j))
        movi_payload += chunk(b"00dc", j)
    body = b"AVI " + hdrl + chunk(b"LIST", movi_payload) + chunk(b"idx1", index)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


def _removing_partial(path: str, write) -> str:
    try:
        write()
    except BaseException:
        if os.path.exists(path):
            os.unlink(path)
        raise
    return path


def write_video(path: str, frames: List[np.ndarray], fps: int = 20) -> Optional[str]:
    """Write ``frames`` as ``path`` (mp4), else as its sibling ``.avi``, else
    not at all. Returns the path written, or None, and prints which."""
    frames = [np.ascontiguousarray(f, np.uint8) for f in frames]
    if importlib.util.find_spec("imageio") and (
            importlib.util.find_spec("imageio_ffmpeg") or importlib.util.find_spec("av")):
        import imageio.v2 as imageio

        out = _removing_partial(path, lambda: imageio.mimwrite(path, frames, fps=fps))
    elif importlib.util.find_spec("PIL"):
        avi = os.path.splitext(path)[0] + ".avi"
        out = _removing_partial(avi, lambda: write_mjpeg_avi(avi, frames, fps=fps))
    else:
        print(f"[video] no video written for {os.path.basename(path)}: neither an "
              "imageio mp4 plugin nor Pillow is installed; the PNG frames remain")
        return None
    print(f"[video] wrote {out}")
    return out

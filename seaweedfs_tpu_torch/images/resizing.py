"""Resize and orientation fix (weed/images/resizing.go:16 Resized,
orientation.go FixJpgOrientation), the port's copy of
seaweedfs_tpu/images/resizing.py.

resized(data, mime, width, height, mode) -> (data, w, h) changes nothing
when Pillow cannot be imported, the mime is not an image, or no size is
asked for, as the reference passes such content through.  Modes: "" and
"fit" fit the image within the box keeping its aspect, "fill" covers the
box and crops the centre.
"""

from __future__ import annotations

from typing import Optional, Tuple


def resizing_available() -> bool:
    try:
        import PIL  # noqa: F401

        return True
    except ImportError:
        return False


_ORIENT_OPS = {
    2: ("mirror",), 3: ("rotate180",), 4: ("flip",),
    5: ("mirror", "rotate270"), 6: ("rotate270",),
    7: ("mirror", "rotate90"), 8: ("rotate90",),
}


def _fix_orientation(img):
    from PIL import Image

    try:
        exif = img.getexif()
        orientation = exif.get(274, 1)
    except Exception:
        return img
    for op in _ORIENT_OPS.get(orientation, ()):
        if op == "mirror":
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        elif op == "flip":
            img = img.transpose(Image.FLIP_TOP_BOTTOM)
        elif op == "rotate90":
            img = img.transpose(Image.ROTATE_90)
        elif op == "rotate180":
            img = img.transpose(Image.ROTATE_180)
        elif op == "rotate270":
            img = img.transpose(Image.ROTATE_270)
    return img


def resized(data: bytes, mime: str, width: Optional[int],
            height: Optional[int], mode: str = "") -> Tuple[bytes, int, int]:
    if not (mime or "").startswith("image/") or not (width or height) \
            or not resizing_available():
        return data, 0, 0
    import io

    from PIL import Image

    try:
        img = Image.open(io.BytesIO(data))
        img.load()
    except Exception:
        return data, 0, 0
    if mime == "image/jpeg":
        img = _fix_orientation(img)
    w, h = img.size
    tw, th = width or w, height or h
    if mode == "fill":
        scale = max(tw / w, th / h)
        img = img.resize((max(1, round(w * scale)),
                          max(1, round(h * scale))))
        left = (img.size[0] - tw) // 2
        top = (img.size[1] - th) // 2
        img = img.crop((left, top, left + tw, top + th))
    else:  # fit within the box, keep aspect
        scale = min(tw / w, th / h, 1.0) if (width and height) else \
            (tw / w if width else th / h)
        img = img.resize((max(1, round(w * scale)),
                          max(1, round(h * scale))))
    out = io.BytesIO()
    fmt = {"image/jpeg": "JPEG", "image/png": "PNG",
           "image/gif": "GIF"}.get(mime, "PNG")
    img.save(out, format=fmt)
    return out.getvalue(), img.size[0], img.size[1]


_FMT_MIME = {"JPEG": "image/jpeg", "PNG": "image/png", "GIF": "image/gif"}


def resized_from_query(data: bytes, mime: str, query: dict
                       ) -> Tuple[bytes, str]:
    """-> (body, mime) for a read handler's ?width/?height/?mode hook,
    shared by the volume and filer servers.  Any resize failure —
    including a save-format mismatch like RGBA data labeled image/jpeg —
    falls back to the original bytes, and the returned mime names the
    bytes actually served (a PNG re-encode must not ride out labeled
    image/webp)."""

    def _dim(name: str) -> Optional[int]:
        try:
            return int(query.get(name) or 0) or None
        except (TypeError, ValueError):
            return None  # bad value: serve the original

    width, height = _dim("width"), _dim("height")
    if not (width or height):
        return data, mime
    try:
        out, w, h = resized(data, mime, width, height,
                            query.get("mode", ""))
    except Exception:
        return data, mime
    if out is data or not w:
        return data, mime
    fmt = {"image/jpeg": "JPEG", "image/png": "PNG",
           "image/gif": "GIF"}.get(mime, "PNG")
    return out, _FMT_MIME[fmt]

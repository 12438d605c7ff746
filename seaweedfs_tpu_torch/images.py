"""Image manipulation on the read path (the port's copy of
`seaweedfs_tpu/images.py`; weed/images/: resizing.go Resized +
orientation.go FixJpgOrientation).

Modes "" (shrink-to-fit preserving aspect), "fit" (cover+crop to the
exact box) and "fill" (pad to the exact box); EXIF orientation is
applied before serving.  Implemented over PIL; where PIL is missing or
the image is malformed the bytes are served as they are.
"""

from __future__ import annotations

import io


def is_image_mime(mime: str) -> bool:
    return mime.startswith("image/")


def resized(data: bytes, mime: str, width: int, height: int,
            mode: str = "") -> bytes:
    """images/resizing.go:18 Resized.  Returns the original bytes when
    no work applies (not an image, no dims, already small enough)."""
    if (width == 0 and height == 0) or not is_image_mime(mime):
        return data
    try:
        from PIL import Image, ImageOps
        img = Image.open(io.BytesIO(data))
        fmt = img.format or "PNG"  # BEFORE transpose: the transposed
        # copy has format=None, which would re-encode JPEGs as PNG
        # under a Content-Type that still says image/jpeg
        img = ImageOps.exif_transpose(img)  # orientation.go analog
        w0, h0 = img.size
        if not ((width and w0 > width) or (height and h0 > height)):
            return data  # never upscale (resizing.go:26)
        if mode == "fit":
            # exact box, crop overflow (imaging.Fill Center)
            out = ImageOps.fit(img, (width or w0, height or h0))
        elif mode == "fill":
            # exact box, pad (imaging.Fit then letterbox)
            img.thumbnail((width or w0, height or h0))
            out = ImageOps.pad(img, (width or w0, height or h0))
        else:
            if width and height:
                if width == height and w0 != h0:
                    out = ImageOps.fit(img, (width, height))
                else:
                    out = img.resize((width, height))
            else:
                # one dimension: scale preserving aspect
                ratio = (width / w0) if width else (height / h0)
                out = img.resize((max(1, round(w0 * ratio)),
                                  max(1, round(h0 * ratio))))
        buf = io.BytesIO()
        if fmt == "JPEG" and out.mode not in ("RGB", "L"):
            out = out.convert("RGB")
        out.save(buf, format=fmt)
        return buf.getvalue()
    except Exception:  # noqa: BLE001 — malformed image: serve as-is,
        return data    # exactly the reference's fallback behavior

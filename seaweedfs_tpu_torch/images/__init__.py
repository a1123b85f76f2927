"""Image resize and EXIF orientation on volume reads (weed/images/).

A GET with ``?width=`` or ``?height=`` of an image resizes it on the fly
when Pillow can be imported; without it the original bytes are served,
as the reference serves content it cannot resize.
"""

from .resizing import resized, resized_from_query, resizing_available

__all__ = ["resized", "resized_from_query", "resizing_available"]

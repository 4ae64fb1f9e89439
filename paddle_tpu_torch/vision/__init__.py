"""paddle.vision of the port (ports ``paddle_tpu/vision/__init__.py``):
``models`` and the image-backend getter and setter.  ``image_load``,
``transforms``, ``datasets`` and ``ops`` wait (ROADMAP queue 1 item
5.9)."""
from . import models  # noqa: F401

_image_backend = "pil"


def set_image_backend(backend):
    """(reference vision/image.py set_image_backend)"""
    global _image_backend
    if backend not in ("pil", "cv2", "tensor"):
        raise ValueError(f"unsupported backend {backend!r}")
    _image_backend = backend


def get_image_backend():
    return _image_backend

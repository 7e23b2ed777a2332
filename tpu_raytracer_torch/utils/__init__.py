from .image import encode_png, save_png

__all__ = ["encode_png", "save_png"]

from .image import encode_png, overlay_fps, save_png

__all__ = ["encode_png", "overlay_fps", "save_png"]

from .ops import sad_disparity, sad_hwimg_site  # noqa: F401

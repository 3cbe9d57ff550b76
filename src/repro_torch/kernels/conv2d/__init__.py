from .ops import conv2d_hwimg_site, conv2d_stencil  # noqa: F401

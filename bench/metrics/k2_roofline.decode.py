"""``k2_roofline.decode`` (kernels): K2's share of its roofline over the
traced window (``core.readers.k2_roofline``)."""

from bench.core.readers import k2_roofline as read  # noqa: F401

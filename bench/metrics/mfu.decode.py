"""``mfu.decode`` (device): the model's useful int8 operations over the
window's seconds and the card's 1,979 TOP/s (``core.readers.mfu``)."""

from bench.core.readers import mfu as read  # noqa: F401

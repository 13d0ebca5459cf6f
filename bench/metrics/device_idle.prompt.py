"""``device_idle.prompt`` (device): the share of the traced window in
which no kernel or copy runs, from the union of the device records
(``core.readers.device_idle``)."""

from bench.core.readers import device_idle as read  # noqa: F401

"""device_idle.colo: % of the traced window with no operation on the
device."""

from perfbench.metrics._common import device_idle as read  # noqa: F401

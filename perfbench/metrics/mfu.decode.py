"""mfu.decode: the whole step's share of the bf16 peak (%)."""

from perfbench.metrics._common import mfu as read  # noqa: F401

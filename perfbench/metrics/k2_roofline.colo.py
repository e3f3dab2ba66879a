"""k2_roofline.colo: K2's share of its roofline in the window (%)."""

from perfbench.metrics._common import k2_roofline as read  # noqa: F401

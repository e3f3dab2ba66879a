"""k1_roofline.decode: K1's share of its HBM bound in the window (%)."""

from perfbench.metrics._common import k1_roofline as read  # noqa: F401

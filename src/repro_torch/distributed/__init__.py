"""Fault tolerance of the port: checkpoints and straggler mitigation."""

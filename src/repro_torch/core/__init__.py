"""Harli control plane of the port: co-location, predictor, scheduler."""

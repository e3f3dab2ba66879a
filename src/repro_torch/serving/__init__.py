"""Serving engine of the port: requests, KV pages, continuous batching."""

"""Serving: pre/post-processing and the uint8 pipeline."""

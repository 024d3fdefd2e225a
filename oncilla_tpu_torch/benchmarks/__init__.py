"""Measurement entry points."""

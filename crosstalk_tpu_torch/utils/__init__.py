"""Tracing and debug switches."""

"""Tracing spans (copy of the reference's ``timed``/``span`` API)."""

"""Utility subpackage: logging and WAV I/O."""

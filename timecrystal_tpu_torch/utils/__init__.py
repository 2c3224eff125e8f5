"""Utilities: the parameter-file parser."""

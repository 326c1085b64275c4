"""Packed-dataset reading and collation (host side, numpy)."""

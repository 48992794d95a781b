"""Byte-exact .lrz container: magic header, chunk framing, token codec."""

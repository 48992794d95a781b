"""The port's archive pipeline, device literal path and host models."""

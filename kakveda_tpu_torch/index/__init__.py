"""The GFKB: failure + pattern store over the device index."""

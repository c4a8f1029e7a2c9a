"""The plain float64 GRAPE reference that decides ``correct``."""

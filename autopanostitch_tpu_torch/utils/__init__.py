"""Host-side utilities of the port (image loading and resizing)."""

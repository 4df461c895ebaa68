"""Host-side utilities: image output."""

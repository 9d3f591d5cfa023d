"""Host-side utilities (video input)."""

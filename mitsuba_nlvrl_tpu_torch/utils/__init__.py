"""Host-side image input and output (no device code)."""

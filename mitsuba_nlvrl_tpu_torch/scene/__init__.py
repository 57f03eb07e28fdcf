"""Scene description, SoA tables and the builder."""

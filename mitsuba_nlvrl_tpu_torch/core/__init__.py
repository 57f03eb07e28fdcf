"""Core math and record types of the port."""
